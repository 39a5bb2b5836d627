"""Parity of the port's int8-cache decode attention (plain versions, CPU)
with the JAX package: its Pallas kernel in interpret mode, its
``kvq_decode_attn_ref`` and the serving path's ``decode_attention_intcache``.

Tolerance: one bf16 ulp of the output (|d| <= 2**-7 * |v|, plus 2**-24
absolute for outputs near zero). Both sides compute in f32 and round the
result to bf16 once; only the f32 summation order differs, and the
online softmax of the Pallas kernel (512-token tiles) reorders it further.
Measured at these shapes: the port matches the JAX reference and
``decode_attention_intcache`` bitwise, and the interpret-mode kernel to
within 3.9e-6 on outputs of magnitude up to 1.8 (a few elements in ten
thousand differ at all).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kvq_attn.ops import kvq_decode_attn as jax_kvq_decode_attn
from repro.kernels.kvq_attn.ref import kvq_decode_attn_ref as jax_ref
from repro.models.common import decode_attention_intcache as jax_intcache
from repro_torch.bridge import to_torch
from repro_torch.kernels.kvq_attn.ops import kvq_decode_attn
from repro_torch.kernels.kvq_attn.ref import kvq_decode_attn_ref
from repro_torch.models.common import decode_attention_intcache


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    q = np.array(jnp.asarray(rng.standard_normal((B, H, D)) * 2,
                             jnp.bfloat16))
    k = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
    s_k = (rng.random((B, Hkv, S)) * 0.02 + 1e-3).astype(np.float32)
    s_v = (rng.random((B, Hkv, S)) * 0.02 + 1e-3).astype(np.float32)
    lengths = rng.integers(1, S + 1, (B,)).astype(np.int32)
    lengths[0] = S                                  # a full row
    lengths[-1] = 1                                 # a one-token row
    return q, k, v, s_k, s_v, lengths


def _within_one_ulp(a, b):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = np.asarray(b)
    bound = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b)) + 2.0 ** -24
    assert np.all(np.abs(a - b) <= bound), float(np.max(np.abs(a - b)))
    assert np.mean(a != b) <= 0.01


# GQA 4:1 with S under one TPU tile; MHA with S across two ragged tiles;
# the full-width head geometry (16 q heads on 2 KV heads, D=128)
SHAPES = [(3, 8, 2, 300, 16), (2, 4, 4, 600, 32), (4, 16, 2, 256, 128)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_kernel_version_matches_jax(shape):
    args = _case(*shape, sum(shape))
    got = kvq_decode_attn(*[to_torch(a, "cpu") for a in args])
    assert got.dtype == torch.bfloat16 and got.shape == shape[:2] + shape[4:]
    got = got.float().numpy()
    jargs = [jnp.asarray(a) for a in args]
    _within_one_ulp(jax_kvq_decode_attn(*jargs, use_pallas=True), got)
    _within_one_ulp(jax_ref(*jargs), got)


@pytest.mark.parametrize("shape", SHAPES)
def test_intcache_path_matches_jax(shape):
    args = _case(*shape, 3 * sum(shape))
    targs = [to_torch(a, "cpu") for a in args]
    got = decode_attention_intcache(*targs).float().numpy()
    _within_one_ulp(jax_intcache(*[jnp.asarray(a) for a in args]), got)
    # the two plain orders (scales folded into scores vs dequantized K/V)
    _within_one_ulp(kvq_decode_attn_ref(*targs).float().numpy(), got)


def test_empty_row_returns_zeros():
    args = list(_case(2, 4, 2, 40, 16, 1))
    args[5] = np.array([0, 7], np.int32)
    got = kvq_decode_attn(*[to_torch(a, "cpu") for a in args])
    assert torch.all(got[0] == 0)
    _within_one_ulp(jax_ref(*[jnp.asarray(a) for a in args]),
                    got.float().numpy())


def test_non_cpu_non_cuda_tensor_raises():
    meta = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,  # noqa: E731
                                                    device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kvq_decode_attn(meta(1, 2, 16, dt=torch.bfloat16),
                        meta(1, 1, 8, 16, dt=torch.int8),
                        meta(1, 1, 8, 16, dt=torch.int8), meta(1, 1, 8),
                        meta(1, 1, 8), meta(1, dt=torch.int32))
    assert kvq_decode_attn.launches == 0
