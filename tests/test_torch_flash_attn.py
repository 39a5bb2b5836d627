"""Parity of the port's flash-attention forward (the plain version of the
``flash_attn_fwd`` kernel) with the JAX package's oracle
(``flash_attn_ref``) and its Pallas kernel (``flash_attention``, interpret
mode on the CPU), at small ragged, causal, windowed and GQA shapes.

Same bf16 inputs, made with numpy, through both. Tolerances, each with
its reason:

* against the Pallas kernel, within one bf16 ulp (rtol 2^-7, atol 1e-4):
  the same math (q pre-scaled in f32, f32 scores, -1e30 masking, bf16
  P for P.V, ``acc / max(l, 1e-20)``); only the f32 sums' order and the
  kernel's online softmax over its 512-key tiles differ, which moves
  the bf16 output by at most one ulp;
* against the oracle, within two bf16 ulps (rtol 2^-6, atol 2e-3): the
  oracle divides the scores by sqrt(D) after the product and multiplies
  f32 probabilities into V, where the kernel rounds P to bf16 (relative
  2^-9 per probability);
* against the port's own ``blockwise_attention`` (the autograd path),
  bitwise for sequences within one 1024-token chunk: the same ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ops import flash_attention
from repro.kernels.flash_attn.ref import flash_attn_ref as jax_flash_ref
from repro_torch.bridge import to_torch
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.models.common import blockwise_attention

ULP = (2.0 ** -7, 1e-4)
ORACLE = (2.0 ** -6, 2e-3)

# (B, S, H, Hkv, D, causal, window)
SHAPES = [
    (2, 37, 4, 2, 64, True, 0),       # GQA causal, ragged
    (1, 300, 4, 1, 128, True, 0),     # MQA, beyond one 256-row tile
    (1, 130, 4, 2, 64, True, 48),     # sliding window
    (2, 96, 2, 2, 64, False, 0),      # bidirectional MHA
    (1, 520, 2, 1, 64, True, 0),      # beyond one 512-key tile
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal(shape).astype(np.float32))
            .astype(jnp.bfloat16) for shape in
            ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    return arrs, [to_torch(np.asarray(a), "cpu") for a in arrs]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dims", SHAPES)
def test_plain_matches_pallas_kernel_and_oracle(dims):
    B, S, H, Hkv, D, causal, window = dims
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, Hkv, D, sum(dims[:5]))
    with jax.disable_jit():
        want_k = flash_attention(jq, jk, jv, causal=causal, window=window)
        want_o = jax_flash_ref(jq, jk, jv, causal=causal, window=window)
    got = fa_ops.flash_attn_fwd(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(_np(got), _np(want_k), rtol=ULP[0],
                               atol=ULP[1])
    np.testing.assert_allclose(_np(got), _np(want_o), rtol=ORACLE[0],
                               atol=ORACLE[1])


@pytest.mark.parametrize("dims", SHAPES)
def test_plain_equals_blockwise_within_one_chunk(dims):
    B, S, H, Hkv, D, causal, window = dims
    _, (q, k, v) = _inputs(B, S, H, Hkv, D, 7)
    got = fa_ops.flash_attn_fwd(q, k, v, causal=causal, window=window)
    want = blockwise_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, want)


def test_cpu_never_launches(monkeypatch):
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("a CPU run tried to build or load a kernel")

    monkeypatch.setattr(build, "load", refuse)
    _, (q, k, v) = _inputs(1, 16, 2, 1, 64, 3)
    before = fa_ops.flash_attn_fwd.launches
    fa_ops.flash_attn_fwd(q, k, v)
    fa_ops.flash_attn_fwd(q, k, v, plain=True)
    assert fa_ops.flash_attn_fwd.launches == before == 0


def test_attn_fwd_picks_by_grad_mode(monkeypatch):
    """``attn_fwd``: without a gradient the flash path, under autograd the
    blockwise one; both give the same bits on the CPU at this size."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.qat import make_ctx
    from repro_torch.models import blocks, init_params
    from repro_torch.models.common import rope_tables
    cfg = get_reduced_config("qwen2.5-3b")
    p = init_params(cfg, seed=2, device="cpu")["layers"][0]["attn"]
    ctx = make_ctx("A8d-C8-W4")
    x = torch.randn(2, 24, cfg.d_model).to(torch.bfloat16)
    rope = rope_tables(torch.arange(24), cfg.resolved_head_dim,
                       cfg.rope_theta)
    calls = []
    real = fa_ops.flash_attn_fwd

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(fa_ops, "flash_attn_fwd", spy)
    with torch.no_grad():
        a = blocks.attn_fwd(cfg, ctx, p, x, rope)
    assert len(calls) == 1 and calls[0]["causal"] is True
    b = blocks.attn_fwd(cfg, ctx, p, x, rope)
    assert len(calls) == 1
    assert torch.equal(a, b.detach())
