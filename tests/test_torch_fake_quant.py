"""Parity of the port's LSQ fake quantization (the plain versions of the
``fake_quant_fwd`` / ``fake_quant_bwd`` kernels behind the autograd
function) with the JAX package's ``lsq_fake_quant`` and its Pallas kernel
(``pallas_lsq_fake_quant``, interpret mode on the CPU).

Same inputs, made with numpy, through both. The JAX side runs op by op
(``jax.disable_jit``). Tolerances:

* the forward and ``dx`` are bitwise equal: one f32 division, clamp,
  round half to even and multiply per element, then one cast;
* ``ds`` sums ``g * dq/ds`` over every element that shares a scale, in
  another order than XLA's reduction. The error of an f32 sum in any
  order is bounded by a multiple of the terms' absolute mass, not of the
  sum, which can cancel: each ds is held within 1e-5 of
  ``gscale * sum |g * dq/ds|`` over its elements (n u for n up to a few
  thousand terms would be ~1e-4; observed ~1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import dynamic_fake_quant as jax_dynamic_fq
from repro.core.quantizer import lsq_fake_quant as jax_lsq
from repro.kernels.quant.ops import pallas_lsq_fake_quant
from repro_torch.bridge import to_torch
from repro_torch.core import qat as tqat
from repro_torch.core.precision import parse_policy
from repro_torch.core.quantizer import dynamic_fake_quant
from repro_torch.kernels.quant import ops as fq_ops
from repro_torch.kernels.quant.ops import lsq_fake_quant

DS_RTOL = 1e-5

# (x shape, scale shape): per tensor on an activation, per output channel
# on a weight (ragged against the Pallas kernel's (256, 512) tiles)
CASES = [((3, 17, 40), ()), ((96, 80), (1, 80)), ((130, 24), (1, 24))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(xshape, sshape, bits, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xshape).astype(np.float32)
    # scales near the absmax / qp that calibration gives, so some values
    # clip and most do not; a few exact half-steps test the rounding
    qp = 2 ** (bits - 1) - 1
    s = (np.abs(x).max() / qp * rng.uniform(0.5, 1.0, sshape)).astype(
        np.float32)
    x.reshape(-1)[:4] = (np.array([0.5, 1.5, -2.5, 3.5], np.float32)
                         * s.reshape(-1)[0])
    g = rng.standard_normal(xshape).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    return (jx, jnp.asarray(s), jg,
            to_torch(np.asarray(jx), "cpu"),
            torch.from_numpy(np.array(s, np.float32)),
            to_torch(np.asarray(jg), "cpu"))


def _jax_fwd_bwd(fn, jx, js, jg, bits):
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda a, b: fn(a, b, bits), jx, js)
        dx, ds = vjp(jg)
    return out, dx, ds


def _torch_fwd_bwd(tx, ts, tg, bits):
    tx = tx.clone().requires_grad_(True)
    ts = ts.clone().requires_grad_(True)
    out = lsq_fake_quant(tx, ts, bits)
    out.backward(tg)
    return out.detach(), tx.grad, ts.grad


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ds_mass(tx, ts, tg, bits):
    """gscale * sum |g * dq/ds| per scale: the f32 sums' error scale."""
    from repro_torch.core.quantizer import _reduce_to_shape, qbounds
    qn, qp = qbounds(bits)
    v = tx.detach().float() / torch.clamp_min(ts.float(), 1e-9)
    within = (v >= qn) & (v <= qp)
    dq = torch.where(within, torch.round(v) - v, torch.clamp(v, qn, qp))
    mass = _reduce_to_shape((tg.float() * dq).abs(), tuple(ts.shape))
    return _np(mass) * fq_ops.grad_scale(tx, ts, bits)


def _assert_ds(got, want, mass):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= DS_RTOL * np.abs(mass)), (
        np.max(np.abs(got - want) / np.abs(mass)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("xshape,sshape", CASES)
def test_lsq_matches_reference(xshape, sshape, bits, dtype):
    jx, js, jg, tx, ts, tg = _inputs(xshape, sshape, bits, dtype)
    jout, jdx, jds = _jax_fwd_bwd(jax_lsq, jx, js, jg, bits)
    out, dx, ds = _torch_fwd_bwd(tx, ts, tg, bits)
    assert out.dtype == tx.dtype and dx.dtype == tx.dtype
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_array_equal(_np(dx), _np(jdx))
    _assert_ds(ds, jds, _ds_mass(tx, ts, tg, bits))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("xshape,sshape", CASES)
def test_lsq_matches_pallas_kernel(xshape, sshape, bits):
    """The TPU kernel run in interpret mode: padded to its tiles, partial
    sums per row tile; the same forward and dx bits, ds to order."""
    jx, js, jg, tx, ts, tg = _inputs(xshape, sshape, bits, "bfloat16", 1)
    jout, jdx, jds = _jax_fwd_bwd(pallas_lsq_fake_quant, jx, js, jg, bits)
    out, dx, ds = _torch_fwd_bwd(tx, ts, tg, bits)
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_array_equal(_np(dx), _np(jdx))
    _assert_ds(ds, jds, _ds_mass(tx, ts, tg, bits))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_head_view_quantizes_per_row(dtype, monkeypatch):
    """The tied head quantizes ``embed.w.T`` per vocab entry: the port
    quantizes the stored (vocab, d) table per row and transposes back.
    Values, d(embed.w) and ds equal the reference's on the transposed
    view, and the gradient reaches the backward in the table's own
    contiguous layout through the head's matmul (what the CUDA kernel
    needs: it never copies)."""
    V, d, bits = 160, 48, 8
    jx, js, jg, tx, ts, tg = _inputs((V, d), (V, 1), bits, dtype, 2)
    js = js.reshape(1, V)
    rng = np.random.default_rng(3)
    xin = rng.standard_normal((2, 5, d)).astype(np.float32)
    jdt = jx.dtype
    jxin = jnp.asarray(xin).astype(jdt)

    def jhead(w, s):
        return jnp.einsum("...i,io->...o", jxin,
                          jax_lsq(w.T, s, bits)).astype(jnp.float32)

    with jax.disable_jit():
        jy, vjp = jax.vjp(jhead, jx, js)
        gy = jnp.asarray(rng.standard_normal(jy.shape).astype(np.float32))
        jdw, jds = vjp(gy)
        jq = jax_lsq(jx.T, js, bits)

    seen, args = [], []
    real_bwd = fq_ops.fake_quant_bwd

    def spy(x, s, g, b, plain=False):
        seen.append((tuple(x.shape), g.is_contiguous(), tuple(s.shape)))
        args.append((x, s, g))
        return real_bwd(x, s, g, b, plain=plain)

    monkeypatch.setattr(fq_ops, "fake_quant_bwd", spy)
    ew = tx.clone().requires_grad_(True)
    s_w = torch.from_numpy(np.asarray(js).copy()).requires_grad_(True)
    ctx = tqat.make_ctx(parse_policy("A8d-C8-W4"))
    wq = tqat.quantize_weight_p(ctx, {"w": ew.T, "s_w": s_w}, bits=bits)
    assert tuple(wq.shape) == (d, V)
    np.testing.assert_array_equal(_np(wq), _np(jq))
    y = torch.matmul(to_torch(np.asarray(jxin), "cpu"), wq).float()
    y.backward(torch.from_numpy(np.asarray(gy)))
    assert seen == [((V, d), True, (V, 1))]
    assert s_w.grad.shape == (1, V)
    # d(embed.w) is the matmul's gradient masked: its f32 sums round to
    # the weight's type the same way in both (bitwise in f32; bf16 here
    # rounds a CPU bf16 GEMM's output, so one ulp apart at most)
    if dtype == "float32":
        np.testing.assert_allclose(_np(ew.grad), _np(jdw), rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(_np(ew.grad), _np(jdw), rtol=2 ** -7,
                                   atol=1e-6)
    _assert_ds(s_w.grad, jds, _ds_mass(*args[0], bits).reshape(1, V))


def test_direct_row_mode_equals_reference_transposed():
    """The per-row mode on its own: dx bitwise, ds to order."""
    V, d, bits = 64, 32, 8
    jx, js, jg, tx, ts, tg = _inputs((V, d), (V, 1), bits, "bfloat16", 4)
    jout, jdx, jds = _jax_fwd_bwd(
        lambda a, b, n: jax_lsq(a.T, b.reshape(1, -1), n).T, jx, js, jg,
        bits)
    out, dx, ds = _torch_fwd_bwd(tx, ts, tg, bits)
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_array_equal(_np(dx), _np(jdx))
    _assert_ds(ds, jds, _ds_mass(tx, ts, tg, bits))


def test_grad_scale_is_the_reference_f32():
    x = torch.zeros((11008, 2048))
    assert fq_ops.grad_scale(x, torch.zeros((1, 2048)), 4) == float(
        1.0 / jnp.sqrt(jnp.float32(11008 * 7)))
    assert fq_ops.grad_scale(x, torch.zeros(()), 8) == float(
        1.0 / jnp.sqrt(jnp.float32(11008 * 2048 * 127)))


@pytest.mark.parametrize("bits", [8, 16])
def test_dynamic_fake_quant_ste_gradient(bits):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3
    g = rng.standard_normal((3, 7, 32)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jg = jnp.asarray(g).astype(jnp.bfloat16)
    with jax.disable_jit():
        jout, vjp = jax.vjp(lambda a: jax_dynamic_fq(a, bits), jx)
        (jdx,) = vjp(jg)
    tx = to_torch(np.asarray(jx), "cpu").requires_grad_(True)
    out = dynamic_fake_quant(tx, bits)
    out.backward(to_torch(np.asarray(jg), "cpu"))
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_array_equal(_np(tx.grad), _np(jdx))
    # without a gradient the plain form gives the same bits
    with torch.no_grad():
        np.testing.assert_array_equal(
            _np(dynamic_fake_quant(tx.detach(), bits)), _np(jout))


def test_plain_flag_and_cpu_never_launch(monkeypatch):
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("a CPU run tried to build or load a kernel")

    monkeypatch.setattr(build, "load", refuse)
    before = (fq_ops.fake_quant_fwd.launches, fq_ops.fake_quant_bwd.launches)
    _, _, _, tx, ts, tg = _inputs((8, 16), (1, 16), 4, "bfloat16", 6)
    a = _torch_fwd_bwd(tx, ts, tg, 4)
    x2 = tx.clone().requires_grad_(True)
    s2 = ts.clone().requires_grad_(True)
    out = lsq_fake_quant(x2, s2, 4, plain=True)
    out.backward(tg)
    for u, w in zip(a, (out.detach(), x2.grad, s2.grad)):
        assert torch.equal(u, w)
    assert (fq_ops.fake_quant_fwd.launches,
            fq_ops.fake_quant_bwd.launches) == before == (0, 0)


def test_scale_layouts_are_recognised():
    x = torch.zeros((6, 4))
    assert fq_ops.scale_mode(x, torch.zeros(())) == 0
    assert fq_ops.scale_mode(x, torch.zeros((1, 4))) == 1
    assert fq_ops.scale_mode(x, torch.zeros((6, 1))) == 2
    with pytest.raises(ValueError):
        fq_ops.scale_mode(x, torch.zeros((3,)))
