"""The port's RG-LRU block (recurrentgemma's temporal mixing) against the
JAX package, and the plain versions of the attention kernels at the
shapes recurrentgemma-2b brings (head dim 256 and 16, a GQA group of 10,
bf16 caches) against the JAX oracles.

Same inputs, made with numpy (or the reference's params, bridged),
through both; the JAX side runs op by op (``jax.disable_jit``).
Tolerances, each with its reason:

* ``associative_scan`` against ``jax.lax.associative_scan``: bitwise at
  every length (the same tree of elementwise f32 ops);
* ``_causal_conv1d``, with and without the decode history: bitwise (f32
  taps summed in order, one rounding to bf16);
* ``_rglru_coeffs``: torch's CPU exp, log1p and sigmoid round apart from
  XLA:CPU's (measured on 2e5 random inputs: exp 1 ulp on 9.7% of values,
  softplus up to 3 ulps, sigmoid up to 2). The decay a = exp(-8
  softplus(lam) r) then moves by up to about 1 + 6 |log a| ulps (14
  measured): held to ``A_RTOL``. The gated input's sqrt(1 - a^2) divides
  that by 1 - a^2 (a reaches 0.999), so it is held to ``A_RTOL`` times
  2 a^2 / (1 - a^2), element by element, plus ``A_RTOL``;
* the prefill's output, its ``state_q`` codes, scales and ``conv_buf``,
  and two decode steps: bitwise at these inputs (measured: the gates'
  ulps do not reach a bf16 output or an int8 code here);
* the decode kernels' plain versions at D 256 (G 10), D 16 and on bf16
  caches against the reference's ``ref.py`` oracles: within one bf16
  ulp, as ``test_torch_kvq_attn.py`` states (the f32 sums' order), with
  an absolute floor of S max|v| 2^-24 for outputs near zero (the f32
  accumulation's reorder gap over S terms); the gather bitwise;
* flash's plain version against the reference's Pallas kernel
  (interpret mode) within one bf16 ulp (rtol 2^-7, atol 1e-4), as
  ``test_torch_flash_attn.py`` holds it at D 64 and 128.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.kernels.flash_attn.ops import flash_attention
from repro.kernels.kvq_attn import ref as jkref
from repro.models import init_params as jinit
from repro.models import recurrent as JR
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import qat as tqat
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.kvq_attn import ops as kops
from repro_torch.models import recurrent as TR

ARCH = "recurrentgemma-2b"
POLICY = "A8d-C8-W4"
A_RTOL = 2.0 ** -17            # 64 f32 ulps of the decay a
KV_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bits(a):
    """The raw bits of a tensor / array (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_associative_scan_bitwise_with_jax(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (3, S, 5)).astype(np.float32)
    b = rng.standard_normal((3, S, 5)).astype(np.float32)
    with jax.disable_jit():
        ja, jb = jax.lax.associative_scan(
            _combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = TR.associative_scan(TR._lru_combine, (torch.from_numpy(a),
                                                   torch.from_numpy(b)),
                                 dim=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_associative_scan_on_another_axis_and_under_autograd():
    """The scan along dim 2 equals the sequential recurrence's values
    within f32 round-off, and autograd runs through it (the student)."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 3, 9)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 3, 9)).astype(np.float32))
    b.requires_grad_(True)
    _, h = TR.associative_scan(TR._lru_combine, (a, b), dim=2)
    seq, acc = [], torch.zeros(2, 3)
    for t in range(9):
        acc = a[..., t] * acc + b[..., t]
        seq.append(acc)
    torch.testing.assert_close(h, torch.stack(seq, -1), rtol=1e-6,
                               atol=1e-6)
    h.sum().backward()
    assert b.grad is not None and torch.isfinite(b.grad).all()


@pytest.fixture(scope="module")
def layer():
    """The reduced config's first RG-LRU layer, calibrated scales, in both
    packages."""
    cfg, tcfg = get_reduced_config(ARCH), t_reduced(ARCH)
    params = jqat.calibrate_weight_scales(jinit(cfg, jax.random.PRNGKey(0)),
                                          parse_policy(POLICY))
    jp = jax.tree.map(lambda x: x[0], params["segments"][0]["0"]["rglru"])
    tp = {k: (bridge.to_torch(np.asarray(v), "cpu") if not isinstance(v, dict)
              else {kk: bridge.to_torch(np.asarray(vv), "cpu")
                    for kk, vv in v.items()})
          for k, v in jp.items()}
    return cfg, tcfg, jp, tp


def _x(cfg, B, S, seed, width=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, width or cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jx, bridge.to_torch(np.asarray(jx), "cpu")


@pytest.mark.parametrize("with_buf", [False, True])
def test_causal_conv1d_bitwise(layer, with_buf):
    cfg, _, jp, tp = layer
    jx, tx = _x(cfg, 2, 11 if not with_buf else 1, 3,
                cfg.resolved_lru_width)
    jbuf = tbuf = None
    if with_buf:
        jbuf, tbuf = _x(cfg, 2, cfg.conv1d_width - 1, 4,
                        cfg.resolved_lru_width)
    with jax.disable_jit():
        want = JR._causal_conv1d(jx, jp["conv_w"], jp["conv_b"], buf=jbuf)
    got = TR._causal_conv1d(tx, tp["conv_w"], tp["conv_b"], buf=tbuf)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_rglru_coeffs_within_bounds(layer):
    cfg, tcfg, jp, tp = layer
    jx, tx = _x(cfg, 2, 13, 5, cfg.resolved_lru_width)
    with jax.disable_jit():
        ja, jg = JR._rglru_coeffs(cfg, jqat.make_ctx(POLICY), jp, jx, None)
    ta, tg = TR._rglru_coeffs(tcfg, tqat.make_ctx(POLICY), tp, tx, None)
    a, g = _f32(ja), _f32(jg)
    np.testing.assert_allclose(_f32(ta), a, rtol=A_RTOL, atol=0)
    amp = 2 * a * a / np.maximum(1 - a * a, 1e-12) + 1
    assert np.all(np.abs(_f32(tg) - g) <= A_RTOL * amp * np.abs(g) + 1e-30)


def test_rglru_prefill_and_decode_match(layer):
    """The prefill's output and cache (``state_q`` codes, ``s_state``,
    ``conv_buf``) and two decode steps after it: bitwise."""
    cfg, tcfg, jp, tp = layer
    jctx, tctx = jqat.make_ctx(POLICY), tqat.make_ctx(POLICY)
    jx, tx = _x(cfg, 3, 9, 6)
    with jax.disable_jit():
        jy, jc0 = JR.rglru_prefill(cfg, jctx, jp, jx)
        steps, jc = [], jc0
        for i in range(2):
            jx1, _ = _x(cfg, 3, 1, 10 + i)
            y1, jc = JR.rglru_decode(cfg, jctx, jp, jx1, jc)
            steps.append((y1, jc))
    ty, tc = TR.rglru_prefill(tcfg, tctx, tp, tx)
    np.testing.assert_array_equal(_bits(ty), _bits(jy))
    assert tc["state_q"].dtype == torch.int8
    for k in ("state_q", "s_state", "conv_buf"):
        np.testing.assert_array_equal(_bits(tc[k]), _bits(jc0[k]),
                                      err_msg=k)
    for i, (y1, jc) in enumerate(steps):
        _, tx1 = _x(cfg, 3, 1, 10 + i)
        ty1, tc = TR.rglru_decode(tcfg, tctx, tp, tx1, tc)
        np.testing.assert_array_equal(_bits(ty1), _bits(y1))
        for k in ("state_q", "s_state", "conv_buf"):
            np.testing.assert_array_equal(_bits(tc[k]), _bits(jc[k]),
                                          err_msg=f"step {i} {k}")


def test_rglru_fwd_matches_and_stats_collect(layer):
    """The training path under the static policy's calibration mode:
    the same output, and every site's statistic in the layer's layout."""
    cfg, tcfg, jp, tp = layer
    jctx = jqat.make_ctx("A8s-C8-W4", mode="calib")
    tctx = tqat.make_ctx("A8s-C8-W4", mode="calib")
    jx, tx = _x(cfg, 2, 10, 7)
    jcol, tcol = {}, {}
    with jax.disable_jit():
        jy = JR.rglru_fwd(cfg, jctx, jp, jx, jcol)
    ty = TR.rglru_fwd(tcfg, tctx, tp, tx, tcol)
    np.testing.assert_array_equal(_bits(ty), _bits(jy))
    flat_j = dict(bridge.flatten(jax.tree.map(np.asarray, jcol)))
    flat_t = dict(bridge.flatten(tcol))
    assert flat_t.keys() == flat_j.keys()
    assert set(flat_t) >= {"w_in/s_in", "w_gate/s_in", "w_ig/s_in",
                           "w_rg/s_in", "w_out/s_in", "s_state"}


# --------------------------------------------------------------------------
# the kernels' plain versions at recurrentgemma's shapes
# --------------------------------------------------------------------------

def _within_one_ulp(got, want, v, S):
    """One bf16 ulp, with the f32 reorder floor S max|v| 2^-24."""
    g, w = _f32(got), _f32(want)
    floor = S * float(np.max(np.abs(_f32(v)))) * 2.0 ** -24
    bound = KV_RTOL * np.maximum(np.abs(g), np.abs(w)) + floor
    assert np.all(np.abs(g - w) <= bound), float(np.max(np.abs(g - w)))


def _kv_case(B, H, Hkv, S, D, dtype, seed):
    rng = np.random.default_rng(seed)
    q = np.asarray(jnp.asarray(rng.standard_normal((B, H, D)) * 2,
                               jnp.bfloat16))
    if dtype == "int8":
        k = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
        s_k = (rng.random((B, Hkv, S)) * 0.02 + 1e-3).astype(np.float32)
        s_v = (rng.random((B, Hkv, S)) * 0.02 + 1e-3).astype(np.float32)
    else:                                  # C16: bf16 values, unit scales
        k = np.asarray(jnp.asarray(rng.standard_normal((B, Hkv, S, D)),
                                   jnp.bfloat16))
        v = np.asarray(jnp.asarray(rng.standard_normal((B, Hkv, S, D)),
                                   jnp.bfloat16))
        s_k = np.ones((B, Hkv, S), np.float32)
        s_v = np.ones((B, Hkv, S), np.float32)
    lengths = rng.integers(1, S + 1, (B,)).astype(np.int32)
    lengths[0] = S
    lengths[-1] = 0                              # an empty row
    return q, k, v, s_k, s_v, lengths


# (B, H, Hkv, S, D): recurrentgemma-2b's MQA heads (G 10, D 256) over a
# ring that crosses the kernel's 64-token splits; the reduced config's
# (G 4, D 16)
KV_SHAPES = [(3, 10, 1, 150, 256), (3, 4, 1, 70, 16)]


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("shape", KV_SHAPES, ids=["D256-G10", "D16-G4"])
def test_decode_plain_at_new_shapes_matches_jax(shape, dtype):
    args = _kv_case(*shape, dtype, sum(shape))
    targs = [bridge.to_torch(a, "cpu") for a in args]
    got = kops.kvq_decode_attn(*targs)
    assert got.shape == shape[:2] + shape[4:]
    want = jkref.kvq_decode_attn_ref(*[jnp.asarray(a) for a in args])
    v = targs[2].float() * targs[4][..., None]
    _within_one_ulp(got, want, v, shape[3])
    assert not got[-1].float().any()             # the empty row is zeros


def _paged(args, bs, seed):
    """The dense case's K/V scattered into a pool of ``bs``-token blocks
    through a shuffled table, plus the sink block (the port's layout)."""
    q, k, v, s_k, s_v, lengths = args
    B, Hkv, S = k.shape[:3]
    T = -(-S // bs)
    NB = B * T + 2
    perm = np.random.default_rng(seed).permutation(NB)[:B * T]
    tbl = perm.reshape(B, T).astype(np.int32)

    def pool(x):
        pad = [(0, 0)] * x.ndim
        pad[2] = (0, T * bs - S)
        xb = np.pad(x, pad).reshape((B, Hkv, T, bs) + x.shape[3:])
        xb = np.moveaxis(xb, 2, 1).reshape((B * T, Hkv, bs) + x.shape[3:])
        out = np.zeros((NB + 1, Hkv, bs) + x.shape[3:], x.dtype)
        out[tbl.reshape(-1)] = xb
        return out

    return q, pool(k), pool(v), pool(s_k), pool(s_v), tbl, lengths


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("shape", KV_SHAPES, ids=["D256-G10", "D16-G4"])
def test_paged_verify_and_gather_plain_at_new_shapes(shape, dtype):
    """Paged decode and the verify-wave (C 5 queries a slot) within one
    bf16 ulp of the reference's oracles on the same pool (its sink block
    dropped there), the gather bitwise."""
    args = _kv_case(*shape, dtype, 2 * sum(shape))
    q, kp, vp, skp, svp, tbl, lens = _paged(args, 16, 3)
    jpool = [jnp.asarray(a[:-1]) for a in (kp, vp, skp, svp)]
    tpool = [bridge.to_torch(a, "cpu") for a in (kp, vp, skp, svp)]
    tt, tl = torch.from_numpy(tbl), torch.from_numpy(lens)
    got = kops.kvq_paged_decode_attn(bridge.to_torch(q, "cpu"), *tpool, tt,
                                     tl)
    v = tpool[1].float() * tpool[3][..., None]
    S = tbl.shape[1] * 16
    _within_one_ulp(got, jkref.kvq_paged_decode_attn_ref(
        jnp.asarray(q), *jpool, jnp.asarray(tbl), jnp.asarray(lens)), v, S)
    B, H, D = q.shape
    C = 5
    rng = np.random.default_rng(4)
    qv = np.asarray(jnp.asarray(rng.standard_normal((B, C, H, D)),
                                jnp.bfloat16))
    lv = np.maximum(lens[:, None] - np.arange(C - 1, -1, -1)[None], 0
                    ).astype(np.int32)
    got = kops.kvq_spec_verify_attn(bridge.to_torch(qv, "cpu"), *tpool, tt,
                                    torch.from_numpy(lv))
    _within_one_ulp(got, jkref.kvq_spec_verify_attn_ref(
        jnp.asarray(qv), *jpool, jnp.asarray(tbl), jnp.asarray(lv)), v, S)
    g = kops.gather_dequant_paged_kv(tpool[0], tpool[2], tt)
    want = (np.asarray(jkref.gather_paged_kv(jpool[0], jnp.asarray(tbl))
                       .astype(jnp.float32))
            * np.asarray(jkref.gather_paged_kv(jpool[2],
                                               jnp.asarray(tbl)))[..., None])
    np.testing.assert_array_equal(g.numpy(), want)


# (B, S, H, Hkv, D, window): the QAT teacher's local layer at reduced
# length; a window shorter than S; the reduced config's D 16
FLASH_SHAPES = [(2, 40, 10, 1, 256, 2048), (1, 70, 10, 1, 256, 24),
                (2, 37, 4, 1, 16, 16)]


@pytest.mark.parametrize("dims", FLASH_SHAPES)
def test_flash_plain_at_new_shapes_matches_jax(dims):
    B, S, H, Hkv, D, window = dims
    rng = np.random.default_rng(sum(dims))
    arrs = [jnp.asarray(rng.standard_normal(s).astype(np.float32))
            .astype(jnp.bfloat16)
            for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    got = fa_ops.flash_attn_fwd(*[bridge.to_torch(np.asarray(a), "cpu")
                                  for a in arrs], causal=True, window=window)
    with jax.disable_jit():
        want = flash_attention(*arrs, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2.0 ** -7,
                               atol=1e-4)
