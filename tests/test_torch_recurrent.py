"""Parity of the port's recurrent blocks (``models/recurrent.py``: mLSTM
and sLSTM) with the JAX package's, at the reduced xlstm-125m config.

Same params (the reference's, calibrated, bridged), same inputs (a numpy
generator) through both; the JAX side runs op by op (``jax.disable_jit``).
Tolerances, each with its reason:

* mLSTM prefill: the output within ``MLSTM_Y_RTOL`` relative L2
  (measured up to 7.0e-3 at S 7 and 4.9e-4 at S 300 under A8d-C8-W4, over
  four inputs each; often bitwise): the einsums sum in another order than
  XLA's dot, and a moved f32 ulp can flip a per-token int8 code of
  ``w_down``'s input. The log-forget cumsum follows XLA:CPU's order
  bitwise (``recurrent._xla_cumsum``), and chunks (``MLSTM_CHUNK``,
  patched on both sides to 16) change nothing. The cached state's scales
  are bitwise and its int8 codes move by at most one on at most
  ``CODE_FLIP_SHARE`` of them (measured 12 of 12672, at S 7); stored in
  bf16 (C16) within ``STATE16_RTOL`` (measured 3.2e-5).
* mLSTM decode from the reference's cache: output and int8 codes bitwise
  (measured: always), bf16 state within ``STATE16_RTOL``.
* sLSTM through the per-step cell (what every forward under autograd,
  calibration and serving runs): under A8d-C8-W4 output and h codes
  bitwise; under A16-C16-W16 the unquantized bf16 h carry rounds some
  elements apart and carries them on: output, h and c within
  ``SLSTM16_RTOL`` (measured up to 1.7e-3 at S 40 and 2.4e-3 at S 300);
  otherwise ``c`` (f32)
  within a few f32 ulps (``C_TOL``; measured 1.8e-7 absolute): the
  sigmoid and tanh of torch and XLA:CPU round some values an ulp apart.
  One decode step from the reference's cache is bitwise.
* the teacher route (quantization off and no gradient: the plain
  ``slstm_scan`` with ``carry="gx"``, the reference's cell: h carried in
  bf16) against the reference's cell: within ``TEACHER_BF16_RTOL``
  (measured at S 64: the output and hT bitwise, cT 7.4e-8, where torch's
  and XLA:CPU's sigmoid and tanh round some f32 values an ulp apart; it
  was 4.2e-3, 2.2e-3 and 1.3e-3 while the scan carried h in f32) with
  bf16 params, hT in bf16 as the reference returns it; with f32 params
  both carry f32 and agree to f32 rounding (``TEACHER_F32_RTOL``;
  measured 2.8e-7).
* the student's sLSTM fake-quantizes ``r_h`` once per forward rather
  than once per step: the same loss bitwise, and r_h's gradients from one
  backward over the summed upstream gradient instead of T. The weight's
  gradient is the same bf16 sum (within ``HOIST_W_RTOL``; measured:
  bitwise). Its f32 scale's gradient now sums the column once over the
  upstream gradient accumulated in bf16 (the fake-quantized weight's
  dtype), where per step it summed each step's bf16 gradient in f32:
  within ``HOIST_S_RTOL`` (measured 5.7e-3; one bf16 ulp is 3.9e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import init_params as jinit
from repro.models import recurrent as JR
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import qat as tqat
from repro_torch.kernels.slstm_scan import ops as scan_ops
from repro_torch.models import recurrent as TR

POLICIES = ["A8d-C8-W4", "A16-C16-W16"]
MLSTM_Y_RTOL = 2e-2
CODE_FLIP_SHARE = 2e-3
STATE16_RTOL = 2e-4
SLSTM16_RTOL = 1e-2
C_TOL = dict(rtol=4e-7, atol=3e-7)
TEACHER_BF16_RTOL = 1.5e-7
TEACHER_F32_RTOL = 2e-6
HOIST_W_RTOL = 2e-2
HOIST_S_RTOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(params):
    """(mLSTM cell, sLSTM cell) of layer 0 and 1, reference and port."""
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    seg = params["segments"][0]
    return ([jax.tree.map(lambda a: a[0], seg[j]["cell"]) for j in "01"],
            [tp["layers"][j]["cell"] for j in (0, 1)])


@pytest.fixture(scope="module")
def cells():
    cfg = get_reduced_config("xlstm-125m")
    out = {}
    for pol in POLICIES:
        params = jqat.calibrate_weight_scales(
            jinit(cfg, jax.random.PRNGKey(0)), parse_policy(pol))
        out[pol] = _cells(params)
    return cfg, t_reduced("xlstm-125m"), out


def _x(S, seed=0, dtype="bf16"):
    x = np.random.default_rng(seed).standard_normal((3, S, 64)).astype(
        np.float32)
    if dtype == "bf16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _state_close(got, want, flip_share):
    """int8 codes: at most ``flip_share`` of them one apart; bf16 (C16)
    storage: within ``STATE16_RTOL``."""
    if got.dtype == torch.int8:
        d = got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32)
        assert np.abs(d).max() <= 1
        assert np.count_nonzero(d) <= flip_share * d.size
    else:
        assert _rel(got, want) <= STATE16_RTOL


def _port_cache(jcache):
    return {k: bridge.to_torch(np.asarray(v), "cpu")
            for k, v in jcache.items()}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("S,chunk", [(7, 256), (40, 256), (40, 16),
                                     (300, 256)])
def test_mlstm_prefill_and_decode_match_op_by_op_reference(
        cells, policy, S, chunk, monkeypatch):
    cfg, tcfg, by_policy = cells
    (jm, _), (tm, _) = by_policy[policy]
    monkeypatch.setattr(JR, "MLSTM_CHUNK", chunk)
    monkeypatch.setattr(TR, "MLSTM_CHUNK", chunk)
    jctx, tctx = jqat.make_ctx(policy), tqat.make_ctx(policy)
    jx, tx = _x(S, seed=S)
    with jax.disable_jit():
        jy, jc = JR.mlstm_prefill(cfg, jctx, jm, jx)
        jdy, jdc = JR.mlstm_decode(cfg, jctx, jm, jx[:, :1], jc)
    with torch.no_grad():
        ty, tc = TR.mlstm_prefill(tcfg, tctx, tm, tx)
        tdy, tdc = TR.mlstm_decode(tcfg, tctx, tm, tx[:, :1],
                                   _port_cache(jc))
    assert _rel(ty, jy) <= MLSTM_Y_RTOL
    np.testing.assert_array_equal(_f32(tc["s_state"]), _f32(jc["s_state"]))
    _state_close(tc["state_q"], jc["state_q"], CODE_FLIP_SHARE)
    np.testing.assert_array_equal(_f32(tdy), _f32(jdy))
    np.testing.assert_array_equal(_f32(tdc["s_state"]), _f32(jdc["s_state"]))
    _state_close(tdc["state_q"], jdc["state_q"], 0.0)
    assert tdc["state_q"].shape == (3, 4, 32, 33)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("S", [7, 40])
def test_slstm_cell_prefill_and_decode_match_op_by_op_reference(
        cells, policy, S):
    """The per-step cell route (taken under autograd), then one decode
    step from the reference's cache."""
    cfg, tcfg, by_policy = cells
    (_, js), (_, ts) = by_policy[policy]
    jctx, tctx = jqat.make_ctx(policy), tqat.make_ctx(policy)
    jx, tx = _x(S, seed=S + 1)
    with jax.disable_jit():
        jy, jc = JR.slstm_prefill(cfg, jctx, js, jx)
        jdy, jdc = JR.slstm_decode(cfg, jctx, js, jx[:, :1], jc)
    with torch.enable_grad():
        ty, tc = TR.slstm_prefill(tcfg, tctx, ts, tx)
    with torch.no_grad():
        tdy, tdc = TR.slstm_decode(tcfg, tctx, ts, tx[:, :1],
                                   _port_cache(jc))
    if policy == "A8d-C8-W4":
        np.testing.assert_array_equal(_f32(ty), _f32(jy))
        np.testing.assert_array_equal(_f32(tc["state_q"]),
                                      _f32(jc["state_q"]))
        np.testing.assert_allclose(_f32(tc["c"]), _f32(jc["c"]), **C_TOL)
    else:
        for k in ("state_q", "c"):
            assert _rel(tc[k], jc[k]) <= SLSTM16_RTOL, k
        assert _rel(ty, jy) <= SLSTM16_RTOL
    np.testing.assert_array_equal(_f32(tc["s_state"]), _f32(jc["s_state"]))
    np.testing.assert_array_equal(_f32(tdy), _f32(jdy))
    for k in ("state_q", "s_state"):
        np.testing.assert_array_equal(_f32(tdc[k]), _f32(jdc[k]), err_msg=k)
    np.testing.assert_allclose(_f32(tdc["c"]), _f32(jdc["c"]), **C_TOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_teacher_route_runs_the_scan(dtype, monkeypatch):
    """Quantization off and no gradient: ``slstm_fwd`` runs ``slstm_scan``
    (its plain version here), against the reference's bf16-carry cell.
    Under autograd the same call runs the cell and not the scan."""
    cfg = get_reduced_config("xlstm-125m")
    params = jinit(cfg, jax.random.PRNGKey(0),
                   dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    (_, js), (_, ts) = _cells(params)
    tcfg = t_reduced("xlstm-125m")
    calls = []
    real = scan_ops.slstm_scan
    monkeypatch.setattr(scan_ops, "slstm_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jctx = jqat.make_ctx("A16-C16-W16", mode="off")
    tctx = tqat.make_ctx("A16-C16-W16", mode="off")
    jx, tx = _x(64, seed=1, dtype=dtype)
    with jax.disable_jit():
        jy, (jh, jc) = JR.slstm_fwd(cfg, jctx, js, jx, return_state=True)
    with torch.no_grad():
        ty, (th, tc) = TR.slstm_fwd(tcfg, tctx, ts, tx, return_state=True)
    assert calls == [1]
    tol = TEACHER_BF16_RTOL if dtype == "bf16" else TEACHER_F32_RTOL
    for got, want, name in ((ty, jy, "y"), (th, jh, "hT"), (tc, jc, "cT")):
        assert _rel(got, want) <= tol, (name, _rel(got, want))
    assert th.dtype == tx.dtype and tc.dtype == torch.float32
    with torch.enable_grad():
        ty2 = TR.slstm_fwd(tcfg, tctx, ts, tx)
    assert calls == [1]
    if dtype == "f32":
        assert _rel(ty2, jy) <= TEACHER_F32_RTOL


def test_student_fake_quantizes_r_h_once_per_forward(cells, monkeypatch):
    """The student's sLSTM fake-quantizes r_h once, not once per step: the
    same loss bitwise as the per-step qlinear, and r_h's gradients within
    f32 summation order of it."""
    cfg, tcfg, by_policy = cells
    _, (_, ts) = by_policy["A8d-C8-W4"]
    ctx = tqat.make_ctx("A8d-C8-W4")
    _, tx = _x(24, seed=4)
    n_quant = []
    real_q = TR.quantize_weight_p
    monkeypatch.setattr(TR, "quantize_weight_p",
                        lambda *a, **k: n_quant.append(1) or real_q(*a, **k))

    def run(per_step):
        p = {k: ({kk: vv.detach().clone().requires_grad_(True)
                  for kk, vv in v.items()} if isinstance(v, dict) else
                 v.detach().clone().requires_grad_(True))
             for k, v in ts.items()}
        if per_step:
            monkeypatch.setattr(TR, "_recurrent_linear",
                                lambda c, pp: lambda h: tqat.qlinear(c, h,
                                                                     pp))
        y = TR.slstm_fwd(tcfg, ctx, p, tx)
        loss = (y.float() ** 2).mean()
        loss.backward()
        return loss.detach(), p["r_h"]["w"].grad, p["r_h"]["s_w"].grad

    hoisted = run(False)
    assert len(n_quant) == 1
    per_step = run(True)
    assert torch.equal(hoisted[0], per_step[0])
    assert _rel(hoisted[1], per_step[1]) <= HOIST_W_RTOL
    assert _rel(hoisted[2], per_step[2]) <= HOIST_S_RTOL
