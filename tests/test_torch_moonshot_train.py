"""The port's moonshot slice (moonshot-v1-16b-a3b) in training and PTQ
against the JAX package, as ``test_torch_mixtral_train.py`` holds
mixtral's: one QAT step (the load-balance aux in the loss; the router
and the 8-expert banks' gradients), the train CLI on the CPU, weight
calibration of the banks, RTN and SmoothQuant on the MoE tree, the
residual rotation and its report, and the bridge and checkpointer on the
``moe`` leaves ((L, 8, d_in, d_out) banks). Serving and the MoE block at
top 6: ``test_torch_moonshot.py``.

Same params (the reference's, bridged), same batches (the same numpy
generator) through both, the reduced config (2 layers, d 64, 4 heads on
4, head dim 16, 8 experts, top 2, d_ff 64); the JAX side runs op by
op (``jax.disable_jit``).
Tolerances, each with its reason:

* the teacher's logits (quantization off, no gradient) within
  ``TEACHER_RTOL``: a bf16 GEMM whose f32 accumulator lands near a bf16
  tie rounds one ulp apart in XLA's dot and torch's GEMM (ROADMAP, Queue
  3 properties), and a moved router logit can move a token to another
  expert;
* with the reference's teacher logits shared, the student's loss (KD plus
  ``MOE_AUX_COEF`` times the aux) within ``LOSS_RTOL`` and every
  gradient leaf, the router's and the banks' included, within
  ``GRAD_RTOL * |g_leaf| + GRAD_ATOL_GLOBAL * |g|``, the bounds of
  ``test_torch_xlstm_train.py`` (GEMMs and reductions accumulate in
  another order);
* the whole step, each package with its own teacher: the loss within
  ``STEP_LOSS_RTOL`` (the teacher's gap above moves the KD target);
* ``rtn_quantize``: the banks' ``s_w`` within the MSE calibration's 1e-3
  relative (``tests/test_torch_calibration.py``), every other leaf
  bitwise; SmoothQuant's fold from the same maxima, the bridge and the
  checkpoint round trip: bitwise;
* ``rotate_residual`` given the reference's R: every weight within one
  bf16 ulp (an f32 product rounded to bf16), ``rotation_report`` within
  1e-10 (f64 SVDs summed in other orders), as
  ``test_torch_ptq_rotation.py`` holds them.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import distill as jdistill
from repro.core import qat as jqat
from repro.core.analysis import rotation as jrot
from repro.core.precision import parse_policy
from repro.core.ptq import rtn as jrtn
from repro.core.ptq import smoothquant as jsq
from repro.data import MixtureIterator as JMixture
from repro.data import SyntheticConfig as JSynth
from repro.data import calibration_batches as jcalib_batches
from repro.launch.steps import MOE_AUX_COEF as J_MOE_AUX_COEF
from repro.launch.train import calibrate as jcalibrate
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import distill as tdistill
from repro_torch.core import qat as tqat
from repro_torch.core.analysis import rotation as trot
from repro_torch.core.precision import parse_policy as t_parse_policy
from repro_torch.core.ptq import rtn as trtn
from repro_torch.core.ptq import smoothquant as tsq
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import main as train_main
from repro_torch.models import forward, init_params
from repro_torch.tree import tree_map

ARCH = "moonshot-v1-16b-a3b"
POLICY = "A8d-C8-W4"
TEACHER_RTOL = 1e-2
LOSS_RTOL = 1e-6
STEP_LOSS_RTOL = 1e-3
GRAD_RTOL, GRAD_ATOL_GLOBAL = 2e-2, 1e-6
MSE_RTOL = 1e-3
BF16_ULP = 2.0 ** -8
REPORT_ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _flat(params):
    return {k: v.detach() for k, v in bridge.flatten(params)}


def _cfgs():
    return get_reduced_config(ARCH), t_reduced(ARCH)


@pytest.fixture(scope="module")
def tree():
    cfg, tcfg = _cfgs()
    return cfg, tcfg, jinit(cfg, jax.random.PRNGKey(1))


# --------------------------------------------------------------------------
# QAT
# --------------------------------------------------------------------------

def _flat_ref(tree):
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in bridge.flatten(jax.tree.map(np.asarray, tree))}


def _flat_port(params):
    return {k: np.asarray(v, np.float32) for k, v in bridge.flatten(
        bridge.params_to_numpy(params))}


def _grads_close(tg, jg, student):
    tg = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g, tg,
                  student)
    gw, gt = _flat_ref(jg), _flat_port(tg)
    assert gw.keys() == gt.keys()
    for k in ("moe/router/w", "moe/wg/w", "moe/wd/s_w"):
        key = f"segments/0/0/{k}"
        assert key in gw and np.any(gw[key]), key
    total = np.sqrt(sum(np.sum(v ** 2) for v in gw.values()))
    for k in gw:
        err = np.linalg.norm(gt[k] - gw[k])
        assert err <= GRAD_RTOL * np.linalg.norm(gw[k]) + \
            GRAD_ATOL_GLOBAL * total, (k, err, np.linalg.norm(gw[k]))


def test_aux_coefficient_is_the_reference_s():
    assert tsteps.MOE_AUX_COEF == J_MOE_AUX_COEF


def test_qat_step_matches_op_by_op_reference():
    cfg, tcfg = _cfgs()
    B, S = 2, 24
    teacher = jinit(cfg, jax.random.PRNGKey(0))
    data = JSynth(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                  seed=0)
    jt = JTrainConfig(precision=POLICY, total_steps=3, ref_steps=3,
                      batch_size=B, seq_len=S)
    student = jcalibrate(cfg, teacher, jt, data)
    batch = next(JMixture(data, start_step=1))
    tt = TrainConfig(precision=POLICY, total_steps=3, ref_steps=3,
                     batch_size=B, seq_len=S)
    tteacher, tstudent = _port(teacher), _port(student)
    for _, p in bridge.flatten(tstudent):
        p.requires_grad_(True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    jctx = jqat.make_ctx(POLICY)
    off = jqat.make_ctx("A16-C16-W16", mode="off")
    with jax.disable_jit():
        t_logits, _ = jforward(cfg, teacher, off, jb)

        def loss_fn(p):
            logits, aux = jforward(cfg, p, jctx, jb)
            return (jdistill.silq_loss(logits, t_logits, jb["labels"],
                                       mask=jb["loss_mask"])
                    + J_MOE_AUX_COEF * aux["moe_aux"])

        jl, jg = jax.value_and_grad(loss_fn)(student)
    with torch.no_grad():
        tt_logits, _ = forward(tcfg, tteacher,
                               tqat.make_ctx("A16-C16-W16", mode="off"), tb)
    assert _rel(tt_logits, t_logits) <= TEACHER_RTOL

    # the student against the reference's teacher logits
    shared = torch.from_numpy(_f32(t_logits).copy()).to(torch.bfloat16)
    logits, aux = forward(tcfg, tstudent, tqat.make_ctx(POLICY), tb)
    assert float(aux["moe_aux"].detach()) > 0.0
    loss = (tdistill.silq_loss(logits, shared, tb["labels"],
                               mask=tb["loss_mask"])
            + tsteps.MOE_AUX_COEF * aux["moe_aux"])
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    _grads_close(tsteps.grads_of(loss, tstudent), jg, tstudent)

    # the whole step, each package with its own teacher
    tstep = tsteps.make_train_step(tcfg, tt)
    tl, _ = tstep.loss_and_grads(tstudent, tteacher, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_LOSS_RTOL)


def test_train_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                    "--teacher-steps", "2", "--batch-size", "2",
                    "--seq-len", "24"])
    lines = [ln for ln in out.getvalue().splitlines() if "kd-loss" in ln]
    assert [ln.split(":")[0].strip() for ln in lines] == ["step 0", "step 1"]


# --------------------------------------------------------------------------
# calibration and PTQ on the MoE tree
# --------------------------------------------------------------------------

def test_weight_calibration_touches_all_s_w():
    """The reference's ``test_weight_calibration_touches_all_s_w`` on the
    port: every ``s_w`` of the reduced moonshot moves, the banks'
    ``(e, 1, d_out)`` and the router's included."""
    tcfg = t_reduced(ARCH)
    params = init_params(tcfg, seed=0, device="cpu")
    cal = tqat.calibrate_weight_scales(params, t_parse_policy(POLICY))
    before, after = _flat(params), _flat(cal)
    keys = [k for k in before if k.endswith("/s_w")]
    assert all(not torch.equal(before[k], after[k]) for k in keys)
    assert after["layers/0/moe/wg/s_w"].shape == (tcfg.n_experts, 1,
                                                  tcfg.d_ff)
    assert "layers/1/moe/router/s_w" in keys


def test_rtn_quantize_matches_reference(tree):
    """RTN calibrates the banks per (expert, column): ``s_w`` within the
    MSE search's 1e-3 of the reference's, every other leaf bitwise."""
    cfg, tcfg, params = tree
    want = _flat(_port(jrtn.rtn_quantize(cfg, params,
                                         parse_policy(POLICY), [])))
    got = _flat(trtn.rtn_quantize(tcfg, _port(params),
                                  t_parse_policy(POLICY), []))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k.endswith("/s_w"):
            torch.testing.assert_close(got[k], w, rtol=MSE_RTOL, atol=0,
                                       msg=k)
        else:
            assert torch.equal(got[k], w), k
    assert got["layers/0/moe/wd/s_w"].shape == (8, 1, 64)


def _assert_bitwise(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    bad = [k for k in w if not torch.equal(g[k], w[k])]
    assert not bad, bad[:5]


def test_smoothquant_fold_has_no_ln2_pair_in_a_moe_block(tree):
    """The fold from the same per-channel maxima, bitwise: ``ln1`` into
    ``wq``, ``wk``, ``wv``; nothing into the router or the experts (an
    MoE block has no ln2 pair in the reference), so ``ln2`` stays."""
    cfg, tcfg, params = tree
    params = jqat.calibrate_weight_scales(params, parse_policy("A8s-C8-W4"))
    cb = jcalib_batches(JSynth(vocab_size=cfg.vocab_size, seq_len=32,
                               batch_size=4), 2)
    # the maxima fold_smoothing collects itself (compiled)
    stats = jsq.collect_chan_maxima(cfg, params, cb)
    want = _port(jsq.fold_smoothing(cfg, params, 0.4, cb))
    tp = _port(params)
    got = tsq._fold_with(tcfg, tp, 0.4, _port(stats))
    _assert_bitwise(got, want)
    for i in range(tcfg.n_layers):
        assert not torch.equal(got["layers"][i]["ln1"]["w"],
                               tp["layers"][i]["ln1"]["w"])
        assert torch.equal(got["layers"][i]["ln2"]["w"],
                           tp["layers"][i]["ln2"]["w"])
        for k in ("router", "wg", "wu", "wd"):
            assert torch.equal(got["layers"][i]["moe"][k]["w"],
                               tp["layers"][i]["moe"][k]["w"])


def test_rotate_residual_matches_reference(tree):
    """ln2 folds into the router only, and the banks are rotated expert
    by expert (``R^T W`` for wg and wu, ``W R`` for wd): every weight
    within one bf16 ulp of the reference's; the report over experts
    within 1e-10."""
    cfg, tcfg, params = tree
    params = dict(params)
    segs = jax.tree.map(lambda x: x, params["segments"])
    # a non-uniform ln2, so the fold into the router shows
    ln2 = segs[0]["0"]["ln2"]
    ln2["w"] = (ln2["w"].astype(jnp.float32) * 1.5).astype(ln2["w"].dtype)
    params["segments"] = segs
    key = jax.random.PRNGKey(7)
    rot = jrot.rotate_residual(cfg, params, key)
    want = _flat(_port(rot))
    R = torch.from_numpy(np.array(jrot.random_rotation(cfg.d_model, key)))
    tp = _port(params)
    rotated = trot._rotate_with(tcfg, tp, R)
    got = _flat(rotated)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        tol = BF16_ULP * torch.maximum(w.float().abs(), g.float().abs())
        assert bool(((g.float() - w.float()).abs() <= tol).all()), k
    assert torch.equal(got["layers/0/ln2/w"],
                       torch.ones_like(got["layers/0/ln2/w"]))
    jrep = jrot.rotation_report(cfg, params, rot)
    trep = trot.rotation_report(tcfg, tp, rotated)
    assert trep.keys() == jrep.keys() == {"wq", "wk", "wg", "wu", "wd"}
    for name, d in jrep.items():
        for k, v in d.items():
            assert abs(trep[name][k] - v) <= REPORT_ATOL, (name, k)


# --------------------------------------------------------------------------
# the bridge and the checkpointer
# --------------------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_bridge_round_trip_of_the_moe_leaves(tree):
    """``segments/0/0/moe/{router,wg,wu,wd}/...`` split into per-layer
    ``moe`` dicts (the stacked (L, e, d_in, d_out) banks into (e, d_in,
    d_out) per layer) and stack back bitwise; the port's own init has the
    reference's tree."""
    cfg, tcfg, params = tree
    tp = _port(params)
    assert tuple(tp["layers"][1]["moe"]["wg"]["w"].shape) == (8, 64, 64)
    assert tuple(tp["layers"][1]["moe"]["wg"]["s_w"].shape) == (8, 1, 64)
    want = {k: _bits(v) for k, v in bridge.flatten(
        jax.tree.map(np.asarray, params))}
    assert want["segments/0/0/moe/wd/w"].shape == (2, 8, 64, 64)
    got = {k: _bits(v) for k, v in bridge.flatten(
        bridge.params_to_numpy(tp, ml_dtypes.bfloat16))}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    own = bridge.params_to_numpy(init_params(tcfg, device="cpu"))
    assert {k: np.shape(v) for k, v in bridge.flatten(own)} == \
        {k: np.shape(v) for k, v in want.items()}


def test_checkpoint_round_trip_of_the_moe_leaves(tree, tmp_path):
    cfg, tcfg, params = tree
    tp = _port(params)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, tp, {"step": 3})
    blank = init_params(tcfg, seed=5, device="cpu")
    restored, extra = ck.restore(blank)
    assert extra["step"] == 3
    _assert_bitwise(restored, tp)
