"""The port's xLSTM slice (xlstm-125m) in training against the JAX
package: one QAT step, ``run_qat`` and the train CLI on the CPU, and the
parameter bridge and checkpoints of the multi-kind block pattern.
Serving: ``test_torch_xlstm.py``.

Same params (the reference's, bridged), same batches (the same numpy
generator) through both, the reduced config (2 layers, d 64, pattern
(mLSTM, sLSTM)); the JAX side runs op by op (``jax.disable_jit``).
Tolerances, each with its reason:

* the teacher's logits, through the sLSTM scan (the port's route for a
  forward without quantization and gradient, in its ``carry="gx"``
  mode: the reference's bf16-carry cell), against the reference within
  ``TEACHER_RTOL``: measured 0, bitwise at this shape (it was 3.5e-3,
  49% of the bf16 values apart, while the scan carried h in f32). What
  is left at longer sequences is torch's CPU sigmoid and tanh against
  XLA:CPU's, which round some f32 values an ulp apart and so flip an
  occasional bf16 h (``test_torch_slstm_scan.py`` measures it);
* with the reference's teacher logits shared, the student's loss within
  ``LOSS_RTOL`` and every gradient leaf within ``test_torch_train.py``'s
  bound, ``GRAD_RTOL * |g_leaf| + GRAD_ATOL_GLOBAL * |g|`` (measured loss
  2.8e-7 and 9.3e-8 apart under A8d / A8s, leaves up to 6.2e-3 and
  2.2e-2 of their norm, the latter on activation scales whose gradients
  are 1e-5 of the total; bf16 GEMMs and reductions accumulate in
  another order);
* the whole step, each package with its own teacher: the loss within
  ``STEP_LOSS_RTOL`` (measured 2.8e-7 and 9.3e-8, as with the logits
  shared, now that the teachers agree; 4.5e-5 while the scan carried h
  in f32) and the gradients within the same bound (measured within it);
* the static policy's activation scales, calibrated over 5 batches at
  every recurrent site, within one bf16 ulp (``STAT_RTOL``, as in
  ``test_torch_train.py``);
* the bridge and checkpoints: bitwise.
"""
import io
import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config, get_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import distill as jdistill
from repro.core import qat as jqat
from repro.core.precision import parse_policy as jparse
from repro.data import MixtureIterator as JMixture
from repro.data import SyntheticConfig as JSynth
from repro.launch.train import calibrate as jcalibrate
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import distill as tdistill
from repro_torch.core import qat as tqat
from repro_torch.core.precision import parse_policy as tparse
from repro_torch.data import SyntheticConfig, calibration_batches
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import run_qat
from repro_torch.models import forward
from repro_torch.tree import tree_leaves, tree_map

ARCH = "xlstm-125m"
POLICY = "A8d-C8-W4"
PERIOD = 2                       # the reduced block pattern's length
TEACHER_RTOL = 0.0
LOSS_RTOL = 1e-6
STEP_LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL_GLOBAL = 2e-2, 1e-6
STAT_RTOL = 2.0 ** -7


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


# --------------------------------------------------------------------------
# QAT
# --------------------------------------------------------------------------

B, S = 2, 16


def _flat_ref(tree):
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in bridge.flatten(jax.tree.map(np.asarray, tree))}


def _flat_port(params):
    return {k: np.asarray(v, np.float32) for k, v in bridge.flatten(
        bridge.params_to_numpy(params, period=PERIOD))}


def _grads_close(tg, jg, student):
    tg = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g, tg,
                  student)
    gw, gt = _flat_ref(jg), _flat_port(tg)
    assert gw.keys() == gt.keys()
    total = np.sqrt(sum(np.sum(v ** 2) for v in gw.values()))
    for k in gw:
        err = np.linalg.norm(gt[k] - gw[k])
        assert err <= GRAD_RTOL * np.linalg.norm(gw[k]) + \
            GRAD_ATOL_GLOBAL * total, (k, err, np.linalg.norm(gw[k]))


@pytest.fixture(scope="module")
def qat_setup():
    cfg, tcfg = get_reduced_config(ARCH), t_reduced(ARCH)
    teacher = jinit(cfg, jax.random.PRNGKey(0))
    data = JSynth(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                  seed=0)
    students = {}
    for pol in ("A8d-C8-W4", "A8s-C8-W4"):
        jt = JTrainConfig(precision=pol, total_steps=3, ref_steps=3,
                          batch_size=B, seq_len=S)
        students[pol] = jcalibrate(cfg, teacher, jt, data)   # compiled
    batch = next(JMixture(data, start_step=1))
    return cfg, tcfg, teacher, students, batch


@pytest.mark.parametrize("policy", ["A8d-C8-W4", "A8s-C8-W4"])
def test_qat_step_matches_op_by_op_reference(qat_setup, policy):
    cfg, tcfg, teacher, students, batch = qat_setup
    student = students[policy]
    tt = TrainConfig(precision=policy, total_steps=3, ref_steps=3,
                     batch_size=B, seq_len=S)
    tstep = tsteps.make_train_step(tcfg, tt)
    tteacher = _port(teacher)
    tstudent = _port(student)
    for p in tree_leaves(tstudent):
        p.requires_grad_(True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    jctx = jqat.make_ctx(policy)
    off = jqat.make_ctx("A16-C16-W16", mode="off")
    with jax.disable_jit():
        t_logits, _ = jforward(cfg, teacher, off, jb)

        def loss_fn(p):
            logits, _ = jforward(cfg, p, jctx, jb)
            return jdistill.silq_loss(logits, t_logits, jb["labels"],
                                      mask=jb["loss_mask"])

        jl, jg = jax.value_and_grad(loss_fn)(student)

    # the teacher: the sLSTM scan (carry="gx") against the reference
    with torch.no_grad():
        tt_logits, _ = forward(tcfg, tteacher,
                               tqat.make_ctx("A16-C16-W16", mode="off"), tb)
    assert _rel(tt_logits, t_logits) <= TEACHER_RTOL

    # the student against the reference's teacher logits
    shared = torch.from_numpy(_f32(t_logits)).to(torch.bfloat16)
    logits, _ = forward(tcfg, tstudent, tqat.make_ctx(policy), tb)
    loss = tdistill.silq_loss(logits, shared, tb["labels"],
                              mask=tb["loss_mask"])
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    _grads_close(tsteps.grads_of(loss, tstudent), jg, tstudent)

    # the whole step, each package with its own teacher
    tl, tg = tstep.loss_and_grads(tstudent, tteacher, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_LOSS_RTOL)
    _grads_close(tg, jg, tstudent)


def test_act_calibration_on_recurrent_sites(qat_setup):
    """Static policy: the calibration forward (mode ``calib``, the
    per-step sLSTM cell) collects every recurrent site (the mLSTM's
    ``s_q``/``s_k``/``s_v``/``s_state``, the sLSTM's ``s_state``, every
    cell linear's ``s_in``) in the params' layout, and the merged scales
    match the reference's within one bf16 ulp (``STAT_RTOL``, the bound
    of ``test_torch_train.py``: a percentile can land on a value an
    upstream GEMM rounded apart)."""
    cfg, tcfg, teacher, _, _ = qat_setup
    pol = "A8s-C8-W4"
    data = JSynth(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                  seed=0)
    jt = JTrainConfig(precision=pol, batch_size=B, seq_len=S)
    with jax.disable_jit():
        wscaled = jqat.calibrate_weight_scales(teacher, jparse(pol))
        want = _flat_ref(jcalibrate(cfg, wscaled, jt, data))
    policy = tparse(pol)
    tdata = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                            batch_size=B, seed=0)
    twith = _port(wscaled)
    ctx = tqat.make_ctx(policy, mode="calib")
    stats = []
    with torch.no_grad():
        for b in calibration_batches(tdata, TrainConfig().calib_batches):
            tb = {"tokens": torch.from_numpy(b["tokens"])}
            stats.append(forward(tcfg, twith, ctx, tb,
                                 collect_stats=True)[1]["qstats"])
    got = _flat_port(tqat.merge_act_scales(twith, stats, policy))
    assert got.keys() == want.keys()
    n_act = 0
    for k in want:
        if k.split("/")[-1] in tqat.ACT_SCALE_KEYS:
            n_act += 1
            np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # mLSTM: 6 linears' s_in + s_q, s_k, s_v, s_state; sLSTM: 4 linears'
    # s_in + s_state; the head
    assert n_act == 10 + 5 + 1


def test_run_qat_on_cpu():
    """``run_qat`` end to end on the reduced xLSTM: every weight scale
    moves in one step and the loss is finite."""
    tcfg = TrainConfig(precision=POLICY, total_steps=1, ref_steps=1,
                       batch_size=2, seq_len=16)
    seen = {}

    def on_start(student, opt):
        seen["s_w"] = {k: v.detach().clone() for k, v in
                       bridge.flatten(student) if k.endswith("s_w")}

    def on_step(step, metrics, student, opt):
        seen["loss"] = float(metrics["loss"])
        seen["moved"] = [k for k, v in bridge.flatten(student)
                         if k.endswith("s_w")
                         and not torch.equal(v, seen["s_w"][k])]

    with contextlib.redirect_stdout(io.StringIO()):
        run_qat(ARCH, tcfg, teacher_steps=2, device="cpu",
                on_start=on_start, on_step=on_step)
    assert np.isfinite(seen["loss"])
    # 6 mLSTM + 4 sLSTM linears, and the head
    assert len(seen["s_w"]) == 11 and sorted(seen["moved"]) == sorted(
        seen["s_w"])


def test_train_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                    "--teacher-steps", "2", "--batch-size", "2",
                    "--seq-len", "16"])
    lines = [ln for ln in out.getvalue().splitlines() if "kd-loss" in ln]
    assert [ln.split(":")[0].strip() for ln in lines] == ["step 0", "step 1"]


# --------------------------------------------------------------------------
# bridge and checkpoints
# --------------------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("n_layers", [12, 8])
def test_bridge_and_checkpoints_use_reference_paths(tmp_path, n_layers):
    """The full block pattern (5 mLSTM : 1 sLSTM) at a small width: 12
    layers are 2 repeats of its 6 kinds, 8 layers one repeat and a
    2-kind remainder segment. ``params_to_numpy`` inverts
    ``params_from_numpy`` on the reference's paths, and checkpoints
    cross between the packages both ways."""
    cfg = get_config(ARCH).replace(d_model=64, vocab_size=256,
                                   n_layers=n_layers)
    period = len(cfg.block_pattern)
    params = jinit(cfg, jax.random.PRNGKey(1))
    tp = _port(params)
    assert [("cell" in p and ("w_q" in p["cell"])) for p in tp["layers"]] \
        == [k == "mlstm" for k in cfg.layer_kinds()]
    want = {k: _bits(v) for k, v in bridge.flatten(
        jax.tree.map(np.asarray, params))}
    got = {k: _bits(v) for k, v in bridge.flatten(
        bridge.params_to_numpy(tp, ml_dtypes.bfloat16, period=period))}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    Checkpointer(str(tmp_path / "port"), period=period).save(3, tp,
                                                             {"step": 3})
    template = jax.tree.map(jnp.zeros_like, params)
    rp, extra = JCheckpointer(str(tmp_path / "port")).restore(template)
    assert extra == {"step": 3}
    for k, v in bridge.flatten(jax.tree.map(np.asarray, rp)):
        np.testing.assert_array_equal(_bits(v), want[k], err_msg=k)

    JCheckpointer(str(tmp_path / "ref")).save(5, params, {"step": 5})
    zeros = tree_map(torch.zeros_like, tp)
    Checkpointer(str(tmp_path / "ref"), period=period).restore(zeros)
    for k, v in bridge.flatten(bridge.params_to_numpy(
            zeros, ml_dtypes.bfloat16, period=period)):
        np.testing.assert_array_equal(_bits(v), want[k], err_msg=k)
