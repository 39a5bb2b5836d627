"""The port's recurrentgemma slice (recurrentgemma-2b) in training and
PTQ against the JAX package: one QAT step, the train CLI on the CPU,
SmoothQuant's fold, and the parameter bridge of the 26-layer stack (8
repeats of the 3-kind pattern and a 2-layer remainder segment). Serving:
``test_torch_recurrentgemma.py``.

Same params (the reference's, bridged), same batches (the same numpy
generator) through both, the reduced config (3 layers, d 64, local window
16, head dim 16); the JAX side runs op by op (``jax.disable_jit``).
Tolerances, each with its reason:

* the teacher's logits (quantization off, no gradient: the flash kernel's
  plain version in the local layer, the associative scan in the RG-LRU's)
  within ``TEACHER_RTOL``: a bf16 GEMM whose f32 accumulator lands near a
  bf16 tie rounds one ulp apart in XLA's dot and torch's GEMM (ROADMAP,
  Queue 3 properties), and the recurrence carries that ulp to every later
  position (measured 3.9e-3 relative L2 at B 2, S 24: one flip in
  ``rglru/w_out`` at position 5 of row 0; every gate bitwise);
* with the reference's teacher logits shared, the student's loss within
  ``LOSS_RTOL`` and every gradient leaf within ``GRAD_RTOL * |g_leaf| +
  GRAD_ATOL_GLOBAL * |g|``, the bounds of ``test_torch_xlstm_train.py``
  (bf16 GEMMs and reductions accumulate in another order);
* the whole step, each package with its own teacher: the loss within
  ``STEP_LOSS_RTOL`` (the teacher's gap above moves the KD target);
* SmoothQuant's fold from the same per-channel maxima, and the bridge:
  bitwise.
"""
import io
import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import distill as jdistill
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.core.ptq import smoothquant as jsq
from repro.data import MixtureIterator as JMixture
from repro.data import SyntheticConfig as JSynth
from repro.data import calibration_batches as jcalib_batches
from repro.launch.train import calibrate as jcalibrate
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import distill as tdistill
from repro_torch.core import qat as tqat
from repro_torch.core.ptq import smoothquant as tsq
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import main as train_main
from repro_torch.models import forward, init_params
from repro_torch.tree import tree_map

ARCH = "recurrentgemma-2b"
POLICY = "A8d-C8-W4"
PERIOD = 3                       # the block pattern's length
TEACHER_RTOL = 1e-2
LOSS_RTOL = 1e-6
STEP_LOSS_RTOL = 1e-3
GRAD_RTOL, GRAD_ATOL_GLOBAL = 2e-2, 1e-6


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


def _configs(n_layers=3):
    return (get_reduced_config(ARCH).replace(n_layers=n_layers),
            t_reduced(ARCH).replace(n_layers=n_layers))


# --------------------------------------------------------------------------
# QAT
# --------------------------------------------------------------------------

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
    assert any("rglru/lam" in k for k in gw)
    total = np.sqrt(sum(np.sum(v ** 2) for v in gw.values()))
    for k in gw:
        err = np.linalg.norm(gt[k] - gw[k])
        assert err <= GRAD_RTOL * np.linalg.norm(gw[k]) + \
            GRAD_ATOL_GLOBAL * total, (k, err, np.linalg.norm(gw[k]))


def test_qat_step_matches_op_by_op_reference():
    cfg, tcfg = _configs()
    B, S = 2, 24                   # longer than the 16-token window
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
            logits, _ = jforward(cfg, p, jctx, jb)
            return jdistill.silq_loss(logits, t_logits, jb["labels"],
                                      mask=jb["loss_mask"])

        jl, jg = jax.value_and_grad(loss_fn)(student)
    with torch.no_grad():
        tt_logits, _ = forward(tcfg, tteacher,
                               tqat.make_ctx("A16-C16-W16", mode="off"), tb)
    assert _rel(tt_logits, t_logits) <= TEACHER_RTOL

    # the student against the reference's teacher logits
    shared = torch.from_numpy(_f32(t_logits)).to(torch.bfloat16)
    logits, _ = forward(tcfg, tstudent, tqat.make_ctx(POLICY), tb)
    loss = tdistill.silq_loss(logits, shared, tb["labels"],
                              mask=tb["loss_mask"])
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
# SmoothQuant and the bridge
# --------------------------------------------------------------------------

def _assert_bitwise(got, want):
    g = {k: v.detach() for k, v in bridge.flatten(got)}
    w = {k: v.detach() for k, v in bridge.flatten(want)}
    assert g.keys() == w.keys()
    bad = [k for k in w if not torch.equal(g[k], w[k])]
    assert not bad, bad[:5]


def test_smoothquant_fold_matches_reference():
    """The fold from the same per-channel maxima: ``ln1`` into the
    RG-LRU's ``w_in`` and ``w_gate`` (the local layers': ``wq``, ``wk``,
    ``wv``), ``ln2`` into ``mlp/wg`` and ``mlp/wu``, as the reference
    folds them; bitwise."""
    cfg, tcfg = _configs()
    params = jqat.calibrate_weight_scales(jinit(cfg, jax.random.PRNGKey(1)),
                                          parse_policy("A8s-C8-W4"), "mse")
    cb = jcalib_batches(JSynth(vocab_size=cfg.vocab_size, seq_len=32,
                               batch_size=4), 2)
    stats = jsq.collect_chan_maxima(cfg, params, cb)
    want = _port(jsq.fold_smoothing(cfg, params, 0.4, cb))
    tp = _port(params)
    got = tsq._fold_with(tcfg, tp, 0.4, _port(stats))
    _assert_bitwise(got, want)
    for key in ("rglru", "mlp"):
        assert not torch.equal(got["layers"][0]["ln2" if key == "mlp"
                                                else "ln1"]["w"],
                               tp["layers"][0]["ln2" if key == "mlp"
                                               else "ln1"]["w"])
    assert not torch.equal(got["layers"][0]["rglru"]["w_in"]["w"],
                           tp["layers"][0]["rglru"]["w_in"]["w"])
    assert not torch.equal(got["layers"][2]["attn"]["wq"]["w"],
                           tp["layers"][2]["attn"]["wq"]["w"])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_bridge_round_trip_of_the_26_layer_stack():
    """recurrentgemma-2b's 26 layers at a small width: 8 repeats of the
    3-kind pattern and a 2-layer remainder segment. ``params_to_numpy``
    (period 3) inverts ``params_from_numpy`` on the reference's paths."""
    cfg = get_config(ARCH).replace(d_model=32, n_heads=2, n_kv_heads=1,
                                   head_dim=16, d_ff=64, vocab_size=64,
                                   lru_width=32)
    params = jinit(cfg, jax.random.PRNGKey(1))
    assert [len(s["0"]["ln1"]["w"]) for s in params["segments"]] == [8, 1]
    tp = _port(params)
    assert len(tp["layers"]) == 26
    assert [("rglru" in p) for p in tp["layers"]] == \
        [k == "rglru" for k in cfg.layer_kinds()]
    want = {k: _bits(v) for k, v in bridge.flatten(
        jax.tree.map(np.asarray, params))}
    got = {k: _bits(v) for k, v in bridge.flatten(
        bridge.params_to_numpy(tp, ml_dtypes.bfloat16, period=PERIOD))}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's own init has the reference's tree
    own = bridge.params_to_numpy(init_params(
        t_get_config(ARCH).replace(d_model=32, n_heads=2, n_kv_heads=1,
                                   head_dim=16, d_ff=64, vocab_size=64,
                                   lru_width=32), device="cpu"),
        period=PERIOD)
    assert {k: np.shape(v) for k, v in bridge.flatten(own)} == \
        {k: np.shape(v) for k, v in want.items()}
