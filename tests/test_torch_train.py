"""Parity of the port's QAT training path with the JAX package at the
reduced qwen2.5-3b config: data, loss, optimizer, scale masks,
calibration, the forward in every mode, and the train step.

Same params (the reference's, bridged), same batches (the same numpy
generator) through both; the JAX side runs op by op (``jax.disable_jit``)
where bits are compared. Tolerances, with their reasons:

* bitwise: the synthetic batches (one numpy generator); the forward's
  hidden states in modes off / train / calib (the ops are the same
  f32/bf16 ops one by one, as in ``tests/test_torch_models.py``);
* the logits: equal except where a bf16 GEMM's f32 accumulator lands
  within its summation-order error of a bf16 rounding tie, which then
  rounds one ulp apart (XLA's dot and torch's CPU GEMM sum in different
  orders; observed 1 of 8192 logits, at a value 1e-8 from the tie): at
  most one bf16 ulp, on at most 0.1% of the logits;
* the calibration statistics and the activation scales merged from them
  within one bf16 ulp (2^-7 relative): a statistic interpolates the
  largest |x| of a site, and an upstream GEMM output that rounds one ulp
  apart (above) can be among them (observed: most equal, one MLP input
  1.6e-3 apart); the port's whole calibration, whose MSE weight scales
  differ within 1e-3 and so flip some fake-quant codes, within 5%;
* losses within 1e-6 relative: the KD / next-token sums over the
  vocabulary run in another order (observed 9e-8, and 1.7e-7 for the
  evaluation loss through the one flipped logit);
* every gradient leaf within ``2e-2 * |g_leaf| + 1e-7 * |g|`` (L2): the
  gradients are bf16 tensors out of bf16 GEMMs and reductions whose
  accumulation order and rounding points differ between XLA:CPU and
  torch's CPU kernels, one to a few bf16 ulps (2^-8) per element
  (observed up to 1.2e-2 on the bias leaves); the absolute term covers
  per-tensor scales whose gradient sums cancel to ~1e-7 (observed up to
  2.4e-2 relative on such a scalar);
* each leaf's movement over three steps (after minus before) against
  the reference's, with ``L = sum(lr_t) * lr_mult`` the most Adam moves
  an element (its first step is ``lr * sign(g)``): within
  ``0.2 * |movement|`` in L2 over the leaf (observed up to 0.14, on a
  bf16 weight where a few elements round across a bf16 boundary in one
  run only; a leaf left in place reads 1, a flipped update 2, a lost 50x
  act-scale boost 0.98), and per element within ``L / 4`` plus one bf16
  ulp of the value for bf16 leaves (observed 0.15 L on a per-tensor act
  scale, whose summed gradient cancels to near its rounding error). The
  attention's key bias is the exception: softmax ignores any per-query
  constant, so its gradient nearly cancels and 36-63% of its elements
  move by more than ``L / 10`` apart (Adam turns a sign of rounding noise
  into a full step); there each element stays within ``2 L`` plus an ulp
  (both runs inside Adam's range) and at most half part by ``L / 10``;
* the MSE weight scales within 1e-3 relative (see
  ``tests/test_torch_calibration.py``).
"""
import io
import contextlib

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
from repro.core.precision import parse_policy as jparse
from repro.data import MixtureIterator as JMixture
from repro.data import SyntheticConfig as JSynth
from repro.data import calibration_batches as jcalib_batches
from repro.launch import steps as jsteps
from repro.launch.train import calibrate as jcalibrate
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim.adamw import clip_by_global_norm as jclip
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import distill as tdistill
from repro_torch.core import qat as tqat
from repro_torch.core.precision import parse_policy as tparse
from repro_torch.data import MixtureIterator, SyntheticConfig, \
    calibration_batches
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import calibrate as tcalibrate
from repro_torch.launch.train import main as train_main
from repro_torch.models import forward as tforward
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map

B, S = 2, 16
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL_GLOBAL = 2e-2, 1e-6
MSE_RTOL = 1e-3
UPD_RTOL, UPD_ELEM = 0.2, 0.25      # three steps' movement (see above)
STAT_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return bridge.params_from_numpy(_np_tree(tree), "cpu")


def _flat_ref(tree):
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in bridge.flatten(_np_tree(tree))}


def _flat_port(params):
    return {k: np.asarray(v, np.float32) for k, v in
            bridge.flatten(bridge.params_to_numpy(params))}


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced_config("qwen2.5-3b")
    teacher = jinit(cfg, jax.random.PRNGKey(0))
    data = JSynth(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                  seed=0)
    students = {}
    for pol in ("A8d-C8-W4", "A8s-C8-W4"):
        jt = JTrainConfig(precision=pol, total_steps=3, ref_steps=3,
                          batch_size=B, seq_len=S)
        students[pol] = jcalibrate(cfg, teacher, jt, data)   # compiled
    batches = [next(it) for it in [JMixture(data, start_step=1)] * 3]
    return cfg, t_reduced("qwen2.5-3b"), teacher, students, data, batches


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,start", [(0, 0), (3, 17), (11, 10_000_019)])
def test_mixture_batches_bitwise(seed, start):
    jc = JSynth(vocab_size=300, seq_len=40, batch_size=3, seed=seed,
                dclm_ratio=0.5)
    tc = SyntheticConfig(vocab_size=300, seq_len=40, batch_size=3,
                         seed=seed, dclm_ratio=0.5)
    ji, ti = JMixture(jc, start_step=start), MixtureIterator(tc,
                                                             start_step=start)
    for _ in range(3):
        a, b = next(ji), next(ti)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ji.state_dict() == ti.state_dict()
    for a, b in zip(jcalib_batches(jc, 2), calibration_batches(tc, 2)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# loss and optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kd_ratio,temp,masked", [
    (1.0, 1.0, True), (1.0, 2.0, False), (0.5, 1.0, True),
    (0.0, 1.0, False)])
def test_silq_loss_and_gradient(kd_ratio, temp, masked):
    rng = np.random.default_rng(int(kd_ratio * 10 + temp))
    sl = rng.standard_normal((2, 5, 33)).astype(np.float32) * 3
    tl = rng.standard_normal((2, 5, 33)).astype(np.float32) * 3
    lab = rng.integers(0, 33, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.7).astype(np.float32) if masked else None
    jsl = jnp.asarray(sl).astype(jnp.bfloat16)
    tsl = bridge.to_torch(np.asarray(jsl), "cpu").requires_grad_(True)

    def jloss(s):
        return jdistill.silq_loss(s, jnp.asarray(tl), jnp.asarray(lab),
                                  kd_ratio=kd_ratio, kd_temperature=temp,
                                  mask=None if mask is None
                                  else jnp.asarray(mask))

    with jax.disable_jit():
        jl, jg = jax.value_and_grad(jloss)(jsl)
    tl_ = tdistill.silq_loss(tsl, torch.from_numpy(tl), torch.from_numpy(lab),
                             kd_ratio=kd_ratio, kd_temperature=temp,
                             mask=None if mask is None
                             else torch.from_numpy(mask))
    tl_.backward()
    np.testing.assert_allclose(float(tl_), float(jl), rtol=LOSS_RTOL)
    # the gradient is bf16 (the logits' type): within one bf16 ulp
    np.testing.assert_allclose(tsl.grad.float().numpy(),
                               np.asarray(jg.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-7)


def _opt_tree(rng):
    def mat(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1
    return {"lin": {"w": jnp.asarray(mat(8, 6)).astype(jnp.bfloat16),
                    "s_w": jnp.asarray(np.abs(mat(1, 6)) + 0.01),
                    "s_in": jnp.float32(0.05)},
            "norm": {"w": jnp.asarray(mat(6)).astype(jnp.bfloat16)},
            "attn": {"s_q": jnp.float32(0.02)}}


def test_adamw_and_clip_match_reference():
    """Three AdamW steps with equal gradients (large enough to clip),
    decay on the matrix only, the 50x boost on activation scales, and an
    unused scale: ``None`` in the port, zeros in the reference."""
    rng = np.random.default_rng(0)
    jp = _opt_tree(rng)
    tp = tree_map(lambda a: bridge.to_torch(np.asarray(a), "cpu"),
                  _np_tree(jp))
    jopt, topt = jadamw_init(jp), adamw_init(tp)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(
                np.float32) * 5).astype(a.dtype), jp)
        grads["lin"]["s_in"] = jnp.zeros((), jnp.float32)
        tg = tree_map(lambda a: bridge.to_torch(np.asarray(a), "cpu"),
                      _np_tree(grads))
        tg["lin"]["s_in"] = None
        lr = 1e-2 * (step + 1)
        with jax.disable_jit():
            grads, jn = jclip(grads, 1.0)
            jp, jopt = jadamw_update(jp, grads, jopt, lr=jnp.float32(lr))
        tg, tn = clip_by_global_norm(tg, 1.0)
        tp, topt = adamw_update(tp, tg, topt, lr=float(np.float32(lr)))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert int(topt.step) == int(jopt.step) == 3
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a.astype(jnp.float32)),
                                   rtol=2 ** -8, atol=1e-7)
    for a, b in zip(jax.tree.leaves((jopt.m, jopt.v)),
                    tree_leaves((topt.m, topt.v))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-9)
    # the unused scale kept its value in both
    assert float(tp["lin"]["s_in"]) == float(jp["lin"]["s_in"]) == \
        float(np.float32(0.05))


def test_scale_masks(setup):
    cfg, tcfg, teacher, *_ = setup
    tp = _port(teacher)
    for jfn, tfn in ((jqat.scale_mask, tqat.scale_mask),
                     (jqat.act_scale_mask, tqat.act_scale_mask)):
        want = dict(bridge.flatten(_np_tree(jfn(teacher))))
        got = {}
        for path, v in bridge.flatten(tfn(tp)):
            parts = path.split("/")
            key = ("segments/0/0/" + "/".join(parts[2:])
                   if parts[0] == "layers" else path)
            got.setdefault(key, set()).add(v)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == {bool(np.all(v))}, k


# --------------------------------------------------------------------------
# calibration and the forward
# --------------------------------------------------------------------------

def test_weight_calibration_on_reduced_model(setup):
    cfg, tcfg, teacher, students, *_ = setup
    pol = jparse("A8d-C8-W4")
    got = _flat_port(tqat.calibrate_weight_scales(_port(teacher),
                                                  tparse("A8d-C8-W4")))
    want = _flat_ref(students["A8d-C8-W4"])
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith("s_w"):
            assert not np.array_equal(want[k], _flat_ref(teacher)[k]), k
            np.testing.assert_allclose(got[k], want[k], rtol=MSE_RTOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert pol.head_bits == 8          # the tied head's scale is 8-bit


def test_act_calibration_and_merge_on_reduced_model(setup):
    """Static policy: the calibration forward's per-site statistics
    (percentiles over 5 batches) and the scales merged from them; the
    weight scales are taken from the reference so that both forwards see
    the same weights."""
    cfg, tcfg, teacher, students, data, _ = setup
    pol = "A8s-C8-W4"
    jt = JTrainConfig(precision=pol, batch_size=B, seq_len=S)
    with jax.disable_jit():
        # the reference recomputes the weight scales inside calibrate;
        # op by op both times, so they are the same bits
        wscaled = jqat.calibrate_weight_scales(teacher, jparse(pol))
        want = jcalibrate(cfg, wscaled, jt, data)
    tc = TrainConfig(precision=pol, batch_size=B, seq_len=S)
    tdata = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                            batch_size=B, seed=0)
    policy = tparse(pol)
    twith = _port(wscaled)
    ctx = tqat.make_ctx(policy, mode="calib")
    stats = []
    with torch.no_grad():
        for b in calibration_batches(tdata, tc.calib_batches):
            tb = {"tokens": torch.from_numpy(b["tokens"])}
            stats.append(tforward(tcfg, twith, ctx, tb,
                                  collect_stats=True)[1]["qstats"])
    got = _flat_port(tqat.merge_act_scales(twith, stats, policy))
    wantf = _flat_ref(want)
    n_act = 0
    for k in wantf:
        if k.split("/")[-1] in tqat.ACT_SCALE_KEYS:
            n_act += 1
            np.testing.assert_allclose(got[k], wantf[k], rtol=STAT_RTOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], wantf[k], err_msg=k)
    assert n_act == 10 + 1   # 7 s_in + s_q/s_k/s_v (stacked), the head
    # and through the port's own calibrate (weights by its MSE search)
    full = _flat_port(tcalibrate(tcfg, _port(teacher), tc, tdata))
    for k in wantf:
        np.testing.assert_allclose(full[k], wantf[k], rtol=5e-2, err_msg=k)


def _assert_logits(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    ulp = np.spacing(np.abs(want).astype(ml_dtypes.bfloat16)).astype(
        np.float32)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got != want) <= 1e-3


@pytest.mark.parametrize("policy,mode", [
    ("A16-C16-W16", "off"), ("A8d-C8-W4", "train"), ("A8s-C8-W4", "train"),
    ("A8s-C8-W4", "calib")])
def test_forward_matches_op_by_op_reference(setup, policy, mode):
    cfg, tcfg, teacher, students, _, batches = setup
    params = teacher if mode == "off" else students.get(
        policy, students["A8s-C8-W4"])
    jctx = jqat.make_ctx(policy, mode=mode)
    tctx = tqat.make_ctx(policy, mode=mode)
    collect = mode == "calib"
    jb, tb = _jbatch(batches[0]), _tbatch(batches[0])
    with jax.disable_jit():
        jl, jaux = jforward(cfg, params, jctx, jb, collect_stats=collect)
    with torch.no_grad():
        tl, taux = tforward(tcfg, _port(params), tctx, tb,
                            collect_stats=collect)
    _assert_logits(tl, jl)
    if collect:
        want = dict(bridge.flatten(_np_tree(jaux["qstats"])))
        got = {}
        for path, v in bridge.flatten(taux["qstats"]):
            parts = path.split("/")
            if parts[0] == "layers":
                key = "segments/0/0/" + "/".join(parts[2:])
                got.setdefault(key, []).append(float(v))
            else:
                got[path] = [float(v)]
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                       np.asarray(v).reshape(-1),
                                       rtol=STAT_RTOL, err_msg=k)
    # under autograd the blockwise path gives the same logits
    tl2, _ = tforward(tcfg, _port(params), tctx, tb)
    assert torch.equal(tl, tl2.detach())


def test_eval_loss_matches_reference(setup):
    cfg, tcfg, teacher, students, _, batches = setup
    p = students["A8d-C8-W4"]
    with jax.disable_jit():
        want = jsteps.make_eval_loss(cfg, "A8d-C8-W4")(p, _jbatch(batches[1]))
    got = tsteps.make_eval_loss(tcfg, "A8d-C8-W4")(_port(p),
                                                   _tbatch(batches[1]))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _trainable(tree):
    for p in tree_leaves(tree):
        p.requires_grad_(True)
    return tree


@pytest.mark.parametrize("policy", ["A8d-C8-W4", "A8s-C8-W4"])
def test_train_step_matches_op_by_op_reference(setup, policy):
    cfg, tcfg, teacher, students, _, batches = setup
    student = students[policy]
    jt = JTrainConfig(precision=policy, total_steps=3, ref_steps=3,
                      batch_size=B, seq_len=S)
    tt = TrainConfig(precision=policy, total_steps=3, ref_steps=3,
                     batch_size=B, seq_len=S)
    tstep = tsteps.make_train_step(tcfg, tt)
    tteacher = _port(teacher)
    tstudent = _trainable(_port(student))

    # one step's loss and every gradient leaf
    jctx = jqat.make_ctx(policy)
    tctx = jqat.make_ctx("A16-C16-W16", mode="off")
    jb = _jbatch(batches[0])
    with jax.disable_jit():
        t_logits, _ = jforward(cfg, teacher, tctx, jb)

        def loss_fn(p):
            logits, _ = jforward(cfg, p, jctx, jb)
            return jdistill.silq_loss(logits, t_logits, jb["labels"],
                                      mask=jb["loss_mask"])

        jl, jg = jax.value_and_grad(loss_fn)(student)
    tl, tg = tstep.loss_and_grads(tstudent, tteacher, _tbatch(batches[0]))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    tg = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g, tg,
                  tstudent)
    gw, gt = _flat_ref(jg), _flat_port(tg)
    assert gw.keys() == gt.keys()
    total = np.sqrt(sum(np.sum(v ** 2) for v in gw.values()))
    for k in gw:
        err = np.linalg.norm(gt[k] - gw[k])
        assert err <= GRAD_RTOL * np.linalg.norm(gw[k]) + \
            GRAD_ATOL_GLOBAL * total, (k, err, np.linalg.norm(gw[k]))

    # three steps: parameters and scales
    jstep = jsteps.make_train_step(cfg, jt)
    jp, jopt = student, jadamw_init(student)
    topt = adamw_init(tstudent)
    lrs, losses = [], []
    with jax.disable_jit():
        for i, b in enumerate(batches):
            jp, jopt, jm = jstep(jp, teacher, jopt, _jbatch(b), jnp.int32(i))
            lrs.append(float(jm["lr"]))
            losses.append(float(jm["loss"]))
    for i, b in enumerate(batches):
        tstudent, topt, tm = tstep(tstudent, tteacher, topt, _tbatch(b), i)
        assert tm["lr"] == lrs[i]
        # after the first step the parameters differ within the bound
        # below, which moves the loss by ~1e-6
        np.testing.assert_allclose(float(tm["loss"]), losses[i],
                                   rtol=LOSS_RTOL if i == 0 else 1e-5)
    assert int(topt.step) == int(jopt.step) == 3
    pw, pt = _flat_ref(jp), _flat_port(tstudent)
    bf16 = {k for k, v in bridge.flatten(_np_tree(jp))
            if v.dtype == ml_dtypes.bfloat16}
    before = _flat_ref(student)
    moved = 0
    for k in pw:
        mult = 50.0 if k.split("/")[-1] in tqat.ACT_SCALE_KEYS else 1.0
        L = sum(lrs) * mult
        dj, dt = pw[k] - before[k], pt[k] - before[k]
        ulp = 0.0
        if k in bf16:
            ulp = np.spacing(np.maximum(np.abs(pw[k]), np.abs(pt[k])).astype(
                ml_dtypes.bfloat16)).astype(np.float32)
        diff = np.abs(dt - dj)
        if k.endswith("attn/wk/b"):
            assert np.all(diff <= 2 * L + ulp), k
            assert np.mean(diff > L / 10) <= 0.5, k
        else:
            assert np.linalg.norm(dt - dj) <= UPD_RTOL * np.linalg.norm(dj), k
            assert np.all(diff <= UPD_ELEM * L + ulp), k
        if k.endswith("s_w"):
            moved += int(np.any(pw[k] != before[k]))
            assert np.any(pt[k] != before[k]), k
    assert moved == 7 + 1             # stacked over layers, and the head


def test_train_step_refuses_int8_compression(setup):
    cfg, tcfg, *_ = setup
    with pytest.raises(NotImplementedError, match="data-parallel"):
        tsteps.make_train_step(tcfg, TrainConfig(grad_compression="int8"))


def test_cli_runs_two_steps_on_cpu(monkeypatch):
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("a CPU run tried to build or load a kernel")

    monkeypatch.setattr(build, "load", refuse)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["--device", "cpu", "--steps", "2", "--teacher-steps",
                    "2", "--batch-size", "2", "--seq-len", "16"])
    lines = [ln for ln in out.getvalue().splitlines() if "kd-loss" in ln]
    assert [ln.split(":")[0].strip() for ln in lines] == ["step 0", "step 1"]
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)


def test_entry_point_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--steps", "1", "--teacher-steps", "1"])
