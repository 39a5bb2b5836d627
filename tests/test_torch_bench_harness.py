"""Parity of the port's benchmark harness (``repro_torch/benchmarks``) with
the JAX package's ``benchmarks/common.py`` at the reduced qwen2.5-3b
config, and a run of every table's ``main`` at 2 teacher and 2 QAT steps.

Same params (the reference's, bridged), same batches (one numpy generator)
through both; the JAX side runs its harness as it is (compiled), never
its ``get_teacher``, which writes into the repository's ``artifacts/``.
Tolerances, with their reasons:

* the threefry ``split`` keys and the single-key ``categorical`` draws
  (Table 2's self-generation) bitwise equal to ``jax.random``'s, over
  (B, V) logits in bfloat16 (the decode logits' dtype: the noise is drawn
  and added in bfloat16, bitwise) and in float32 (the uniforms bitwise;
  the gumbel noise goes through ``log`` twice and may differ by an f32
  ulp, which no draw here reaches);
* ``eval_quality``: the next-token loss within 1e-4 relative and the
  KL(teacher||student) within 1e-2 relative: compiled XLA (fusion, FMA
  contraction) and torch's CPU kernels round the logits apart by bf16
  ulps, which fake-quant amplifies (observed 2.1e-5 and 1.4e-3); the
  top-1 agreement within 4 tokens a batch: a near tie of bf16 logits
  flips its argmax, and a static activation scale flips a code where an
  ulp crosses a rounding boundary (observed up to 1.5 tokens a batch,
  A8s-C8-W4);
* ``run_silq`` at 2 steps, both loops started from one calibrated
  student (the reference's ``calibrate`` output, bridged; each side's
  ``calibrate`` is replaced by it and records the data config it was
  given) at a learning rate of 1e-3, where one Adam step moves a bf16
  weight of |w| ~ 0.1 by about two ulps (at the default 5e-6 it moves
  1% of them, by rounding alone). The data configs equal; each step's
  batch bitwise, its step index and learning rate equal; its loss
  within 5e-6 relative at the first step (same params, same batch:
  observed 7.8e-7) and 5e-5 after (observed 9.2e-6); each leaf's
  movement (after minus the calibrated start) against the reference's
  within 0.25 in L2 over all leaves and 0.5 per leaf (observed 0.188
  and 0.387, the compiled reference's gradients rounding apart and Adam
  turning a near-zero gradient's sign into a full step; an update lost
  at the second step reads 0.35, at the first 1.06, a stream started at
  step 0 1.30), the attention key bias within ``2 L`` plus one bf16 ulp
  per element (``L`` the summed learning rate: softmax ignores a
  per-query constant, so its gradient is rounding noise and Adam moves
  it by a full step either way); every leaf the reference moves moves;
  each step's eval agreement within 1e-2. Planted faults (an update
  lost, a stream started at step 0, step indices off by one) are run
  through the same checks and must fail them.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import common as jbench                       # noqa: E402
from repro.configs import get_reduced_config                  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig    # noqa: E402
from repro.launch.train import calibrate as jcalibrate        # noqa: E402
from repro.models import init_params as jinit                 # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch.benchmarks import common as tbench           # noqa: E402
from repro_torch.benchmarks import run as trun                # noqa: E402
from repro_torch.benchmarks.table2_time_to_quality import \
    selfgen_corpus                                            # noqa: E402
from repro_torch.configs import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.configs.base import TrainConfig              # noqa: E402
from repro_torch.serve import sampling                        # noqa: E402
from repro_torch.tree import tree_leaves                      # noqa: E402

LOSS_RTOL = 1e-4
KL_RTOL = 1e-2
AGREE_TOKENS = 4
CURVE_ATOL = 1e-2
SILQ_STEPS = 2
SILQ_POLICY = "A8d-C8-W4"
SILQ_LR = 1e-3
FIRST_STEP_LOSS_RTOL = 5e-6
STEP_LOSS_RTOL = 5e-5
MOVE_RTOL = 0.25          # L2 over all leaves but the key bias
LEAF_MOVE_RTOL = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _flat(params):
    return {k: v.detach().float() for k, v in bridge.flatten(params)}


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced_config("qwen2.5-3b")
    teacher = jinit(cfg, jax.random.PRNGKey(0))
    students = {}
    for pol in ("A8d-C8-W4", "A8s-C8-W4"):
        students[pol] = jcalibrate(cfg, jax.tree.map(jnp.copy, teacher),
                                   JTrainConfig(precision=pol),
                                   jbench.data_cfg(cfg))
    return cfg, t_reduced("qwen2.5-3b"), teacher, students


# --------------------------------------------------------------------------
# Table 2's sampling: jax.random.split and a single-key categorical
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 8, 24, 2 ** 31 + 5])
def test_split_bitwise_with_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = sampling.prng_key(seed)
    for _ in range(3):                 # the selfgen chain: key, k2 = split
        want = [tuple(int(x) for x in np.asarray(k))
                for k in jax.random.split(key)]
        got = sampling.split(tkey)
        assert got == want
        key, tkey = jax.random.split(key)[0], got[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(8, 256), (3, 1000)])
def test_key_categorical_bitwise_with_jax(dtype, shape):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(shape[1])
    for seed in (0, 8, 24):
        key = jax.random.split(jax.random.PRNGKey(seed))[1]
        tkey = sampling.split(sampling.prng_key(seed))[1]
        u = jax.random.uniform(key, shape, jdt, minval=jnp.finfo(jdt).tiny,
                               maxval=1.0)
        tu = sampling.key_uniform(tkey, shape, tdt)
        np.testing.assert_array_equal(
            np.asarray(u).astype(np.float32), tu.float().numpy())
        lg = (rng.standard_normal(shape) * 3).astype(np.float32)
        jl = jnp.asarray(lg).astype(jdt)
        want = np.asarray(jax.random.categorical(key, jl / 0.9))
        tl = torch.from_numpy(lg).to(tdt)
        got = sampling.key_categorical(tkey, tl / torch.tensor(0.9,
                                                               dtype=tdt))
        np.testing.assert_array_equal(got.numpy(), want)
        if dtype == "bfloat16":
            g = jax.random.gumbel(key, shape, jdt)
            tg = -torch.log(-torch.log(tu))
            np.testing.assert_array_equal(np.asarray(g).astype(np.float32),
                                          tg.float().numpy())


def test_selfgen_corpus_shape_and_determinism(setup):
    _, tcfg, teacher, _ = setup
    tp = _port(teacher)
    a, _ = selfgen_corpus(tcfg, tp, 10, 12)
    b, _ = selfgen_corpus(tcfg, tp, 10, 12)
    assert a.shape == (10, 12) and a.dtype == torch.int32
    assert torch.equal(a, b)
    assert bool((a[:, 0] == 1).all()) and 0 <= int(a.min()) and \
        int(a.max()) < tcfg.vocab_size


# --------------------------------------------------------------------------
# eval_quality and run_silq against the reference harness
# --------------------------------------------------------------------------

def _scored_tokens(cfg, n_batches):
    it = jbench.MixtureIterator(jbench.data_cfg(cfg, seed=777),
                                start_step=50_000_000)
    return [int((next(it)["loss_mask"] > 0).sum()) for _ in range(n_batches)]


@pytest.mark.parametrize("policy", ["A16-C16-W16", "A8d-C8-W4", "A8s-C8-W4"])
def test_eval_quality_matches_reference(setup, policy):
    cfg, tcfg, teacher, students = setup
    student = students.get(policy, teacher)
    want = jbench.eval_quality(cfg, student, teacher, policy, n_batches=2)
    got = tbench.eval_quality(tcfg, _port(student), _port(teacher), policy,
                              n_batches=2)
    assert got["ntp_loss"] == pytest.approx(want["ntp_loss"],
                                            rel=LOSS_RTOL)
    assert got["teacher_kl"] == pytest.approx(want["teacher_kl"],
                                              rel=KL_RTOL, abs=1e-12)
    n = min(_scored_tokens(cfg, 2))
    assert abs(got["teacher_agreement"] - want["teacher_agreement"]) \
        <= AGREE_TOKENS / n + 1e-7
    if policy == "A16-C16-W16":
        assert got["teacher_agreement"] == 1.0 and got["teacher_kl"] == 0.0


def test_eval_quality_plain_backend_is_the_cpu_path(setup):
    """On the CPU the kernels' plain versions run either way."""
    _, tcfg, teacher, students = setup
    tp, sp = _port(teacher), _port(students["A8d-C8-W4"])
    a = tbench.eval_quality(tcfg, sp, tp, "A8d-C8-W4", n_batches=1)
    b = tbench.eval_quality(tcfg, sp, tp, "A8d-C8-W4", n_batches=1,
                            kernel_backend="ref")
    assert a == b


def _silq_tcfg(cls):
    return cls(precision=SILQ_POLICY, total_steps=SILQ_STEPS,
               ref_steps=SILQ_STEPS, batch_size=8, seq_len=64,
               learning_rate=SILQ_LR)


def _record(log, i, loss, lr, batch):
    log.append({"step": int(i), "loss": float(loss), "lr": float(lr),
                **{k: np.asarray(v) for k, v in batch.items()}})


@pytest.fixture(scope="module")
def silq_ref(setup):
    """The reference's run_silq at 2 steps from the setup's calibrated
    student, with each step's index, loss, learning rate and batch."""
    cfg, _, teacher, students = setup
    log, seen = [], {}
    make = jbench.make_train_step

    def recording(cfg_, tcfg_):
        step_fn = make(cfg_, tcfg_)

        def step(params, teacher_, opt, batch, i):
            params, opt, m = step_fn(params, teacher_, opt, batch, i)
            jax.debug.callback(lambda *a: _record(log, *a[:3], a[3]),
                               i, m["loss"], m["lr"], batch)
            return params, opt, m
        return step

    def calibrated(cfg_, student, tcfg_, dc):
        seen["dc"] = dc
        return jax.tree.map(jnp.copy, students[SILQ_POLICY])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbench, "calibrate", calibrated)
        mp.setattr(jbench, "make_train_step", recording)
        js, curve, _ = jbench.run_silq(cfg, teacher, _silq_tcfg(JTrainConfig),
                                       eval_every=1)
    return {"dc": seen["dc"], "steps": log, "curve": curve,
            "params": _flat(_port(js)),
            "start": _flat(_port(students[SILQ_POLICY]))}


def _port_silq(setup, monkeypatch, fault=None):
    """The port's run_silq from the same calibrated student, recorded as
    ``silq_ref`` is; ``fault`` plants one of the faults the checks must
    see."""
    _, tcfg, teacher, students = setup
    log, seen = [], {}
    make, mixture = tbench.make_train_step, tbench.MixtureIterator

    def recording(cfg_, tcfg_):
        step_fn = make(cfg_, tcfg_)

        def step(params, teacher_, opt, batch, i):
            if fault == "step_index":
                i += 1
            keep = [p.detach().clone() for p in tree_leaves(params)]
            params, opt, m = step_fn(params, teacher_, opt, batch, i)
            if fault == "update_lost" and i == SILQ_STEPS - 1:
                with torch.no_grad():
                    for p, k in zip(tree_leaves(params), keep):
                        p.copy_(k)
            _record(log, i, m["loss"], m["lr"], batch)
            return params, opt, m
        return step

    def calibrated(cfg_, student, tcfg_, dc):
        seen["dc"] = dc
        return _port(students[SILQ_POLICY])

    monkeypatch.setattr(tbench, "calibrate", calibrated)
    monkeypatch.setattr(tbench, "make_train_step", recording)
    if fault == "start_step_0":
        monkeypatch.setattr(tbench, "MixtureIterator",
                            lambda dc, start_step: mixture(dc, start_step=0))
    tp = _port(teacher)
    ts, curve, secs = tbench.run_silq(tcfg, tp, _silq_tcfg(TrainConfig),
                                      eval_every=1 if fault is None else 0)
    return {"dc": seen["dc"], "steps": log, "curve": curve,
            "params": _flat(ts), "raw": dict(bridge.flatten(ts)),
            "secs": secs, "teacher": tp, "student": ts}


def _silq_failures(ref, got):
    """The names of the checks (see the module docstring) that ``got``
    fails against ``ref``."""
    fails = set()
    if dataclasses.asdict(got["dc"]) != dataclasses.asdict(ref["dc"]):
        fails.add("data_cfg")
    if [s["step"] for s in got["steps"]] != [s["step"] for s in ref["steps"]]:
        fails.add("step_index")
    for n, (a, b) in enumerate(zip(got["steps"], ref["steps"])):
        if any(not np.array_equal(a[k], b[k])
               for k in ("tokens", "labels", "loss_mask")):
            fails.add("batches")
        if a["lr"] != b["lr"]:
            fails.add("lr")
        rtol = FIRST_STEP_LOSS_RTOL if n == 0 else STEP_LOSS_RTOL
        if abs(a["loss"] - b["loss"]) > rtol * abs(b["loss"]):
            fails.add("loss")
    lr_sum = sum(s["lr"] for s in ref["steps"])
    num = den = 0.0
    for k, w in ref["params"].items():
        dj = w - ref["start"][k]
        dt = got["params"][k] - ref["start"][k]
        if bool(dj.any()) and not bool(dt.any()):
            fails.add("movement")
        if k.endswith("attn/wk/b"):
            ulp = 2.0 ** -8 * torch.maximum(w.abs(), got["params"][k].abs())
            if not bool(((dt - dj).abs() <= 2 * lr_sum + ulp).all()):
                fails.add("movement")
            continue
        e, m = float(torch.sum((dt - dj) ** 2)), float(torch.sum(dj ** 2))
        num, den = num + e, den + m
        if e ** 0.5 > LEAF_MOVE_RTOL * m ** 0.5:
            fails.add("movement")
    if num ** 0.5 > MOVE_RTOL * den ** 0.5:
        fails.add("movement")
    if [s for s, _ in got["curve"]] != [s for s, _ in ref["curve"]] or any(
            abs(a - b) > CURVE_ATOL
            for (_, a), (_, b) in zip(got["curve"], ref["curve"])):
        fails.add("curve")
    return fails


def test_run_silq_matches_reference(setup, silq_ref, monkeypatch):
    got = _port_silq(setup, monkeypatch)
    assert len(got["steps"]) == SILQ_STEPS and got["secs"] > 0
    assert got["params"].keys() == silq_ref["params"].keys()
    assert _silq_failures(silq_ref, got) == set()
    # the teacher is untouched and the student trains
    assert all(not t.requires_grad for t in tree_leaves(got["teacher"]))
    assert all(t.requires_grad for t in tree_leaves(got["student"]))


@pytest.mark.parametrize("fault, caught", [
    ("update_lost", {"movement"}),
    ("start_step_0", {"batches", "loss", "movement"}),
    ("step_index", {"step_index", "lr", "movement"}),
])
def test_run_silq_checks_catch_a_planted_fault(setup, silq_ref, monkeypatch,
                                               fault, caught):
    got = _port_silq(setup, monkeypatch, fault)
    # the curve is not taken here; everything else is checked
    fails = _silq_failures(silq_ref, {**got, "curve": silq_ref["curve"]})
    assert fails == caught


# --------------------------------------------------------------------------
# the teacher cache and every table at 2 teacher and 2 QAT steps
# --------------------------------------------------------------------------

def test_get_teacher_caches(tmp_path):
    cfg, a = tbench.get_teacher(steps=2, device="cpu",
                                cache_dir=str(tmp_path))
    assert (tmp_path / f"teacher_{cfg.name}_2").is_dir()
    cfg2, b = tbench.get_teacher(steps=2, device="cpu",
                                 cache_dir=str(tmp_path))
    assert cfg2 == cfg == t_reduced("qwen2.5-3b")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y) and not y.requires_grad


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_torch"))


@pytest.mark.parametrize("suite", sorted(trun.SUITES))
def test_suite_runs(suite, cache_dir, capsys):
    trun.main([suite, "--device", "cpu", "--teacher-steps", "2",
               "--qat-steps", "2", "--cache-dir", cache_dir])
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith(f"{suite}/")]
    assert rows and f"# {suite} done" in out
    for ln in rows:
        name, us, derived = ln.split(",", 2)
        assert int(us) >= 0 and "=" in derived


def test_cuda_limits_are_refused_up_front(setup, monkeypatch, tmp_path):
    """Nothing of the harness is refused up front on CUDA any more: flash
    takes the reduced config's head_dim 16 and the decode kernel a C16
    (bf16) cache. On a device patched to CUDA (this build has none) the
    teacher's pretraining and Table 2's self-generation both get past
    where they used to refuse, and stop only where this CPU-only torch
    touches the device."""
    from repro_torch.benchmarks import table2_time_to_quality as t2
    cuda = torch.device("cuda")
    monkeypatch.setattr(tbench, "resolve_device", lambda d: cuda)
    for call in (lambda: tbench.get_teacher(steps=2,
                                            cache_dir=str(tmp_path)),
                 lambda: selfgen_corpus(tcfg, _port(teacher), 8, 4)):
        _, tcfg, teacher, _ = setup
        monkeypatch.setattr(t2, "device_of", lambda p: cuda)
        with pytest.raises(Exception) as info:
            call()
        assert not isinstance(info.value, (ValueError, NotImplementedError))
        assert "head_dim" not in str(info.value)
        assert "int8" not in str(info.value)


def test_run_rejects_unknown_suite():
    with pytest.raises(SystemExit):
        trun.main(["roofline", "--device", "cpu"])
