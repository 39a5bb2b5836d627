"""Data-parallel QAT on the CPU: ``data`` ranks in processes of their own
(``launch.mesh.spawn``, gloo), each on its rows of the global batch,
against the port's one-process step and the JAX package's step on the
same global batch.

One spawn a mesh runs every scenario of that mesh (reduced qwen2.5-3b
under A8d-C8-W4 and A8s-C8-W4, the int8 sync, reduced mixtral, the
checkpointed ``run_qat``), each spawn with a timeout well inside the
suite's clock. Tolerances, with their reasons:

* the global loss within ``LOSS_RTOL`` (1e-6) of the one-process loss:
  the ranks' shares of the mean sum in another order than one mean;
* every gradient leaf within ``2^-7 |g_leaf| + GRAD_ATOL_GLOBAL |g|``
  (L2) of the one-process gradient: a bf16 leaf's shares are summed in
  f32 and rounded to bf16 once, where the one-process backward
  accumulates in its own order (one bf16 ulp a element at most,
  2^-7 relative); the absolute term is ``tests/test_torch_train.py``'s,
  for per-tensor scales whose gradient sums cancel;
* replicas: bitwise, every step (the f32 all-reduce gives every rank the
  same bits);
* against the JAX package's step (run op by op) the tolerances of
  ``tests/test_torch_train.py``, whose reasons hold here too;
* the parameters after three steps against the one-process port's
  within that file's movement bound (``UPD_RTOL`` of the movement in L2):
  Adam's first step is ``lr * sign(g)``, so a gradient element near zero
  that rounds to the other sign moves its parameter the other way.
"""
import hashlib
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import MixtureIterator as JMixture
from repro.data import SyntheticConfig as JSynth
from repro.launch import steps as jsteps
from repro.launch.train import calibrate as jcalibrate
from repro.models import init_params as jinit
from repro.optim import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core.qat import ACT_SCALE_KEYS
from repro_torch.data import MixtureIterator, SyntheticConfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import spawn
from repro_torch.launch.train import calibrate as tcalibrate
from repro_torch.launch.train import run_qat
from repro_torch.models import forward as tforward
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.runtime.fault import ElasticPlan
from repro_torch.runtime.sharding import shard_batch
from repro_torch.tree import tree_leaves, tree_map

B, S, STEPS = 4, 16, 3
TIMEOUT_S = 150
LOSS_RTOL = 1e-6
DP_GRAD_RTOL = 2.0 ** -7
GRAD_RTOL, GRAD_ATOL_GLOBAL = 2e-2, 1e-6       # tests/test_torch_train.py
UPD_RTOL = 0.2                                 # tests/test_torch_train.py
INT8_REL = 0.02                                # the reference's bound
POLICIES = ("A8d-C8-W4", "A8s-C8-W4")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# trees through pickling (bf16 as its bits) and comparisons
# --------------------------------------------------------------------------

def _pack(tree):
    return tree_map(lambda t: ("bf16", t.detach().view(torch.int16).numpy()
                               .copy()) if t.dtype == torch.bfloat16
                    else t.detach().numpy().copy(), tree)


def _unpack(tree):
    def one(x):
        if isinstance(x, tuple) and len(x) == 2 and x[0] == "bf16":
            return torch.from_numpy(x[1].copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return _tmap_packed(one, tree)


def _tmap_packed(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap_packed(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tmap_packed(fn, v) for v in tree]
    return fn(tree)


def _flat(tree, like=None):
    """{path: f32 numpy} of a port tree; a None gradient as zeros."""
    if like is not None:
        tree = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                        tree, like)
    return {k: v.detach().float().numpy().copy()
            for k, v in bridge.flatten(tree)}


def _flat_ref(tree):
    """``_flat`` of a JAX tree, in the port's per-layer layout."""
    return _flat(bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                          "cpu"))


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _trainable(tree):
    for p in tree_leaves(tree):
        p.requires_grad_(True)
    return tree


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _gap(got, want):
    """Worst leaf of ``|got - want| - 2^-7 |want| - atol |want_total|``
    (L2 per leaf): <= 0 inside the bound. Returns (excess, leaf)."""
    total = np.sqrt(sum(np.sum(v ** 2) for v in want.values()))
    worst = (-np.inf, "")
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        ex = err - DP_GRAD_RTOL * np.linalg.norm(want[k]) \
            - GRAD_ATOL_GLOBAL * total
        worst = max(worst, (ex, k))
    return worst


def _assert_moved_alike(got, want, before, lrs, bf16):
    """The parameters' movement (after minus before) against ``want``'s.
    With ``L = sum(lr) * lr_mult`` the most Adam moves an element, every
    element within ``2 L`` plus a bf16 ulp of the value on a bf16 leaf:
    both runs stay inside Adam's range, where an element whose gradient
    sits at its rounding error moves by ``lr * sign(g)`` of either sign,
    and a bf16 weight moves by whole ulps where the step crosses a
    rounding boundary in one run only. Over the whole tree the movement
    is within ``UPD_RTOL`` of ``want``'s in L2 (a flipped update reads 2,
    a lost 50x act-scale boost about 1)."""
    num = den = 0.0
    for k in want:
        mult = 50.0 if k.split("/")[-1] in ACT_SCALE_KEYS else 1.0
        L = sum(lrs) * mult
        dj, dt = want[k] - before[k], got[k] - before[k]
        ulp = 0.0
        if k in bf16:
            ulp = np.spacing(np.maximum(np.abs(want[k]), np.abs(
                got[k])).astype(ml_dtypes.bfloat16)).astype(np.float32)
        assert np.all(np.abs(dt - dj) <= 2 * L + ulp), k
        num += float(np.sum((dt - dj).astype(np.float64) ** 2))
        den += float(np.sum(dj.astype(np.float64) ** 2))
    assert den > 0 and np.sqrt(num / den) <= UPD_RTOL, np.sqrt(num / den)


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _gathered(obj):
    import torch.distributed as dist
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return objs


def _train_cfg(policy, comp="none", batch=B):
    return TrainConfig(precision=policy, total_steps=STEPS,
                       ref_steps=STEPS, batch_size=batch, seq_len=S,
                       grad_compression=comp)


def _run_steps(cfg, tt, student, teacher, batches, mesh):
    """(loss and synced gradients of batch 0, the losses of the steps,
    the final student, every step's digest of params and moments)."""
    step = tsteps.make_train_step(cfg, tt, mesh=mesh)
    loss, grads = step.loss_and_grads(student, teacher, batches[0])
    out = {"loss": float(loss), "grads": _flat(grads, student)}
    step.reset_error_feedback()
    opt = adamw_init(student)
    losses, lrs, digests = [], [], []
    for i, b in enumerate(batches):
        student, opt, m = step(student, teacher, opt, b, i)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        digests.append(_digest(tree_leaves((student, opt.m, opt.v))))
    out.update(losses=losses, lrs=lrs, params=_flat(student),
               digests=digests,
               bf16={k for k, v in bridge.flatten(student)
                     if v.dtype == torch.bfloat16})
    return out, step


def rank_scenarios(mesh, inp):
    """Every scenario of one mesh on this rank; rank 0's result, with
    whether every rank held the same bits after every step."""
    res = {}
    cfg = t_reduced("qwen2.5-3b")
    teacher = bridge.params_from_numpy(inp["teacher"], "cpu")
    batches = [_tbatch(shard_batch(b, mesh)) for b in inp["batches"]]
    for policy in inp["policies"]:
        student = _trainable(bridge.params_from_numpy(
            inp["students"][policy], "cpu"))
        out, _ = _run_steps(cfg, _train_cfg(policy), student, teacher,
                            batches, mesh)
        out["replicas_equal"] = len({repr(d) for d in _gathered(
            out["digests"])}) == 1
        res[policy] = out
    if "int8" in inp:
        policy = POLICIES[0]
        student = _trainable(bridge.params_from_numpy(
            inp["students"][policy], "cpu"))
        exact = tsteps.make_train_step(cfg, _train_cfg(policy), mesh=mesh)
        _, g_exact = exact.loss_and_grads(student, teacher, batches[0])
        step = tsteps.make_train_step(cfg, _train_cfg(policy, "int8"),
                                      mesh=mesh)
        _, g_local = step.local_loss_and_grads(student, teacher,
                                               batches[0])
        # each leaf's amax over the ranks of what the sync quantizes: the
        # local gradient times the data size
        n = int(mesh.shape["data"])
        amax = torch.stack([torch.max(torch.abs(g.float() * n))
                            if g is not None else torch.zeros(())
                            for g in tree_leaves(g_local)])
        import torch.distributed as dist
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=mesh.data_group)
        g_q = step.sync(g_local)
        err = step.error_feedback()
        amax = amax.tolist()
        res["int8"] = {"exact": _flat(g_exact, student),
                       "int8": _flat(g_q, student),
                       "bf16": {k for k, v in bridge.flatten(student)
                                if v.dtype == torch.bfloat16},
                       "err_max": [0.0 if e is None else float(
                           torch.max(torch.abs(e))) for e in err],
                       "amax": amax,
                       "wire": dict(step.dp.wire),
                       "wire_exact": dict(exact.dp.wire)}
        step.reset_error_feedback()
        opt = adamw_init(student)
        digests = []
        for i, b in enumerate(batches[:2]):
            student, opt, _ = step(student, teacher, opt, b, i)
            digests.append(_digest(tree_leaves((student, opt.m, opt.v))))
        res["int8"]["replicas_equal"] = len({repr(d) for d in _gathered(
            digests)}) == 1
    if "moe" in inp:
        mcfg, tree_t, tree_s, mbatches = moe_setup(inp["moe"])
        teacher_m = _unpack(tree_t)
        student_m = _trainable(_unpack(tree_s))
        mb = [_tbatch(shard_batch(b, mesh)) for b in mbatches]
        step = tsteps.make_train_step(mcfg, _train_cfg(POLICIES[0]),
                                      mesh=mesh)
        from repro_torch.core.qat import make_ctx
        with torch.no_grad():
            _, aux = tforward(mcfg, student_m, make_ctx(
                POLICIES[0], dp=step.dp), mb[0])
        out, _ = _run_steps(mcfg, _train_cfg(POLICIES[0]), student_m,
                            teacher_m, mb, mesh)
        out["aux"] = float(aux["moe_aux"])
        out["replicas_equal"] = len({repr(d) for d in _gathered(
            out["digests"])}) == 1
        res["moe"] = out
    if "pretrain" in inp:
        res["teacher"] = teacher_steps(mesh, inp["batches"])
        res["teacher"]["replicas_equal"] = len({repr(d) for d in _gathered(
            res["teacher"]["digests"])}) == 1
    if "ckpt" in inp:
        seen = {}
        _, student, _ = run_qat(
            "qwen2.5-3b", _train_cfg(POLICIES[0]), reduced=True,
            teacher_steps=0, mesh=mesh, ckpt_dir=inp["ckpt"],
            ckpt_every=2, log_every=100,
            heartbeat_dir=inp["ckpt"] + "_hb",
            on_step=lambda i, m, s, o: seen.setdefault(i, (
                float(m["loss"]), _flat(s) if i == 1 else None)))
        res["ckpt"] = {"losses": [seen[i][0] for i in range(STEPS)],
                       "after_1": seen[1][1], "params": _flat(student),
                       "bf16": {k for k, v in bridge.flatten(student)
                                if v.dtype == torch.bfloat16}}
    return res


def teacher_steps(mesh, batches):
    """Two steps of the teacher's next-token pretraining from the seed
    (``make_teacher_pretrain_step``; lr 1e-3): losses, the parameters and
    every step's digest of parameters and moments."""
    from repro_torch.launch.train import make_teacher_pretrain_step
    cfg = t_reduced("qwen2.5-3b")
    params = _trainable(init_params(cfg, seed=0, device="cpu"))
    before = _flat(params)
    opt = adamw_init(params)
    step = make_teacher_pretrain_step(cfg, mesh=mesh)
    losses, digests = [], []
    for b in batches[:2]:
        tb = _tbatch(b if mesh is None else shard_batch(b, mesh))
        params, opt, loss = step(params, opt, tb)
        losses.append(float(loss))
        digests.append(_digest(tree_leaves((params, opt.m, opt.v))))
    return {"losses": losses, "params": _flat(params), "before": before,
            "digests": digests,
            "bf16": {k for k, v in bridge.flatten(params)
                     if v.dtype == torch.bfloat16}}


def fail_rank(mesh, ckpt):
    """Data rank 1 stops at step 1 (``SystemExit(42)``); rank 0 goes on
    into the next step's all-reduce and blocks there."""
    run_qat("qwen2.5-3b", _train_cfg(POLICIES[0]), reduced=True,
            teacher_steps=0, mesh=mesh, log_every=100,
            simulate_failure_at=1 if mesh.data_rank == 1 else -1)
    time.sleep(600)


# --------------------------------------------------------------------------
# the inputs and the one-process runs
# --------------------------------------------------------------------------

def moe_setup(seed):
    """Reduced mixtral: the teacher from ``seed``, the student its
    calibrated copy, and STEPS global batches (numpy), all built alike
    in every process (one thread, the same CPU ops)."""
    torch.set_num_threads(1)
    cfg = t_reduced("mixtral-8x7b")
    teacher = init_params(cfg, seed=seed, device="cpu")
    data = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                           batch_size=B, seed=seed)
    student = tcalibrate(cfg, tree_map(lambda t: t.clone(), teacher),
                         _train_cfg(POLICIES[0]), data)
    it = MixtureIterator(data, start_step=1)
    batches = [next(it) for _ in range(STEPS)]
    return cfg, _pack(teacher), _pack(student), batches


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced_config("qwen2.5-3b")
    teacher = jinit(cfg, jax.random.PRNGKey(0))
    data = JSynth(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                  seed=0)
    students = {}
    for pol in POLICIES:
        jt = JTrainConfig(precision=pol, total_steps=STEPS,
                          ref_steps=STEPS, batch_size=B, seq_len=S)
        students[pol] = jcalibrate(cfg, teacher, jt, data)   # compiled
    # from step 0: the first batch's halves hold 20 and 32 masked tokens
    it = JMixture(data, start_step=0)
    batches = [next(it) for _ in range(STEPS)]
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"cfg": cfg, "teacher": teacher, "students": students,
            "batches": batches,
            "inp": {"teacher": np_tree(teacher),
                    "students": {p: np_tree(s) for p, s in
                                 students.items()},
                    "batches": batches}}


@pytest.fixture(scope="module")
def one_process(setup):
    """The port's one-process step on the global batches, each policy."""
    cfg = t_reduced("qwen2.5-3b")
    teacher = bridge.params_from_numpy(setup["inp"]["teacher"], "cpu")
    batches = [_tbatch(b) for b in setup["batches"]]
    out = {}
    for pol in POLICIES:
        student = _trainable(bridge.params_from_numpy(
            setup["inp"]["students"][pol], "cpu"))
        out[pol], _ = _run_steps(cfg, _train_cfg(pol), student, teacher,
                                 batches, None)
        out[pol]["before"] = _flat(bridge.params_from_numpy(
            setup["inp"]["students"][pol], "cpu"))
    return out


@pytest.fixture(scope="module")
def moe_one_process():
    cfg, tree_t, tree_s, batches = moe_setup(3)
    student = _trainable(_unpack(tree_s))
    step = tsteps.make_train_step(cfg, _train_cfg(POLICIES[0]))
    from repro_torch.core.qat import make_ctx
    tb = [_tbatch(b) for b in batches]
    with torch.no_grad():
        _, aux = tforward(cfg, student, make_ctx(POLICIES[0]), tb[0])
    out, _ = _run_steps(cfg, _train_cfg(POLICIES[0]), student,
                        _unpack(tree_t), tb, None)
    out["aux"] = float(aux["moe_aux"])
    out["before"] = _flat(_unpack(tree_s))
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dp_ckpt") / "ck")


@pytest.fixture(scope="module")
def data2(setup, ckpt_dir):
    inp = dict(setup["inp"], policies=POLICIES, int8=True, moe=3,
               pretrain=True, ckpt=ckpt_dir)
    return spawn(rank_scenarios, 2, inp, device="cpu", backend="gloo",
                 timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def data4(setup):
    inp = dict(setup["inp"], policies=POLICIES[:1])
    return spawn(rank_scenarios, 4, inp, device="cpu", backend="gloo",
                 timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX package's step on the global batches, op by op: the first
    batch's loss and gradients, then three steps."""
    cfg, teacher = setup["cfg"], setup["teacher"]
    student = setup["students"][POLICIES[0]]
    jt = JTrainConfig(precision=POLICIES[0], total_steps=STEPS,
                      ref_steps=STEPS, batch_size=B, seq_len=S)
    jstep = jsteps.make_train_step(cfg, jt)
    jb = [{k: jnp.asarray(v) for k, v in b.items()}
          for b in setup["batches"]]
    from repro.core import distill as jdistill
    from repro.core import qat as jqat
    from repro.models import forward as jforward
    with jax.disable_jit():
        t_logits, _ = jforward(cfg, teacher, jqat.make_ctx(
            "A16-C16-W16", mode="off"), jb[0])

        def loss_fn(p):
            logits, _ = jforward(cfg, p, jqat.make_ctx(POLICIES[0]), jb[0])
            return jdistill.silq_loss(logits, t_logits, jb[0]["labels"],
                                      mask=jb[0]["loss_mask"])

        jl, jg = jax.value_and_grad(loss_fn)(student)
        p, opt, losses, lrs = student, jadamw_init(student), [], []
        for i, b in enumerate(jb):
            p, opt, m = jstep(p, teacher, opt, b, jnp.int32(i))
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
    return {"loss": float(jl), "grads": _flat_ref(jg), "losses": losses,
            "lrs": lrs, "params": _flat_ref(p),
            "before": _flat_ref(student)}


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

class TestAgainstOneProcess:
    @pytest.mark.parametrize("mesh,policy", [("data2", POLICIES[0]),
                                             ("data2", POLICIES[1]),
                                             ("data4", POLICIES[0])])
    def test_loss_and_gradients(self, one_process, mesh, policy, request):
        got = request.getfixturevalue(mesh)[policy]
        want = one_process[policy]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        assert got["grads"].keys() == want["grads"].keys()
        excess, leaf = _gap(got["grads"], want["grads"])
        assert excess <= 0, (leaf, excess)

    @pytest.mark.parametrize("mesh,policy", [("data2", POLICIES[0]),
                                             ("data2", POLICIES[1]),
                                             ("data4", POLICIES[0])])
    def test_three_steps_and_bitwise_replicas(self, one_process, mesh,
                                              policy, request):
        got = request.getfixturevalue(mesh)[policy]
        want = one_process[policy]
        assert got["replicas_equal"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5)
        assert got["lrs"] == want["lrs"]
        _assert_moved_alike(got["params"], want["params"], want["before"],
                            want["lrs"], want["bf16"])

    def test_mean_of_means_is_caught(self, setup, one_process):
        """The first batch's halves hold 20 and 32 masked tokens, so the
        mean of the two halves' own masked means (what two ranks without
        the global denominator would report and train on) is not the
        global batch's: its loss lies outside ``LOSS_RTOL`` and its
        gradient outside the bound the data-2 gradient meets, by more
        than 10x on its worst leaf. (On this random-init teacher the
        per-token KD losses are near uniform, so the loss moves only 6x
        its tolerance; the tokens' weights, 1/40 against 1/52 a token,
        show in the gradient: 0.34 relative on its worst leaf.)"""
        b = setup["batches"][0]
        halves = [{k: v[i * B // 2:(i + 1) * B // 2] for k, v in b.items()}
                  for i in range(2)]
        counts = [int(h["loss_mask"].sum()) for h in halves]
        assert counts[0] != counts[1], counts
        cfg = t_reduced("qwen2.5-3b")
        teacher = bridge.params_from_numpy(setup["inp"]["teacher"], "cpu")
        student = _trainable(bridge.params_from_numpy(
            setup["inp"]["students"][POLICIES[0]], "cpu"))
        step = tsteps.make_train_step(cfg, _train_cfg(POLICIES[0]))
        local = [step.loss_and_grads(student, teacher, _tbatch(h))
                 for h in halves]
        mom = sum(float(loss) for loss, _ in local) / 2
        flat = [_flat(g, student) for _, g in local]
        g_mom = {k: (flat[0][k] + flat[1][k]) / 2 for k in flat[0]}
        want = one_process[POLICIES[0]]
        assert abs(mom - want["loss"]) > LOSS_RTOL * abs(want["loss"])
        assert _gap(g_mom, want["grads"])[0] > 0
        worst = max(np.linalg.norm(g_mom[k] - v) / np.linalg.norm(v)
                    for k, v in want["grads"].items()
                    if np.linalg.norm(v) > 0)
        assert worst > 10 * DP_GRAD_RTOL, worst

    def test_batch_the_data_axis_does_not_divide(self, setup):
        from repro_torch.launch.mesh import Mesh
        mesh = Mesh(shape={"data": 3, "model": 1}, rank=0,
                    device=torch.device("cpu"), data_rank=1)
        with pytest.raises(NotImplementedError, match="Queue 1 item 2b"):
            shard_batch(setup["batches"][0], mesh)


def test_teacher_pretraining_at_data_2(setup, data2):
    """The teacher's pretraining step on the data axis: the first global
    next-token loss within ``LOSS_RTOL`` of one process on the same
    batch, replicas bitwise, the parameters moved alike (lr 1e-3). The
    second loss within 1e-4: Adam's first step is ``lr * sign(g)``, so an
    element whose gradient sits at its rounding error lands 2e-3 from
    the one-process element (observed 5.0e-5)."""
    want = teacher_steps(None, setup["batches"])
    got = data2["teacher"]
    assert got["replicas_equal"]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][1], want["losses"][1],
                               rtol=1e-4)
    _assert_moved_alike(got["params"], want["params"], want["before"],
                        [1e-3, 1e-3], want["bf16"])


class TestAgainstJax:
    @pytest.mark.parametrize("mesh", ["data2", "data4"])
    def test_step_matches_op_by_op_reference(self, jax_steps, mesh,
                                             request):
        got = request.getfixturevalue(mesh)[POLICIES[0]]
        np.testing.assert_allclose(got["loss"], jax_steps["loss"],
                                   rtol=LOSS_RTOL)
        gw, gt = jax_steps["grads"], got["grads"]
        assert gw.keys() == gt.keys()
        total = np.sqrt(sum(np.sum(v ** 2) for v in gw.values()))
        for k in gw:
            err = np.linalg.norm(gt[k] - gw[k])
            assert err <= GRAD_RTOL * np.linalg.norm(gw[k]) + \
                GRAD_ATOL_GLOBAL * total, (k, err)
        np.testing.assert_allclose(got["losses"][0], jax_steps["losses"][0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], jax_steps["losses"],
                                   rtol=1e-5)
        assert got["lrs"] == jax_steps["lrs"]
        _assert_moved_alike(got["params"], jax_steps["params"],
                            jax_steps["before"], jax_steps["lrs"],
                            got["bf16"])


class TestInt8Sync:
    def test_each_element_within_half_a_step_of_the_exact_sync(self,
                                                                data2):
        """The int8 sync against the exact one on the model's gradient:
        with no residual yet, every element of the mean of the ranks'
        dequantized payloads lies within half a quantization step
        (``amax / 254``) of the exact sum, plus a bf16 ulp of the value
        for the cast each side makes; the residual is below the leaf's
        amax / 100, the reference's bound; the replicas stay bitwise
        equal over two int8 steps. (The reference's 2% relative L2 holds
        for its Gaussian gradient, ``tests/test_torch_compression.py``; a
        model's gradient, with its outliers, is further off: 5.1% over
        reduced qwen2.5-3b's leaves.)"""
        got = data2["int8"]
        ex, q = got["exact"], got["int8"]
        for (k, e), a, r in zip(ex.items(), got["amax"], got["err_max"]):
            ulp = np.spacing(np.maximum(np.abs(e), np.abs(q[k])).astype(
                ml_dtypes.bfloat16)).astype(np.float32) \
                if k in got["bf16"] else np.spacing(np.abs(e))
            assert np.all(np.abs(q[k] - e) <= a / 254.0 * (1 + 1e-6)
                          + ulp), k
            assert r <= a / 100.0, (k, r, a)
        assert got["replicas_equal"]

    def test_wire_bytes(self, data2):
        """int8 payloads put about a quarter of the f32 ring's bytes on
        the wire at two ranks."""
        got = data2["int8"]
        assert 0 < got["wire"]["int8"] < 0.3 * got["wire_exact"]["f32"]


class TestMoE:
    def test_global_aux_and_gradients(self, data2, moe_one_process):
        got, want = data2["moe"], moe_one_process
        assert want["aux"] > 0
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        excess, leaf = _gap(got["grads"], want["grads"])
        assert excess <= 0, (leaf, excess)
        assert got["replicas_equal"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5)


class TestRestoreAndFailure:
    def test_data2_checkpoint_resumes_at_data1(self, data2, ckpt_dir):
        """The data-2 run's step-2 checkpoint restores in one process
        (ElasticPlan's shrink of a data-2 mesh to one worker), and the
        resumed step matches the uninterrupted data-2 run's step 2."""
        assert ElasticPlan(data_axis=2, model_axis=1).shrink_for(1) == (1, 1)
        got = data2["ckpt"]
        seen = {}
        _, student, _ = run_qat(
            "qwen2.5-3b", _train_cfg(POLICIES[0]), reduced=True,
            teacher_steps=0, device="cpu", ckpt_dir=ckpt_dir, resume=True,
            log_every=100,
            on_step=lambda i, m, s, o: seen.setdefault(i, (
                float(m["loss"]), float(m["lr"]))))
        assert sorted(seen) == [2]
        lrs = {2: seen[2][1]}
        np.testing.assert_allclose(seen[2][0], got["losses"][2],
                                   rtol=LOSS_RTOL)
        _assert_moved_alike(_flat(student), got["params"], got["after_1"],
                            [lrs[2]], got["bf16"])
        beats = sorted(os.listdir(ckpt_dir + "_hb"))
        assert beats == ["hb_00000.json", "hb_00001.json"], beats

    def test_a_rank_that_exits_fails_the_launch_fast(self):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="exit code 42"):
            spawn(fail_rank, 2, None, device="cpu", backend="gloo",
                  timeout_s=TIMEOUT_S)
        assert time.monotonic() - t0 < 60


def mesh_axes(mesh):
    """Each axis's members as seen by a SUM over it of the global ranks."""
    import torch.distributed as dist
    me = torch.tensor([float(dist.get_rank())])
    out = {"rank": dist.get_rank(), "model_rank": mesh.rank,
           "data_rank": mesh.data_rank, "shape": dict(mesh.shape)}
    for axis, group in (("model", mesh.group), ("data", mesh.data_group)):
        t = me.clone()
        dist.all_reduce(t, group=group)
        out[axis] = float(t)
    return _gathered(out)


def test_mesh_at_data_2_model_2():
    """Four ranks as two data replicas of two model ranks: global rank
    d * 2 + m, each axis's group holding its row or column."""
    got = spawn(mesh_axes, 4, model_parallel=2, device="cpu",
                backend="gloo", timeout_s=TIMEOUT_S)
    for r in got:
        d, m = divmod(r["rank"], 2)
        assert (r["data_rank"], r["model_rank"]) == (d, m)
        assert r["shape"] == {"data": 2, "model": 2}
        assert r["model"] == 2 * d + (2 * d + 1)
        assert r["data"] == m + (2 + m)


def test_data_axis_refusals():
    from repro_torch.launch.mesh import Mesh
    cfg = t_reduced("qwen2.5-3b")
    mesh = Mesh(shape={"data": 2, "model": 2}, rank=0,
                device=torch.device("cpu"))
    # the dense decoders train at model > 1 (tests/test_torch_tp_train.py);
    # an MoE's sharded backward is not ported
    with pytest.raises(NotImplementedError, match="model > 1"):
        tsteps.make_train_step(t_reduced("mixtral-8x7b"),
                               _train_cfg(POLICIES[0]), mesh=mesh)
    with pytest.raises(ValueError, match="grad_compression"):
        tsteps.make_train_step(cfg, _train_cfg(POLICIES[0], "fp8"))
