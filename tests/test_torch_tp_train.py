"""Tensor-parallel QAT on the CPU: ``model`` ranks (and data replicas of
them) in processes of their own (``launch.mesh.spawn``, gloo, one torch
thread), each on its part of the student, the teacher and the optimizer
(``runtime.sharding.shard_train_state``), against the port's one-process
step on the same global batches.

One spawn a mesh runs every scenario of that mesh: reduced qwen2.5-3b (4
query / 2 KV heads of 16, d 64, d_ff 128, V 256) under A8d-C8-W4 and
A8s-C8-W4 in the attention modes ``""`` (model 2), ``kv_rep`` (model 4)
and a forced ``seq`` (both), the same config at 12 query / 3 KV heads
(``kv_rep`` with each rank's query heads straddling KV groups), reduced
qwen2-7b, qwen3-14b and qwen3-32b at model 2 in each mode, a clip that
binds, ``run_qat`` checkpoints across model sizes, and data 2 x model 2. This module imports no JAX: a spawned rank re-imports it.

Tolerances, with what was measured (worst over the cases):

* the global loss within ``2 x`` the witness's distance plus
  ``LOSS_RTOL`` (1e-6) of the one-process loss. The witness
  (:func:`witness_qlinear`) is the one-process step with the
  row-parallel linears' GEMMs (``wo`` outside ``seq``, ``wd``) as f32
  products rounded once, as the ranks' f32 partials are summed and
  rounded once. Measured: the loss is bitwise model 1's at model 2 and 4
  in every mode, and so is the witness's (the CPU's bf16 GEMM rounds its
  f32 sums once at these widths);
* every gradient leaf within ``TP_GRAD_RTOL`` (2^-6) of the leaf plus
  ``GRAD_ATOL_GLOBAL`` (1e-6) of the whole gradient (L2). The forward
  is bitwise; the backward sums the ranks' partial input gradients in
  f32 (``TPComm.copy_in``) where one process accumulates them in bf16,
  so a bf16 leaf moves by its ulps (measured 9.5e-3 on ``ln1``, 8.4e-3
  on the tied embedding, whose rows take every layer's residual
  gradient; the per-tensor scales' sums cancel to 1e-8 of the whole and
  take the absolute term). The key bias's true gradient is zero (softmax
  is invariant to a shift of the keys a query sees), so its computed
  one is the residue of a cancelling sum: ``TP_KEY_BIAS_RTOL`` (4e-2;
  measured 2.0e-2);
* the first step's loss within ``LOSS_RTOL``, the later steps' within
  ``LATER_LOSS_RTOL`` (1e-4; measured 3.3e-5 on reduced qwen2-7b: an
  element whose gradient sits at its rounding error takes Adam's first
  step of ``lr * sign(g)`` the other way on one side), the parameters
  after three steps within ``tests/test_torch_dp_train.py``'s movement
  bound (``UPD_RTOL`` of the movement, L2);
* replicated leaves bitwise across the model ranks and data replicas
  bitwise, after every step; ``gather_params`` of ``shard_params``
  bitwise the whole tree; column-parallel outputs, fake-quantized
  weight shards and integer codes bitwise model 1's slices of them.

Two checks are shown to catch the faults they guard against, as
``test_mean_of_means_is_caught`` does: a per-tensor LSQ scale whose
gradient is not summed over the model ranks, and ``grad_scale`` with a
rank's local element count.
"""
import hashlib

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import qat as tqat
from repro_torch.core.qat import ACT_SCALE_KEYS, make_ctx
from repro_torch.core.quantizer import quantize_to_int
from repro_torch.data import MixtureIterator, SyntheticConfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.launch.train import calibrate, run_qat
from repro_torch.models import blocks as tblocks
from repro_torch.models import init_params
from repro_torch.optim import adamw_init, clip_by_global_norm
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.collectives import TPComm
from repro_torch.tree import tree_leaves, tree_map

B, S, STEPS = 4, 16, 3
TIMEOUT_S = 150
LOSS_RTOL = 1e-6              # measured 0 (bitwise) at model 2 and 4
# the losses of steps 2-3: Adam's first step is lr * sign(g), so an
# element whose gradient sits at its rounding error moves the other way
# on one side (tests/test_torch_dp_train.py's reason; chip_smoke's 5d
# bound); measured 3.3e-5 on reduced qwen2-7b
LATER_LOSS_RTOL = 1e-4
WITNESS_MULT = 2.0
TP_GRAD_RTOL = 2.0 ** -6      # measured 9.5e-3 (ln1/w), 8.4e-3 (embed/w)
TP_KEY_BIAS_RTOL = 4e-2       # measured 2.0e-2
GRAD_ATOL_GLOBAL = 1e-6       # tests/test_torch_train.py
UPD_RTOL = 0.2                # tests/test_torch_train.py
CLIP = 1e-3                   # binds: the gradients' norm is ~5e-2
CLIP_NORM_RTOL = 1e-3         # measured 1.5e-4 (the leaves' own ulps)
POLICIES = ("A8d-C8-W4", "A8s-C8-W4")
ARCH = "qwen2.5-3b"
# the reduced config at 12 query / 3 KV heads: kv_rep at model 2 and 4,
# the ranks' query heads straddling KV groups (6 over KV 0-1 and 1-2 at
# model 2; 3 a rank over 0 / 0, 1 / 1, 2 / 2 at model 4)
STRADDLE = dict(n_heads=12, n_kv_heads=3, head_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# trees, digests, comparisons
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
    if isinstance(tree, dict):
        return {k: _unpack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unpack(v) for v in tree]
    return one(tree)


def _flat(tree, like=None):
    """{path: f32 numpy} of a tree; a None gradient as zeros."""
    if like is not None:
        tree = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                        tree, like)
    return {k: v.detach().float().numpy().copy()
            for k, v in bridge.flatten(tree)}


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


def _gap(got, want):
    """Worst leaf of ``|got - want| - rtol |want| - atol |want_total|``
    (L2 per leaf; the key bias at ``TP_KEY_BIAS_RTOL``): <= 0 inside the
    bound. Returns (excess, leaf)."""
    total = np.sqrt(sum(np.sum(v ** 2) for v in want.values()))
    worst = (-np.inf, "")
    for k in want:
        rtol = TP_KEY_BIAS_RTOL if k.endswith("attn/wk/b") else TP_GRAD_RTOL
        err = np.linalg.norm(got[k] - want[k])
        ex = err - rtol * np.linalg.norm(want[k]) - GRAD_ATOL_GLOBAL * total
        worst = max(worst, (ex, k))
    return worst


def _assert_moved_alike(got, want, before, lrs, bf16):
    """``tests/test_torch_dp_train.py``'s bound on the parameters'
    movement: every element within ``2 L`` (``L`` the most Adam moves
    it) plus a bf16 ulp, the whole within ``UPD_RTOL`` in L2."""
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


def witness_qlinear(trees, mode):
    """``models.blocks.qlinear`` for the witness: the row-parallel
    linears of ``trees`` (each layer's ``wd``, and ``wo`` but under
    ``seq``, where it runs whole on a rank's rows) as the f32 product of
    the quantized input and weight rounded once, as the ranks' partials
    are summed and rounded once; every other linear as it is."""
    rows = set()
    for t in trees:
        for layer in t["layers"]:
            rows.add(id(layer["mlp"]["wd"]))
            if mode != "seq":
                rows.add(id(layer["attn"]["wo"]))
    orig = tblocks.qlinear

    def qlinear(ctx, x, p, col=None, act_bits=None, weight_bits=None,
                row=False, shards=1):
        if id(p) not in rows:
            return orig(ctx, x, p, col, act_bits=act_bits,
                        weight_bits=weight_bits, row=row, shards=shards)
        xq = tqat.quantize_act(ctx, x, p, "s_in", col, bits=act_bits)
        wq = tqat.quantize_weight_p(ctx, p, bits=weight_bits)
        y = torch.matmul(xq.float(), wq.float()).to(xq.dtype)
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y
    return qlinear


def _train_cfg(policy, clip=None, steps=STEPS):
    kw = {} if clip is None else {"grad_clip": clip}
    return TrainConfig(precision=policy, total_steps=steps, ref_steps=steps,
                       batch_size=B, seq_len=S, **kw)


def _cfg(tree="base"):
    """A case's config: reduced qwen2.5-3b ("base"), the same at 12 / 3
    heads ("straddle"), or another arch's reduced config by name."""
    if tree in ("base", "straddle"):
        cfg = get_reduced_config(ARCH)
        return cfg.replace(**STRADDLE) if tree == "straddle" else cfg
    return get_reduced_config(tree)


def build(tree="base"):
    """The teacher from seed 0, each policy's calibrated student and
    STEPS global batches (numpy), as every process builds them."""
    torch.set_num_threads(1)
    cfg = _cfg(tree)
    teacher = init_params(cfg, seed=0, device="cpu")
    data = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                           batch_size=B, seed=0)
    students = {p: _pack(calibrate(cfg, tree_map(lambda t: t.clone(),
                                                 teacher),
                                   _train_cfg(p), data))
                for p in POLICIES}
    it = MixtureIterator(data, start_step=0)
    batches = [next(it) for _ in range(STEPS)]
    return {"teacher": _pack(teacher), "students": students,
            "batches": batches}


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# --------------------------------------------------------------------------
# one case, on a mesh or in one process
# --------------------------------------------------------------------------

def run_case(case, trees, mesh=None, witness=False):
    """One scenario: the loss and (gathered) gradients of batch 0, the
    model axis's census of that call, then STEPS steps (losses, the
    gathered parameters, each step's digests). ``case``: policy, mode
    (None: ``attn_shard_mode_for``), tree (:func:`_cfg`), clip, fault."""
    cfg = _cfg(case.get("tree", "base"))
    tc = _train_cfg(case["policy"], case.get("clip"))
    teacher = _unpack(trees["teacher"])
    student = _trainable(_unpack(trees["students"][case["policy"]]))
    batches = [_tbatch(b) for b in trees["batches"]]
    old = tblocks.qlinear
    if witness:
        tblocks.qlinear = witness_qlinear([teacher, student], case["mode"])
    try:
        step = tsteps.make_train_step(cfg, tc, mesh=mesh,
                                      attn_shard_mode=case.get("mode"))
        tp, dims = step.tp, None
        if mesh is not None:
            batches = [SH.shard_batch(b, mesh) for b in batches]
        if tp is not None:
            dims = SH.cut_dims(student, cfg, mesh, step.attn_mode)
            student = _trainable(SH.shard_params(student, cfg, mesh,
                                                 step.attn_mode))
            teacher = SH.shard_params(teacher, cfg, mesh, step.attn_mode)
        loss, grads = step.loss_and_grads(student, teacher, batches[0])
        grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None
                         else g, grads, student)
        out = {"loss": float(loss), "mode": step.attn_mode,
               "census": tp.counts() if tp is not None else None,
               "grads": _flat(grads if tp is None else
                              SH.gather_params(grads, dims, tp))}
        if case.get("clip"):
            clipped = tree_map(torch.clone, grads)
            kw = {} if tp is None else {
                "sharded": step.sharded_mask(student), "comm": tp}
            _, norm = clip_by_global_norm(clipped, case["clip"], **kw)
            out["clip_norm"] = float(norm)
            out["clipped"] = _flat(clipped if tp is None else
                                   SH.gather_params(clipped, dims, tp))
        if case.get("fault") or case.get("grads_only"):
            return out
        opt = adamw_init(student)
        losses, lrs, rep, whole = [], [], [], []
        cut = {k for k, d in (dims or {}).items() if d is not None}
        for i, b in enumerate(batches):
            student, opt, m = step(student, teacher, opt, b, i)
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
            named = bridge.flatten((student, opt.m, opt.v))
            # the leaves every model rank holds whole, and all of this
            # rank's state (the data replicas')
            rep.append(_digest([t for k, t in named
                                if k.split("/", 1)[1] not in cut]))
            whole.append(_digest([t for _, t in named]))
        if tp is not None:
            student = SH.gather_params(student, dims, tp)
        out.update(losses=losses, lrs=lrs, params=_flat(student),
                   rep_digests=rep, state_digests=whole,
                   bf16={k for k, v in bridge.flatten(student)
                         if v.dtype == torch.bfloat16})
        return out
    finally:
        tblocks.qlinear = old


def _fault(kind):
    """Patch in one of the faults the checks must catch; returns the
    undo."""
    if kind == "no_sum":
        orig = SH.partial_grad
        SH.partial_grad = lambda path, mode: (
            False if path.split("/")[-1] in ("s_in", "s_q", "s_k", "s_v")
            else orig(path, mode))
        return lambda: setattr(SH, "partial_grad", orig)
    from repro_torch.kernels.quant import ops
    orig = ops.grad_scale
    ops.grad_scale = lambda x, s, bits, replicas=1, shards=1: orig(
        x, s, bits, replicas)
    return lambda: setattr(ops, "grad_scale", orig)


def _gathered(obj):
    import torch.distributed as dist
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return objs


def rank_scenarios(mesh, inp):
    """Every scenario of one mesh on this rank; rank 0's results, with
    every rank's digests."""
    res = {}
    for key, case in inp["cases"].items():
        trees = inp["trees"][case.get("tree", "base")]
        undo = _fault(case["fault"]) if case.get("fault") else None
        try:
            out = run_case(case, trees, mesh)
        finally:
            if undo:
                undo()
        if "rep_digests" in out:
            out["ranks"] = _gathered({
                "model": mesh.rank, "data": mesh.data_rank,
                "rep": out["rep_digests"], "state": out["state_digests"]})
        res[key] = out
    if "roundtrip" in inp:
        res["roundtrip"] = roundtrip(mesh, inp["trees"]["base"])
    if "ckpt_from" in inp:
        res["ckpt_resumed"] = _run_qat(mesh, inp["ckpt_from"], resume=True)
    if "ckpt_to" in inp:
        res["ckpt_written"] = _run_qat(mesh, inp["ckpt_to"])
    return res


def roundtrip(mesh, trees):
    """``gather_params`` of ``shard_params`` against the whole tree, for
    each mode: the student and the optimizer's moments (made nonzero)."""
    cfg = _cfg()
    student = _unpack(trees["students"][POLICIES[0]])
    opt = adamw_init(student)
    for t in tree_leaves((opt.m, opt.v)):
        t.normal_(generator=torch.Generator().manual_seed(t.numel()))
    comm = TPComm(mesh)
    out = {}
    for mode in SH.TRAIN_MODES:
        dims = SH.cut_dims(student, cfg, mesh, mode)
        s, o = SH.shard_train_state(student, opt, cfg, mesh, mode)
        gs, go = SH.gather_train_state(s, o, dims, comm)
        out[mode] = (_digest(tree_leaves((gs, go.m, go.v)))
                     == _digest(tree_leaves((student, opt.m, opt.v))),
                     sum(d is not None for d in dims.values()))
    return out


def _run_qat(mesh, ckpt, resume=False):
    """``run_qat`` of reduced qwen2.5-3b (no teacher steps) with a
    checkpoint after step 2: every step's loss."""
    seen = {}
    run_qat(ARCH, _train_cfg(POLICIES[0]), reduced=True, teacher_steps=0,
            mesh=mesh, device="cpu", ckpt_dir=ckpt, ckpt_every=2,
            resume=resume, log_every=100,
            on_step=lambda i, m, s, o: seen.setdefault(i, float(m["loss"])))
    return seen


# --------------------------------------------------------------------------
# the fixtures: inputs, one process, the meshes
# --------------------------------------------------------------------------

M2_CASES = {
    "A8d": dict(policy=POLICIES[0], mode=None),
    "A8s": dict(policy=POLICIES[1], mode=None),
    "A8d_seq": dict(policy=POLICIES[0], mode="seq"),
    "straddle": dict(policy=POLICIES[0], mode=None, tree="straddle"),
    "clip": dict(policy=POLICIES[0], mode=None, clip=CLIP),
    "no_sum": dict(policy=POLICIES[1], mode=None, fault="no_sum"),
    "local_count": dict(policy=POLICIES[1], mode=None, fault="local_count"),
}
# the other dense decoders the slice trains at model > 1, each mode
DENSE = ("qwen2-7b", "qwen3-14b", "qwen3-32b")
M2_CASES.update({f"{a}/{m or 'auto'}": dict(policy=POLICIES[0], mode=m,
                                             tree=a)
                 for a in DENSE for m in (None, "kv_rep", "seq")})
M4_CASES = {
    "A8d": dict(policy=POLICIES[0], mode=None),
    "A8s": dict(policy=POLICIES[1], mode=None),
    "A8d_seq": dict(policy=POLICIES[0], mode="seq"),
    "A8s_seq": dict(policy=POLICIES[1], mode="seq"),
    "straddle": dict(policy=POLICIES[0], mode=None, tree="straddle"),
}
D2M2_CASES = {"A8d": dict(policy=POLICIES[0], mode=None)}
def _one_key(case):
    return (case["policy"], case["mode"], case.get("tree", "base"),
            case.get("clip"))


ONE_CASES = {_one_key(c) for cases in (M2_CASES, M4_CASES, D2M2_CASES)
             for c in cases.values()}


@pytest.fixture(scope="module")
def trees():
    return {t: build(t) for t in ("base", "straddle") + DENSE}


@pytest.fixture(scope="module")
def one_process(trees):
    """The one-process step of every case (the mode only names the
    witness's linears; one process runs no mode)."""
    out = {}
    for key in sorted(ONE_CASES, key=repr):
        policy, mode, tree, clip = key
        case = dict(policy=policy, mode=None, tree=tree, clip=clip)
        t = trees[tree]
        out[key] = run_case(case, t)
        out[key]["before"] = _flat(_unpack(t["students"][policy]))
        wit = run_case(dict(case, mode=mode or "", grads_only=True), t,
                       witness=True)
        out[key]["witness_loss"] = wit["loss"]
    return out


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_ckpt")
    return {"m2": str(root / "from_m2"), "m1": str(root / "from_m1")}


@pytest.fixture(scope="module")
def ckpt_m1(ckpt_dirs):
    """run_qat in one process writing the checkpoint model 2 resumes."""
    torch.set_num_threads(1)
    return _run_qat(None, ckpt_dirs["m1"])


@pytest.fixture(scope="module")
def m2(trees, ckpt_dirs, ckpt_m1):
    return spawn(rank_scenarios, 2, {
        "cases": M2_CASES, "trees": trees, "roundtrip": True,
        "ckpt_from": ckpt_dirs["m1"], "ckpt_to": ckpt_dirs["m2"]},
        model_parallel=2, device="cpu", backend="gloo",
        timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def m4(trees):
    return spawn(rank_scenarios, 4, {
        "cases": M4_CASES, "trees": trees, "roundtrip": True},
        model_parallel=4, device="cpu", backend="gloo",
        timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def d2m2(trees):
    return spawn(rank_scenarios, 4, {"cases": D2M2_CASES, "trees": trees},
                 model_parallel=2, device="cpu", backend="gloo",
                 timeout_s=TIMEOUT_S)


MESH_CASES = ([("m2", k) for k in M2_CASES
               if not M2_CASES[k].get("fault")]
              + [("m4", k) for k in M4_CASES] + [("d2m2", "A8d")])
_CASES = {"m2": M2_CASES, "m4": M4_CASES, "d2m2": D2M2_CASES}


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

class TestAgainstModelOne:
    @pytest.mark.parametrize("mesh,key", MESH_CASES)
    def test_loss_and_gradients(self, one_process, mesh, key, request):
        case = _CASES[mesh][key]
        got = request.getfixturevalue(mesh)[key]
        want = one_process[_one_key(case)]
        gap = (WITNESS_MULT * abs(want["witness_loss"] - want["loss"])
               + LOSS_RTOL * abs(want["loss"]))
        assert abs(got["loss"] - want["loss"]) <= gap
        assert got["grads"].keys() == want["grads"].keys()
        excess, leaf = _gap(got["grads"], want["grads"])
        assert excess <= 0, (leaf, excess)

    @pytest.mark.parametrize("mesh,key", MESH_CASES)
    def test_three_steps_and_bitwise_replicas(self, one_process, mesh, key,
                                              request):
        case = _CASES[mesh][key]
        got = request.getfixturevalue(mesh)[key]
        want = one_process[_one_key(case)]
        # replicated leaves: one digest a step over every rank; a data
        # replica's state: one digest a step over the ranks of each
        # model index
        for i in range(STEPS):
            assert len({r["rep"][i] for r in got["ranks"]}) == 1, i
            for mi in {r["model"] for r in got["ranks"]}:
                assert len({r["state"][i] for r in got["ranks"]
                            if r["model"] == mi}) == 1, (i, mi)
        np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LATER_LOSS_RTOL)
        assert got["lrs"] == want["lrs"]
        _assert_moved_alike(got["params"], want["params"], want["before"],
                            want["lrs"], want["bf16"])


def test_modes_picked_as_the_reference(m2, m4):
    """``attn_shard_mode_for``: "" where the KV heads divide the model
    axis, kv_rep where only the query heads do; a forced mode kept."""
    assert m2["A8d"]["mode"] == "" and m2["straddle"]["mode"] == "kv_rep"
    assert m4["A8d"]["mode"] == "kv_rep" and m4["A8d_seq"]["mode"] == "seq"
    assert m4["straddle"]["mode"] == "kv_rep"
    cfg = _cfg()
    assert [tsteps.attn_shard_mode_for(cfg, m) for m in (1, 2, 4, 8)] == [
        "", "", "kv_rep", "seq"]


@pytest.mark.parametrize("mesh,key", [("m2", "A8d"), ("m2", "A8s"),
                                      ("m4", "A8d"), ("m4", "A8d_seq")])
def test_collective_census(mesh, key, request):
    """One loss and backward's collectives a rank, by kind: per layer the
    forward's MAX of the row-parallel inputs (A8d; ``wo`` whole under
    ``seq``) and f32 SUMs of their partials (teacher and student), the
    backward's copy-in SUMs (attention and MLP inputs, the head) and,
    under ``kv_rep``, the K / V gathers' SUMs; the embedding's exact
    int32 SUM and the logits' gather (teacher and student), ``kv_rep``'s
    K / V gathers and ``seq``'s output gathers; one bucket of the
    partial leaves' SUM."""
    got = request.getfixturevalue(mesh)[key]
    mode, L = got["mode"], _cfg().n_layers
    rows = 1 if mode == "seq" else 2
    dyn = key.startswith("A8d")
    kv = 2 if mode == "kv_rep" else 0
    want = {"all_reduce_max": rows * L if dyn else 0,
            "all_reduce_sum": 2,
            "all_reduce_sum_f32": 2 * rows * L + (2 + kv) * L + 1 + 1,
            "all_gather": 2 + 2 * kv * L + (2 * L if mode == "seq" else 0)}
    assert {k: got["census"][k] for k in want} == want


class TestFaultsAreCaught:
    def test_unsummed_scale_gradient_is_caught(self, m2, one_process):
        """Without the SUM over the model ranks a per-tensor activation
        scale keeps one rank's part of its gradient: outside the bound
        the model-2 gradient meets."""
        want = one_process[_one_key(M2_CASES["A8s"])]
        assert _gap(m2["A8s"]["grads"], want["grads"])[0] <= 0
        excess, leaf = _gap(m2["no_sum"]["grads"], want["grads"])
        assert excess > 0 and leaf.split("/")[-1].startswith("s_"), leaf

    def test_local_element_count_is_caught(self, m2, one_process):
        """``grad_scale`` counting a rank's elements scales a sharded
        site's scale gradient by sqrt(2) at model 2: outside the bound."""
        want = one_process[_one_key(M2_CASES["A8s"])]
        excess, leaf = _gap(m2["local_count"]["grads"], want["grads"])
        assert excess > 0 and leaf.split("/")[-1].startswith("s_"), leaf


def test_clip_binds(one_process, m2):
    """The clip at a norm far below the gradients' (``CLIP``): at model 2
    the global norm (the shards' squares summed over the ranks, the
    whole leaves' counted once) is one process's within
    ``CLIP_NORM_RTOL`` (the gradients differ by their ulps), and the
    clipped gradients, whose norm is the clip's, are within the
    gradients' bound of one process's."""
    want = one_process[_one_key(M2_CASES["clip"])]
    got = m2["clip"]
    assert want["clip_norm"] > 10 * CLIP
    np.testing.assert_allclose(got["clip_norm"], want["clip_norm"],
                               rtol=CLIP_NORM_RTOL)
    norm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                       for v in got["clipped"].values()))
    np.testing.assert_allclose(norm, CLIP, rtol=1e-2)
    excess, leaf = _gap(got["clipped"], want["clipped"])
    assert excess <= 0, (leaf, excess)


@pytest.mark.parametrize("mesh", ["m2", "m4"])
def test_gather_of_shard_is_bitwise(mesh, request):
    got = request.getfixturevalue(mesh)["roundtrip"]
    for mode, (equal, n_cut) in got.items():
        assert equal, mode
        assert n_cut > 0, mode


class TestCheckpointAcrossModelSizes:
    def test_model_2_resumes_at_model_1(self, m2, ckpt_dirs):
        """A checkpoint written at model 2 (gathered, global rank 0)
        resumes in one process with model 2's next loss."""
        torch.set_num_threads(1)
        resumed = _run_qat(None, ckpt_dirs["m2"], resume=True)
        assert sorted(resumed) == [2]
        np.testing.assert_allclose(resumed[2], m2["ckpt_written"][2],
                                   rtol=LOSS_RTOL)

    def test_model_1_resumes_at_model_2(self, m2, ckpt_m1):
        assert sorted(m2["ckpt_resumed"]) == [2]
        np.testing.assert_allclose(m2["ckpt_resumed"][2], ckpt_m1[2],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("m,mode", [(2, ""), (4, "kv_rep"), (2, "seq"),
                                    (4, "seq")])
def test_column_outputs_weight_shards_and_codes_bitwise(trees, m, mode):
    """On each rank's slice (no collective needed): a column-parallel
    linear's output, every fake-quantized weight shard and its integer
    codes are bitwise model 1's columns or rows of them."""
    cfg = _cfg()
    whole = _unpack(trees["base"]["students"][POLICIES[0]])
    ctx = make_ctx(POLICIES[0])
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator(
        ).manual_seed(5)).to(torch.bfloat16)
    bits = ctx.policy.weight_bits
    for r in range(m):
        mesh = Mesh(shape={"data": 1, "model": m}, rank=r,
                    device=torch.device("cpu"))
        local = SH.shard_params(whole, cfg, mesh, mode)
        dims = SH.cut_dims(whole, cfg, mesh, mode)
        for i, (lw, ll) in enumerate(zip(whole["layers"],
                                         local["layers"])):
            for blk, name in (("attn", "wq"), ("attn", "wk"),
                              ("attn", "wv"), ("attn", "wo"),
                              ("mlp", "wg"), ("mlp", "wu"),
                              ("mlp", "wd")):
                pw, pl = lw[blk][name], ll[blk][name]
                d = dims[f"layers/{i}/{blk}/{name}/w"]
                n = pl["w"].shape[d] if d is not None else None

                def part(t, dim=d, n=n):
                    return t if dim is None else t.narrow(dim, r * n, n)

                qw = tqat.quantize_weight_p(ctx, pw)
                assert torch.equal(tqat.quantize_weight_p(ctx, pl),
                                   part(qw))
                s_w = pl["s_w"]
                assert torch.equal(quantize_to_int(pl["w"], s_w, bits),
                                   part(quantize_to_int(pw["w"],
                                                        pw["s_w"], bits)))
                if d == 1:         # column-parallel: the output's columns
                    y = tqat.qlinear(ctx, x, pl)
                    assert torch.equal(y, part(tqat.qlinear(ctx, x, pw),
                                               dim=2))


def test_refusals():
    """Training at model > 1 refuses the families whose sharded backward
    is not ported, naming their ROADMAP items, and widths the model axis
    does not divide."""
    tc = _train_cfg(POLICIES[0])
    mesh = Mesh(shape={"data": 1, "model": 2}, rank=0,
                device=torch.device("cpu"))
    for arch, item in (("mixtral-8x7b", "2b.5"), ("moonshot-v1-16b-a3b",
                                                   "2b.5"),
                       ("recurrentgemma-2b", "2b.6"), ("xlstm-125m", "2b.6"),
                       ("whisper-large-v3", "2b.7"), ("qwen2-vl-2b",
                                                      "2b.8")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tsteps.make_train_step(get_reduced_config(arch), tc, mesh=mesh)
    with pytest.raises(ValueError, match="divisible by 2"):
        tsteps.make_train_step(_cfg(), TrainConfig(
            precision=POLICIES[0], seq_len=15, batch_size=B), mesh=mesh,
            attn_shard_mode="seq")
    with pytest.raises(ValueError, match="attn_shard_mode"):
        tsteps.make_train_step(_cfg(), tc, mesh=mesh, attn_shard_mode="tp")


def rank_bridged(mesh, inp):
    """:func:`rank_scenarios` on trees in the JAX package's layout
    (numpy, bridged here: ``tests/test_torch_tp_train_jax.py``)."""
    def port(tree):
        return _pack(bridge.params_from_numpy(tree, "cpu"))
    trees = {"teacher": port(inp["teacher"]),
             "students": {p: port(t) for p, t in inp["students"].items()},
             "batches": inp["batches"]}
    return rank_scenarios(mesh, {"cases": inp["cases"],
                                 "trees": {"base": trees}})


@pytest.mark.parametrize("window", [0, 6])
def test_flash_plain_at_q_offset_is_the_whole_rows(window):
    """The flash kernel's plain version on a rank's query rows at
    ``q_offset`` (``seq``'s teacher) gives bitwise the whole sequence's
    rows, and so does the student's ``blockwise_attention`` at the same
    offset."""
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.models.common import blockwise_attention
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, S, h, 16), generator=g).to(torch.bfloat16)
               for h in (4, 2, 2))
    whole = flash_attn_ref(q, k, v, causal=True, window=window)
    for m in (2, 4):
        n = S // m
        for r in range(m):
            rows = q[:, r * n:(r + 1) * n]
            got = flash_attn_ref(rows, k, v, causal=True, window=window,
                                 q_offset=r * n)
            assert torch.equal(got, whole[:, r * n:(r + 1) * n])
            bw = blockwise_attention(rows, k, v, causal=True, window=window,
                                     q_chunk=n, q_offset=r * n)
            assert torch.equal(bw, got)
