"""Tensor-parallel serving of the port on the CPU: ``tp`` ranks in
processes of their own (``launch.mesh.spawn_tp``, gloo) against the
port's tp=1 engine and the JAX package's tp=1 engine.

The reference's ``tests/test_sharded_serve.py`` on the port: its
``ENG_KW``, ``PREEMPT_KW`` and ``_mixed_reqs`` on reduced qwen2.5-3b with
``n_kv_heads=4`` at tp 2 and 4 and with ``n_kv_heads=2`` at tp 2 (one KV
head and its 2 query heads a rank: the grouped case) and at tp 4 (more
ranks than KV heads: each rank one query head and the whole KV head it
reads, every KV head on two ranks). One spawn per
module-scoped fixture runs every scenario of its mesh, each spawn with a
timeout well inside the suite's clock, so a deadlock fails one test.

Tolerance: none. Streams (greedy and sampled), spec accept counts,
preemption counts and one decode step's gathered logits are bitwise
tp=1's: the row-parallel linears all-reduce exact int32 accumulators
and the whole row's amax, attention is head-local, and the embedding's
masked sum and the logits' gather move bits, never round them. Against
the JAX package the tp=1 streams are held to its engine run op by op
(``jax.disable_jit``), as ``test_torch_engine.py`` holds them: the
compiled reference flips greedy near-ties
(``test_torch_tp_serve_jax.py``).
"""
import time

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import spawn_tp
from repro_torch.runtime.sharding import shard_params
from repro_torch.models import clone_cache, decode_step
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig

POLICY = "A8d-C8-W4"
TIMEOUT_S = 120

ENG_KW = dict(policy=POLICY, slots=4, cache_len=128, max_new_cap=32,
              decode_block=4, prefill_bucket=16, kv_layout="paged",
              block_size=16, weights_layout="w4a8")
PREEMPT_KW = dict(policy=POLICY, slots=4, cache_len=128, max_new_cap=32,
                  decode_block=4, prefill_bucket=16, kv_layout="paged",
                  block_size=8, num_blocks=20, admission="optimistic",
                  preempt="last_admitted", weights_layout="w4a8")
SPEC = dict(k=3, draft_layers=1, accept_mode="exact")


def _mixed_reqs(cfg, n=6, max_new=16, cls=Request, **kw):
    r = np.random.default_rng(7)
    return [cls(uid=i,
                prompt=r.integers(1, cfg.vocab_size,
                                  int(r.integers(5, 30))).astype(np.int32),
                max_new_tokens=max_new, eos_id=-1,
                temperature=0.0 if i % 2 == 0 else 0.8,
                top_k=0 if i % 3 == 0 else 8, seed=100 + i, **kw)
            for i in range(n)]


def _small_reqs(cfg, cls=Request):
    """The JAX comparison's workload: op by op, the reference engine
    takes seconds a decode step, so fewer and shorter requests."""
    return _mixed_reqs(cfg, n=4, max_new=6, cls=cls)


def _prefix_reqs(cfg):
    """Six requests on a 40-token shared prefix (2.5 blocks of 16): prefix
    hits, the split block's copy-on-write and tail-waves, two of them
    sampled."""
    r = np.random.default_rng(11)
    prefix = r.integers(1, cfg.vocab_size, 40)
    return [Request(uid=i, prompt=np.concatenate(
        [prefix, r.integers(1, cfg.vocab_size, 4 + 3 * i)]).astype(np.int32),
        max_new_tokens=10, temperature=0.8 if i % 3 == 2 else 0.0,
        top_k=8 if i % 3 == 2 else 0, seed=i) for i in range(6)]


def _slo_reqs(cfg):
    """Requests with SLOs on either side of any clock: a 1 us first-token
    deadline (shed once the engine has measured a rate) or none."""
    reqs = _mixed_reqs(cfg, n=8, max_new=6)
    for r in reqs[2:]:
        r.deadline_ms = 1e-3 if r.uid % 2 else None
    return reqs


def serve_reqs(eng, reqs):
    """Serve ``reqs`` to the end: rank 0 (or an engine off a mesh)
    submits them and drains, which stops the followers; a rank > 0
    follows. Returns the requests as this rank holds them (a follower's
    copies, in rank 0's order) and the engine's stats."""
    if eng._comm is None or eng._comm.rank == 0:
        for rq in reqs:
            eng.submit(rq)
        return reqs, eng.run_until_drained()
    return eng.follow(), eng.stats()


def admit_reqs(eng, reqs):
    """One admission wave of ``reqs`` (no decode round), on every rank
    of a mesh alike: rank 0 submits and admits, the others follow."""
    if eng._comm is None or eng._comm.rank == 0:
        for rq in reqs:
            eng.submit(rq)
        eng.admit()
        eng.stop_followers()
    else:
        eng.follow()


def _run(cfg, params, mesh, kw, reqs, device="cpu"):
    eng = ServeEngine(cfg, params, mesh=mesh, device=device, **kw)
    reqs, st = serve_reqs(eng, reqs)
    return [tuple(rq.generated) for rq in reqs], st, eng


def _step_logits(cfg, params, mesh, kw):
    """One decode step's logits after admitting the mixed requests, and
    the collectives of that step (census, and the storages they read)."""
    eng = ServeEngine(cfg, params, mesh=mesh, device="cpu", **kw)
    admit_reqs(eng, _mixed_reqs(cfg))
    cache = clone_cache(eng.state["cache"])
    comm = eng._comm
    before = comm.counts() if comm else None
    if comm:
        comm.watch = set()
    logits, _ = decode_step(eng.mcfg, eng.params, eng.ctx,
                            eng.state["tokens"], cache)
    out = {"logits": logits.float().numpy()}
    if comm:
        after = comm.counts()
        out["census"] = {k: after[k] - before[k] for k in after}
        pools = {t.untyped_storage().data_ptr()
                 for t in list(cache["pool"].values())
                 + list(eng.state["cache"]["pool"].values())}
        out["pool_in_collective"] = bool(pools & comm.watch)
        comm.watch = None
    return out


def _cold_prefill_pool(cfg, params, mesh):
    """The pool's K/V codes and scales of the blocks one cold admission
    wave (prefix cache off) wrote, per leaf (layers, blocks, heads, ...),
    and the engine's KV heads a rank."""
    eng = ServeEngine(cfg, params, mesh=mesh, device="cpu",
                      **dict(ENG_KW, prefix_cache=False))
    admit_reqs(eng, _mixed_reqs(cfg))
    used = sorted({int(b) for s in eng._slot_req
                   for b in eng.alloc.tables[s] if b < eng.num_blocks})
    idx = torch.tensor(used)
    # numpy (bf16 as its bits): a tensor in a rank's result would be
    # shared with the parent through a process that is about to exit
    return {"pool": {k: (v[:, idx].view(torch.int16)
                         if v.dtype == torch.bfloat16 else v[:, idx]
                         ).numpy().copy()
                     for k, v in eng.state["cache"]["pool"].items()},
            "kv_heads": eng.mcfg.n_kv_heads}


def _cfg(kv, heads=4):
    return get_reduced_config("qwen2.5-3b").replace(n_heads=heads,
                                                    n_kv_heads=kv)


def _freed_without_gc(cfg, params, mesh):
    """Whether a deleted engine (its cache and weights) is freed at once,
    with the cyclic garbage collector off: no reference cycle holds it."""
    import gc
    import weakref
    eng = ServeEngine(cfg, params, mesh=mesh, device="cpu", **ENG_KW)
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        return ref() is None
    finally:
        gc.enable()


def _gathered(obj):
    import torch.distributed as dist
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return objs


def rank_scenarios(mesh, tree, kv, which, heads=4):
    """Every scenario of one mesh on this rank; rank 0's result is
    returned (each scenario also says whether all ranks agreed)."""
    cfg = _cfg(kv, heads)
    params = bridge.params_from_numpy(tree, "cpu")
    res = {}
    if "streams" in which:
        got, st, _ = _run(cfg, params, mesh, ENG_KW, _mixed_reqs(cfg))
        res["streams"] = (got, {k: st[k] for k in (
            "tp_degree", "mesh_shape", "per_device_pool_bytes",
            "per_device_weight_bytes", "decode_steps")})
        res["streams_agree"] = len(set(map(repr, _gathered(got)))) == 1
    if "small" in which:
        res["small"] = _run(cfg, params, mesh, ENG_KW, _small_reqs(cfg))[0]
    if "prefix" in which:
        got, st, _ = _run(cfg, params, mesh, dict(ENG_KW, slots=2),
                          _prefix_reqs(cfg))
        res["prefix"] = (got, {k: st[k] for k in (
            "prefix_hit_blocks", "cow_copies", "tail_waves")})
    if "spec" in which:
        got, st, _ = _run(cfg, params, mesh,
                          dict(ENG_KW, spec=SpecConfig(**SPEC)),
                          _mixed_reqs(cfg))
        res["spec"] = (got, st["spec_waves"], st["spec_accepted"])
    if "preempt" in which:
        got, st, _ = _run(cfg, params, mesh, PREEMPT_KW,
                          _mixed_reqs(cfg, n=8, max_new=20))
        res["preempt"] = (got, st["preemptions"])
    if "logits" in which:
        res["logits"] = _step_logits(cfg, params, mesh, ENG_KW)
    if "skew" in which:
        real = time.perf_counter
        if mesh.rank == 1:           # a clock 1000 s ahead, running 3x
            time.perf_counter = lambda: 3.0 * real() + 1000.0
        try:
            eng = ServeEngine(cfg, params, mesh=mesh, device="cpu",
                              **dict(ENG_KW, sched_policy="edf",
                                     slo_shed="reject"))
            reqs, _ = serve_reqs(eng, _slo_reqs(cfg))
        finally:
            time.perf_counter = real
        got = [tuple(r.generated) for r in reqs]
        shed = sorted(r.uid for r in reqs if r.shed)
        stamps = [(r._timing.submit_t, r._timing.admit_t,
                   r._timing.finish_t) for r in reqs]
        mine = (got, shed, stamps)
        res["skew"] = (got, shed)
        res["skew_agree"] = len(set(map(repr, _gathered(mine)))) == 1
    if "prefill" in which:
        res["prefill"] = _cold_prefill_pool(cfg, params, mesh)
        res["prefill_ranks"] = _gathered(res["prefill"]["pool"])
    if "freed" in which:
        res["freed"] = _freed_without_gc(cfg, params, mesh)
    if "probe" in which:
        from repro_torch.serve import engine as E
        ServeEngine(cfg, params, mesh=mesh, device="cpu",
                    **dict(ENG_KW, decode_block="auto"))
        res["probe_tails"] = [k[-1] for k in E._PROBE_CACHE]
    return res


def _spawn(tree, kv, tp, which, heads=4):
    return spawn_tp(rank_scenarios, tp, tree, kv, which, heads,
                    device="cpu", backend="gloo", timeout_s=TIMEOUT_S)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TREES = {}


def _jax_tree(kv):
    """The JAX package's calibrated reduced params (numpy leaves)."""
    if kv not in _TREES:
        import jax
        from repro.configs import get_reduced_config as jcfg
        from repro.core import qat as jqat
        from repro.core.precision import parse_policy
        from repro.models import init_params as jax_init_params
        cfg = jcfg("qwen2.5-3b").replace(n_kv_heads=kv)
        p = jax_init_params(cfg, jax.random.PRNGKey(0))
        p = jqat.calibrate_weight_scales(p, parse_policy(POLICY))
        _TREES[kv] = (cfg, p, jax.tree.map(np.asarray, p))
    return _TREES[kv]


@pytest.fixture(scope="module")
def base4():
    """tp=1 on the port, n_kv_heads=4."""
    _, _, tree = _jax_tree(4)
    cfg, params = _cfg(4), bridge.params_from_numpy(tree, "cpu")
    out = {"streams": _run(cfg, params, None, ENG_KW, _mixed_reqs(cfg)),
           "spec": _run(cfg, params, None,
                        dict(ENG_KW, spec=SpecConfig(**SPEC)),
                        _mixed_reqs(cfg)),
           "preempt": _run(cfg, params, None, PREEMPT_KW,
                           _mixed_reqs(cfg, n=8, max_new=20)),
           "prefix": _run(cfg, params, None, dict(ENG_KW, slots=2),
                          _prefix_reqs(cfg)),
           "logits": _step_logits(cfg, params, None, ENG_KW)}
    reqs = _slo_reqs(cfg)
    out["skew"] = _run(cfg, params, None, dict(ENG_KW, sched_policy="edf",
                                               slo_shed="reject"), reqs)
    out["skew_shed"] = sorted(r.uid for r in reqs if r.shed)
    return out


@pytest.fixture(scope="module")
def tp2():
    return _spawn(_jax_tree(4)[2], 4, 2, ("streams", "prefix", "spec",
                                          "preempt", "logits", "skew",
                                          "freed", "probe"))


@pytest.fixture(scope="module")
def tp4():
    return _spawn(_jax_tree(4)[2], 4, 4, ("streams", "spec", "preempt",
                                          "logits"))


@pytest.fixture(scope="module")
def gqa2():
    """n_kv_heads=2 at tp=2 (one KV head a rank), and its tp=1 run."""
    _, _, tree = _jax_tree(2)
    cfg, params = _cfg(2), bridge.params_from_numpy(tree, "cpu")
    base = (_run(cfg, params, None, ENG_KW, _mixed_reqs(cfg))[0],
            _step_logits(cfg, params, None, ENG_KW)["logits"])
    return base, _spawn(tree, 2, 2, ("streams", "logits"))


@pytest.fixture(scope="module")
def gqa4():
    """n_kv_heads=2 at tp=4 (more ranks than KV heads: each KV head whole
    on two ranks, one query head a rank), and its tp=1 run."""
    _, _, tree = _jax_tree(2)
    cfg, params = _cfg(2), bridge.params_from_numpy(tree, "cpu")
    base = {"streams": _run(cfg, params, None, ENG_KW, _mixed_reqs(cfg)),
            "logits": _step_logits(cfg, params, None, ENG_KW)["logits"],
            "prefill": _cold_prefill_pool(cfg, params, None)}
    return base, _spawn(tree, 2, 4, ("streams", "logits", "prefill"))


@pytest.fixture(scope="module")
def odd4():
    """6 query heads on 3 KV heads at tp=4, which divides neither: every
    rank runs the whole attention (``sharding.attn_replicated``); the MLP,
    embedding and head stay cut in four. Params: the port's calibrated
    ones from a seed (bridged to the reference's layout), and the tp=1
    run."""
    import ml_dtypes
    from repro_torch.core.precision import parse_policy
    from repro_torch.core.qat import calibrate_weight_scales
    from repro_torch.models import init_params
    cfg = _cfg(3, 6)
    params = calibrate_weight_scales(init_params(cfg, seed=0, device="cpu"),
                                     parse_policy(POLICY))
    tree = bridge.params_to_numpy(params, ml_dtypes.bfloat16)
    params = bridge.params_from_numpy(tree, "cpu")
    base = {"streams": _run(cfg, params, None, ENG_KW, _mixed_reqs(cfg)),
            "logits": _step_logits(cfg, params, None, ENG_KW)["logits"],
            "prefill": _cold_prefill_pool(cfg, params, None)}
    return base, _spawn(tree, 3, 4, ("streams", "logits", "prefill"), 6)


class TestStreamParity:
    @pytest.mark.parametrize("mesh", ["tp2", "tp4"])
    def test_greedy_sampled(self, base4, mesh, request):
        got = request.getfixturevalue(mesh)
        tp = 2 if mesh == "tp2" else 4
        base, st1, _ = base4["streams"]
        streams, st = got["streams"]
        assert streams == base and got["streams_agree"]
        assert len({s for s in base}) > 1
        assert st["tp_degree"] == tp and st["mesh_shape"] == {
            "data": 1, "model": tp}
        assert st1["tp_degree"] == 1 and st1["mesh_shape"] is None
        assert st["decode_steps"] == st1["decode_steps"]
        # the pool shards on its KV heads, the packed planes on their
        # output or packed-input channels: ~1/tp a rank
        for k in ("per_device_pool_bytes", "per_device_weight_bytes"):
            assert 0 < st[k] <= 1.2 * st1[k] / tp, k

    def test_gqa_grouped_parity(self, gqa2):
        (base, base_logits), got = gqa2
        streams, st = got["streams"]
        assert streams == base and got["streams_agree"]
        assert st["tp_degree"] == 2
        np.testing.assert_array_equal(got["logits"]["logits"], base_logits)

    def test_tp_a_multiple_of_the_kv_heads(self, gqa4):
        """Reduced qwen2.5-3b's 2 KV heads at tp=4: greedy and sampled
        streams, one decode step's gathered logits and the cold
        prefill's int8 K/V codes and scales are bitwise tp=1's; each
        rank's pool holds the one KV head its query head reads (rank r:
        head r // 2), half of tp=1's pool."""
        base, got = gqa4
        streams, st = got["streams"]
        want, st1, _ = base["streams"]
        assert streams == want and got["streams_agree"]
        assert len(set(want)) > 1
        assert st["tp_degree"] == 4 and st["decode_steps"] ==             st1["decode_steps"]
        assert st["per_device_pool_bytes"] * 2 == st1["per_device_pool_bytes"]
        np.testing.assert_array_equal(got["logits"]["logits"],
                                      base["logits"])
        pool1 = base["prefill"]["pool"]
        assert got["prefill"]["kv_heads"] == 1
        assert len(got["prefill_ranks"]) == 4
        for r, pool in enumerate(got["prefill_ranks"]):
            assert pool.keys() == pool1.keys()
            h = r // 2
            for k, v in pool.items():
                assert v.shape[2] == 1, k
                np.testing.assert_array_equal(v, pool1[k][:, :, h:h + 1],
                                              err_msg=f"rank {r} {k}")

    def test_heads_tp_does_not_divide(self, odd4):
        """6 query and 3 KV heads at tp=4 (ROADMAP Queue 3 item 6, fixed):
        greedy and sampled streams, one decode step's gathered logits and
        the cold prefill's int8 K/V codes and scales are bitwise tp=1's;
        every rank's pool is tp=1's whole pool (``serve_cache_spec``
        replicates it: 4 divides no KV-head count of 3), its bytes equal
        tp=1's; the weights a rank holds are fewer (the MLP, embedding
        and head cut in four); a decode step reduces nothing at wo."""
        from repro_torch.runtime.sharding import (attn_replicated,
                                                  serve_cache_spec)
        base, got = odd4
        cfg = _cfg(3, 6)
        assert attn_replicated(cfg, 4)
        streams, st = got["streams"]
        want, st1, _ = base["streams"]
        assert streams == want and got["streams_agree"]
        assert len(set(want)) > 1
        assert st["tp_degree"] == 4 and st["decode_steps"] == \
            st1["decode_steps"]
        assert st["per_device_pool_bytes"] == st1["per_device_pool_bytes"]
        assert st["per_device_weight_bytes"] < st1["per_device_weight_bytes"]
        np.testing.assert_array_equal(got["logits"]["logits"],
                                      base["logits"])
        c = got["logits"]["census"]
        assert c["all_reduce_max"] == cfg.n_layers      # wd only
        assert c["all_reduce_sum"] == cfg.n_layers + 1  # wd, the embedding
        pool1 = base["prefill"]["pool"]
        assert got["prefill"]["kv_heads"] == 3
        for r, pool in enumerate(got["prefill_ranks"]):
            for k, v in pool.items():
                assert serve_cache_spec(
                    cfg, _FakeMesh4, f"layers/0/{k}", v.shape[1:]) == (
                        None,) * (v.ndim - 1), k
                np.testing.assert_array_equal(v, pool1[k],
                                              err_msg=f"rank {r} {k}")

    def test_prefix_hits_cow_and_tail_waves(self, base4, tp2):
        """A shared prefix at tp=2: prefix hits, the split block's COW on
        each rank's half pool and tail-waves (the history gathered at the
        rank's KV heads), with tp=1's streams and counters."""
        got, st = tp2["prefix"]
        base, st1, _ = base4["prefix"]
        assert got == base
        assert st1["prefix_hit_blocks"] > 0 and st1["cow_copies"] > 0 \
            and st1["tail_waves"] > 0
        assert st == {k: st1[k] for k in st}

    @pytest.mark.parametrize("mesh", ["tp2", "tp4"])
    def test_spec_decode(self, base4, mesh, request):
        got = request.getfixturevalue(mesh)["spec"]
        base, st1, _ = base4["spec"]
        streams, waves, accepted = got
        assert streams == base
        assert waves > 0 and accepted > 0
        assert accepted == st1["spec_accepted"]

    @pytest.mark.parametrize("mesh", ["tp2", "tp4"])
    def test_preempt_swap_resume(self, base4, mesh, request):
        got = request.getfixturevalue(mesh)["preempt"]
        base, st1, _ = base4["preempt"]
        assert st1["preemptions"] > 0, "workload never preempted"
        assert got[1] == st1["preemptions"]
        assert got[0] == base


class TestDecodeStep:
    @pytest.mark.parametrize("mesh", ["tp2", "tp4"])
    def test_gathered_logits_bitwise(self, base4, mesh, request):
        got = request.getfixturevalue(mesh)["logits"]["logits"]
        want = base4["logits"]["logits"]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    def test_collective_census(self, tp2):
        """One decode step of the 2-layer model: an amax MAX and an int32
        SUM for each of wo and wd a layer, one SUM for the embedding and
        one all-gather for the logits; no pool leaf in any collective."""
        got = tp2["logits"]
        c = got["census"]
        assert c["all_reduce"] >= 1 and c["all_gather"] <= 2
        n_layers = _cfg(4).n_layers
        assert c["all_reduce_max"] == 2 * n_layers
        assert c["all_reduce_sum"] == 2 * n_layers + 1
        assert c["all_gather"] == 1 and c["broadcast"] == 0
        assert not got["pool_in_collective"]


class TestLockstep:
    def test_skewed_rank_clock_changes_nothing(self, base4, tp2):
        """Rank 1's perf_counter runs 3x fast from 1000 s ahead: the
        streams and the shed set are tp=1's, and every rank stamped the
        same submit, admit and finish times (rank 0's clock)."""
        got, shed = tp2["skew"]
        assert tp2["skew_agree"]
        assert got == base4["skew"][0]
        assert shed == base4["skew_shed"]
        assert shed, "the 1 us deadlines shed nothing"

    def test_deleted_engine_is_freed_without_gc(self, tp2):
        """Neither engine holds itself in a reference cycle (the
        scheduler reads the engine's clock): deleting one frees its cache
        and weights at once, on a mesh and off it."""
        assert tp2["freed"]
        _, _, tree = _jax_tree(4)
        assert _freed_without_gc(_cfg(4), bridge.params_from_numpy(
            tree, "cpu"), None)

    def test_probe_memo_key_carries_the_mesh(self, tp2):
        tails = tp2["probe_tails"]
        assert any(t is not None and ("model", 2) in t for t in tails), \
            tails


class _NoCollectives:
    """A tensor-parallel comm whose every collective fails the test."""
    size, rank = 3, 0

    def __getattr__(self, name):
        raise AssertionError(f"a whole linear called {name}")


def test_whole_linears_reduce_nothing():
    """At a tp the dims do not divide (3 on reduced qwen2.5-3b: d_ff 128,
    4 heads), the sharding rules keep wd and wo whole: the MLP and, under
    ``attn_whole``, the attention run as at tp=1 and call no collective;
    ``local_bytes`` counts the leaves ``shard_params`` keeps."""
    from repro_torch.core.precision import parse_policy
    from repro_torch.core.qat import (attach_w4a8_exports,
                                      calibrate_weight_scales, make_ctx)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import blocks as B
    from repro_torch.models import init_params
    from repro_torch.runtime.sharding import (attn_replicated, local_bytes,
                                              param_spec)
    cfg = _cfg(2)
    pol = parse_policy(POLICY)
    params = attach_w4a8_exports(calibrate_weight_scales(
        init_params(cfg, seed=0, device="cpu"), pol), pol)
    mesh = Mesh(shape={"data": 1, "model": 3}, rank=1,
                device=torch.device("cpu"))
    local = shard_params(params, cfg, mesh)
    layer = local["layers"][0]
    assert attn_replicated(cfg, 3)
    # local_bytes counts what shard_params keeps: the attention whole
    specs = {p: param_spec(cfg, mesh, p, tuple(t.shape))
             for p, t in bridge.flatten(params)}
    assert local_bytes(params, specs, 3, cfg=cfg) == sum(
        t.numel() * t.element_size() for _, t in bridge.flatten(local))
    x = torch.randn((2, 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(0)).to(
                        torch.bfloat16)
    one = make_ctx(POLICY, weights_layout="w4a8")
    tp3 = make_ctx(POLICY, weights_layout="w4a8", tp=_NoCollectives(),
                   attn_whole=True)
    lay1 = params["layers"][0]
    assert torch.equal(B.mlp_fwd(cfg, tp3, layer["mlp"], x),
                       B.mlp_fwd(cfg, one, lay1["mlp"], x))
    out = x.reshape(2, 5, -1)[..., :1].expand(2, 5, cfg.q_dim).contiguous()
    assert torch.equal(B._out_proj(tp3, layer["attn"], out),
                       B._out_proj(one, lay1["attn"], out))


class _FakeMesh4:
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 4}


def test_cli_tp2_gloo_on_cpu(capsys):
    """``--tp 2 --tp-backend gloo --device cpu`` serves to the end; only
    rank 0 prints."""
    from repro_torch.launch import serve
    stats = serve.main(["--tp", "2", "--tp-backend", "gloo", "--device",
                        "cpu", "--weights", "w4a8", "--kv-layout", "paged",
                        "--requests", "4", "--max-new", "6",
                        "--tp-timeout", str(TIMEOUT_S)])
    assert stats["tp_degree"] == 2 and stats["requests_finished"] == 4
    assert stats["collectives"]["all_gather"] > 0


def test_cli_tp_refusals():
    """What ``--tp`` still refuses: NCCL (the default backend) on the
    CPU, and an encoder-decoder, which its ranks refuse at engine build.
    The frontend modes (``--http-port``, ``--arrival-rate``) serve at
    ``--tp 2`` now: ``tests/test_torch_tp_frontend.py``."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="gloo"):
        serve.main(["--tp", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="Queue 1 item 3d"):
        serve.main(["--tp", "2", "--tp-backend", "gloo", "--device", "cpu",
                    "--arch", "whisper-large-v3", "--tp-timeout",
                    str(TIMEOUT_S)])


def test_shard_params_keeps_whole_kv_heads():
    """tp=4 over 2 KV heads: rank r keeps query head r and the whole KV
    head r // 2 of every wk / wv leaf (the packed planes' rows of it
    too); ``param_spec`` stays the reference's (a quarter of the KV
    columns), and ``local_bytes`` with the config counts what
    ``shard_params`` keeps."""
    from repro_torch.core.precision import parse_policy
    from repro_torch.core.qat import attach_w4a8_exports
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime.sharding import (kv_head_local, local_bytes,
                                              param_spec, shard_params)
    cfg = _cfg(2)
    _, _, tree = _jax_tree(2)
    params = attach_w4a8_exports(bridge.params_from_numpy(tree, "cpu"),
                                 parse_policy(POLICY))
    assert kv_head_local(cfg, 4) and not kv_head_local(cfg, 2)
    hd = cfg.resolved_head_dim
    full = dict(bridge.flatten(params))
    for r in range(4):
        mesh = Mesh(shape={"data": 1, "model": 4}, rank=r,
                    device=torch.device("cpu"))
        local = dict(bridge.flatten(shard_params(params, cfg, mesh)))
        h = r // 2
        for path, t in full.items():
            parts = path.split("/")
            if "wk" in parts or "wv" in parts:
                if parts[-1] == "s_in":
                    assert torch.equal(local[path], t), path
                    continue
                dim = t.dim() - 2 if parts[-1] == "wq" and \
                    "w4a8" in parts else t.dim() - 1
                assert torch.equal(local[path], t.narrow(
                    dim, h * hd, hd)), path
                spec = param_spec(cfg, mesh, path, tuple(t.shape))
                assert spec[dim] == "model", (path, spec)
            if path.endswith("attn/wq/w"):
                assert torch.equal(local[path], t[:, r * hd:(r + 1) * hd])
        specs = {p: param_spec(cfg, mesh, p, tuple(t.shape))
                 for p, t in full.items()}
        assert local_bytes(params, specs, 4, cfg=cfg) == sum(
            t.numel() * t.element_size() for t in local.values())


def test_engine_refuses_data_replicas():
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(shape={"data": 2, "model": 2}, rank=0,
                device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="one data replica"):
        ServeEngine(_cfg(4), None, mesh=mesh, weights_layout="w4a8")


def test_spawn_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1"):
        spawn_tp(_fail_on_rank1, 2, device="cpu", backend="gloo",
                 timeout_s=60)


def test_spawn_times_out():
    with pytest.raises(TimeoutError):
        spawn_tp(_sleep, 2, 60.0, device="cpu", backend="gloo",
                 timeout_s=4)


def _fail_on_rank1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.rank


def _sleep(mesh, s):
    time.sleep(s)
