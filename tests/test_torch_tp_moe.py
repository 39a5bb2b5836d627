"""Tensor-parallel serving of the MoE archs on the CPU: expert
parallelism, TP inside experts, and their tp=1 runs.

``tp`` ranks in processes of their own (``launch.mesh.spawn_tp``, gloo),
one spawn a mesh: the tp=2 spawn and the tp=4 spawn each run every
scenario of their mesh (reduced moonshot-v1-16b-a3b at its own top 2 and
at ``n_experts_active=6``, so that the combine's k order is exercised,
on the paged pool: streams on a pool that preempts, one decode step's
logits, a shared prefix and the cold prefill's pool (top 2) and spec
at k 4 (top 6), on both meshes; at tp=2 reduced
mixtral-8x7b on the dense layout with rings that wrap; at tp=4 moonshot
with 6 experts, which 4 ranks do not divide: TP inside experts). The
block itself (``models.blocks.moe_fwd``) runs on ranks as threads
(:class:`_Threads`, as ``test_torch_w4a8.ThreadComm``; not imported
from there, which would bring JAX into every spawned rank).

Tolerance: none for expert parallelism. Streams (greedy and sampled),
spec accept counts, preemptions, prefix counters, one decode step's
gathered logits and the pool's int8 K/V codes and scales are bitwise
tp=1's: the router is whole, so every rank routes as tp=1 does, and the
combine gathers each top-k slot's bf16 bits from the rank that owns its
expert (``TPComm.sum_owned``) before summing in tp=1's order. TP inside
experts is not bitwise: ``wd``'s f32 partials are summed over the ranks
and rounded once, where tp=1's bf16 GEMM rounds its own f32 sum. It is
held to ``INSIDE_REL`` relative L2 (2^-10) and ``INSIDE_SHARE`` of
outputs that differ at all (1e-3). Measured on the block at moonshot's
d_ff 1408 (3 experts on 2 ranks, d 256, 4 x 37 tokens): 1.1e-5 relative
L2, 2.6e-5 of the outputs one bf16 ulp apart (elsewhere 2.3e-5 and 2.6e-5
at 6 experts on 4 ranks, 6.7e-5 and 5.3e-5 at d 512 and d_ff 2048); the
engine's logits at the reduced config (6 experts on 4 ranks) were
bitwise. Rounding ties are rare at these sizes: a smaller block or fewer
tokens gave tp=1's bits.
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_reduced_config
from repro_torch.core.precision import parse_policy
from repro_torch.core.qat import (attach_w4a8_exports,
                                  calibrate_weight_scales, make_ctx)
from repro_torch.launch.mesh import Mesh, spawn_tp
from repro_torch.models import clone_cache, decode_step, init_params
from repro_torch.models import blocks as B
from repro_torch.runtime.sharding import (local_bytes, param_spec,
                                          shard_params)
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.spec import SpecConfig
from test_torch_tp_serve import (ENG_KW, POLICY, PREEMPT_KW, TIMEOUT_S,
                                 _cold_prefill_pool, _mixed_reqs,
                                 _prefix_reqs, _run, _step_logits,
                                 admit_reqs)

MS, MX = "moonshot-v1-16b-a3b", "mixtral-8x7b"
SPEC = dict(k=4, draft_layers=1, accept_mode="exact")
# mixtral's rings: cache 64 under its window of 32, prompts of 5-29
# tokens and 16 new: every row longer than 32 has wrapped
MX_KW = dict(ENG_KW, kv_layout="dense", cache_len=64)
MX_WRAP_STEPS = 12
# an optimistic pool of 12 blocks of 8 for 6 requests of 10 new tokens:
# it preempts (twice at tp=1, top 2 and top 6)
PRE_KW = dict(PREEMPT_KW, num_blocks=12)
INSIDE_REL = 2.0 ** -10
INSIDE_SHARE = 1e-3


def _cfg(name, **kw):
    return get_reduced_config(name).replace(**kw)


def _params(cfg):
    """Calibrated reduced params from a seed: every rank builds the same
    tree (the reduced MoEs have no JAX-side twin in these tests)."""
    return calibrate_weight_scales(init_params(cfg, seed=0, device="cpu"),
                                   parse_policy(POLICY))


def _whole_plane_bytes(key, tp):
    """The bytes of a case's packed planes that every rank of ``tp``
    keeps whole (by ``param_spec``: the router's, the row-parallel
    ``wo``'s scales)."""
    ckw = dict(CASES[2][key][0])
    cfg = _cfg(ckw.pop("name"), **ckw)
    tree = attach_w4a8_exports(_params(cfg), parse_policy(POLICY))
    mesh = Mesh(shape={"data": 1, "model": tp}, rank=0,
                device=torch.device("cpu"))
    return sum(t.numel() * t.element_size()
               for p, t in bridge.flatten(tree) if "w4a8" in p.split("/")
               and "model" not in param_spec(cfg, mesh, p, tuple(t.shape)))


def _wrapped_logits(cfg, params, mesh, kw, steps=MX_WRAP_STEPS):
    """A dense engine's logits after an admission wave and ``steps``
    greedy decode steps (the longer rows' rings have wrapped)."""
    eng = ServeEngine(cfg, params, mesh=mesh, device="cpu", **kw)
    admit_reqs(eng, _mixed_reqs(cfg))
    cache = clone_cache(eng.state["cache"])
    tok = eng.state["tokens"]
    for _ in range(steps):
        logits, cache = decode_step(eng.mcfg, eng.params, eng.ctx, tok,
                                    cache)
        tok = logits.argmax(-1).to(tok.dtype)
    ring = cache["layers"][0]["k_q"].shape[2]
    return {"logits": logits.float().numpy(),
            "lengths": cache["layers"][0]["length"].tolist(), "ring": ring}


def _spec_reqs(cfg):
    """The spec workload: the mixed requests, fewer and shorter (a
    verify-wave and its draft cost a decode step each of k + 1)."""
    return _mixed_reqs(cfg, n=3, max_new=8)


def _paged(cfg, params, mesh, which):
    """The paged scenarios of one MoE config: ``which`` of "streams"
    (preempting), "prefix", "spec", "logits" and "prefill"."""
    res = {}
    if "streams" in which:
        got, st, eng = _run(cfg, params, mesh, PRE_KW,
                            _mixed_reqs(cfg, n=6, max_new=10))
        res["streams"] = (got, {k: st[k] for k in (
            "per_device_pool_bytes", "per_device_weight_bytes",
            "per_device_bank_bytes", "decode_steps", "preemptions")})
    if "prefix" in which:
        got, st, _ = _run(cfg, params, mesh, dict(ENG_KW, slots=2),
                          _prefix_reqs(cfg))
        res["prefix"] = (got, {k: st[k] for k in (
            "prefix_hit_blocks", "cow_copies", "tail_waves")})
    if "spec" in which:
        got, st, _ = _run(cfg, params, mesh,
                          dict(ENG_KW, spec=SpecConfig(**SPEC)),
                          _spec_reqs(cfg))
        res["spec"] = (got, st["spec_waves"], st["spec_accepted"])
    if "logits" in which:
        res["logits"] = _step_logits(cfg, params, mesh, ENG_KW)
    if "prefill" in which:
        res["prefill"] = _cold_prefill_pool(cfg, params, mesh)
    return res


def _mixtral(cfg, params, mesh):
    got, st, _ = _run(cfg, params, mesh, MX_KW, _mixed_reqs(cfg))
    return {"streams": (got, st["per_device_pool_bytes"]),
            "wrapped": _wrapped_logits(cfg, params, mesh, MX_KW)}


def _inside(cfg, params, mesh):
    """TP inside experts: a short serve (its ranks' streams must agree;
    they are not held to tp=1's) and one decode step's logits, held to
    tp=1's within ``INSIDE_REL``."""
    got, st, eng = _run(cfg, params, mesh, ENG_KW,
                        _mixed_reqs(cfg, n=4, max_new=4))
    out = {"streams": got,
           "logits": _step_logits(cfg, params, mesh, ENG_KW)["logits"]}
    if eng._comm is not None:
        out["census"] = eng._comm.counts()
    return out


# each mesh's cases: (config, the paged scenarios; None for mixtral's
# rings and for TP inside experts, which run their own)
MS2 = dict(name=MS)
MS6 = dict(name=MS, n_experts_active=6)
MX2 = dict(name=MX)
IN6 = dict(name=MS, n_experts=6)
CASES = {
    2: {"ms2": (MS2, ("streams", "prefix", "logits", "prefill")),
        "ms6": (MS6, ("streams", "spec", "logits")), "mx": (MX2, None)},
    4: {"ms2": (MS2, ("streams", "prefix", "logits", "prefill")),
        "ms6": (MS6, ("streams", "spec", "logits")), "inside": (IN6, None)},
}


def _run_case(key, ckw, which, mesh):
    ckw = dict(ckw)
    cfg = _cfg(ckw.pop("name"), **ckw)
    params = _params(cfg)
    if key == "mx":
        return _mixtral(cfg, params, mesh)
    if key == "inside":
        return _inside(cfg, params, mesh)
    return _paged(cfg, params, mesh, which)


def rank_small(mesh, tree):
    """The JAX comparison's run on one rank (``test_torch_tp_moe_jax.py``;
    here, so that a spawned rank imports no JAX): reduced moonshot's
    params as the reference's tree, the short mixed workload on the
    pool."""
    from test_torch_tp_serve import _small_reqs
    cfg = _cfg(MS)
    return _run(cfg, bridge.params_from_numpy(tree, "cpu"), mesh, ENG_KW,
                _small_reqs(cfg))[0]


def rank_cases(mesh, cases):
    """Every case of one mesh on this rank: rank 0's results, and
    whether every rank's streams agreed with rank 0's."""
    import torch.distributed as dist
    res = {k: _run_case(k, ckw, which, mesh)
           for k, (ckw, which) in cases.items()}
    streams = {k: v["streams"][0] for k, v in res.items()}
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, repr(streams))
    res["agree"] = len(set(objs)) == 1
    return res


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    """tp=1 of every case (each scenario any mesh runs)."""
    which = {}
    for cases in CASES.values():
        for k, (ckw, w) in cases.items():
            seen = which.get(k, (ckw, ()))[1] or ()
            which[k] = (ckw, None if w is None else set(w) | set(seen))
    return {k: _run_case(k, ckw, w, None) for k, (ckw, w) in which.items()}


@pytest.fixture(scope="module")
def tp2():
    return spawn_tp(rank_cases, 2, CASES[2], device="cpu", backend="gloo",
                    timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def tp4():
    return spawn_tp(rank_cases, 4, CASES[4], device="cpu", backend="gloo",
                    timeout_s=TIMEOUT_S)


EP = [(tp, k) for tp in (2, 4) for k in ("ms2", "ms6")]


class TestExpertParallel:
    @pytest.mark.parametrize("tp,key", EP)
    def test_streams_preemptions_and_bytes(self, base, tp, key, request):
        """On an optimistic pool that preempts: greedy and sampled
        streams and the preemption count bitwise tp=1's on every rank; a
        rank's pool holds its KV heads (1/tp), its expert banks exactly
        1/tp of tp=1's (cut over the experts) and its packed planes 1/tp
        of tp=1's but for those every rank keeps whole (the router's)."""
        got = request.getfixturevalue(f"tp{tp}")
        assert got["agree"]
        streams, st = got[key]["streams"]
        want, st1 = base[key]["streams"]
        assert streams == want and len(set(want)) > 1
        assert st1["preemptions"] > 0, "workload never preempted"
        for k in ("decode_steps", "preemptions"):
            assert st[k] == st1[k], k
        assert st["per_device_pool_bytes"] * tp == \
            st1["per_device_pool_bytes"]
        assert st["per_device_bank_bytes"] * tp == \
            st1["per_device_bank_bytes"] > 0
        assert st["per_device_weight_bytes"] * tp - \
            st1["per_device_weight_bytes"] == (tp - 1) * _whole_plane_bytes(key, tp)

    @pytest.mark.parametrize("tp,key", EP)
    def test_decode_step_logits_bitwise(self, base, tp, key, request):
        got = request.getfixturevalue(f"tp{tp}")[key]["logits"]
        np.testing.assert_array_equal(got["logits"],
                                      base[key]["logits"]["logits"])
        assert not got["pool_in_collective"]

    def test_spec_at_k4(self, base, tp2, tp4):
        """At top 6, the verify-wave at a 5-token window's capacity (1 slot
        an expert) and the draft on the rank's banks (4 and 2 experts a
        rank): tp=1's streams, waves and accept counts on both meshes."""
        want, w1, a1 = base["ms6"]["spec"]
        for got in (tp2, tp4):
            streams, waves, accepted = got["ms6"]["spec"]
            assert streams == want
            assert waves == w1 > 0 and accepted == a1

    def test_prefix_hits_cow_and_tail_waves(self, base, tp2, tp4):
        """A shared prefix on the pool at 4 and 2 experts a rank: streams,
        prefix hits, COW copies and tail-waves tp=1's on both meshes."""
        want, st1 = base["ms2"]["prefix"]
        assert st1["prefix_hit_blocks"] > 0 and st1["cow_copies"] > 0 \
            and st1["tail_waves"] > 0
        for mesh in (tp2, tp4):
            got, st = mesh["ms2"]["prefix"]
            assert got == want
            assert st == st1

    @pytest.mark.parametrize("tp", [2, 4])
    def test_cold_prefill_pool_bitwise(self, base, tp, request):
        """The int8 K/V codes and scales of a cold admission wave: each
        rank's are tp=1's at its KV heads."""
        got = request.getfixturevalue(f"tp{tp}")["ms2"]["prefill"]
        want = base["ms2"]["prefill"]
        h = got["kv_heads"]
        assert h * tp == want["kv_heads"]
        for k, v in got["pool"].items():     # rank 0: heads [0, h)
            np.testing.assert_array_equal(v, want["pool"][k][:, :, :h],
                                          err_msg=k)

    def test_collective_census(self, tp2):
        """A decode step of the 2-layer moonshot: a MAX and an int32 SUM
        for wo and one owned-slot sum for the combine a layer, the
        embedding's SUM and the logits' gather; no f32 sum."""
        c = tp2["ms2"]["logits"]["census"]
        n = _cfg(MS).n_layers
        assert c["all_reduce_max"] == n and c["all_reduce_sum"] == n + 1
        assert c["all_reduce_owned"] == n and c["all_reduce_sum_f32"] == 0
        assert c["all_gather"] == 1
        assert c["all_reduce"] == 3 * n + 1


class TestMixtral:
    def test_dense_rings_bitwise(self, base, tp2):
        """Reduced mixtral at tp=2 (2 of 4 experts, 2 of 4 query heads
        and 1 of 2 KV heads a rank) on the dense layout: streams and the
        logits after its rings wrapped are tp=1's, bitwise; a rank's
        rings hold half the bytes."""
        got, want = tp2["mx"], base["mx"]
        assert got["streams"][0] == want["streams"][0]
        assert got["streams"][1] <= 0.51 * want["streams"][1]
        w = got["wrapped"]
        assert max(w["lengths"]) > w["ring"] == _cfg(MX).sliding_window
        np.testing.assert_array_equal(w["logits"],
                                      want["wrapped"]["logits"])


class TestInsideExperts:
    def test_engine_within_tolerance(self, base, tp4):
        """Moonshot with 6 experts at tp=4 (TP inside experts: each rank
        a d_ff quarter of every expert): one decode step's logits within
        ``INSIDE_REL`` of tp=1's, and a decode step's f32 sums (one a
        layer, ``wd``) and amax MAXes (``wo`` and ``wd``)."""
        got, want = tp4["inside"], base["inside"]
        g, w = got["logits"], want["logits"]
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= INSIDE_REL, rel
        n = _cfg(MS).n_layers
        c = got["census"]
        assert c["all_reduce_sum_f32"] > 0 and c["all_reduce_owned"] == 0
        assert c["all_reduce_max"] == 2 * c["all_reduce_sum_f32"]
        assert c["all_reduce_sum_f32"] % n == 0

    def test_block_within_tolerance(self):
        """``moe_fwd`` on 2 ranks as threads, each with its d_ff slice of
        all 3 experts (moonshot's d_ff 1408), against the whole block:
        within ``INSIDE_REL`` relative L2 and ``INSIDE_SHARE`` of outputs
        differing (the docstring's measured values)."""
        experts, tp, d, f = 3, 2, 256, 1408
        cfg = _cfg(MS, n_layers=1, d_model=d, d_ff=f, n_experts=experts,
                   n_experts_active=2)
        p = _params(cfg)["layers"][0]["moe"]
        x = torch.randn((4, 37, d), generator=torch.Generator().manual_seed(
            1)).to(torch.bfloat16)
        want, _ = B.moe_fwd(cfg, make_ctx(POLICY), p, x, with_aux=False)

        def fn(r, comm):
            mesh = Mesh(shape={"data": 1, "model": tp}, rank=r,
                        device=torch.device("cpu"))
            loc = shard_params({"moe": p}, cfg, mesh)["moe"]
            assert loc["wg"]["w"].shape == (experts, d, f // tp)
            assert loc["wd"]["w"].shape == (experts, f // tp, d)
            return B.moe_fwd(cfg, make_ctx(POLICY, tp=comm), loc,
                             x, with_aux=False)[0]

        got, calls = run_ranks(tp, fn)
        assert set(calls) == {"max", "f32"}
        g, w = got[0].float(), want.float()
        assert all(torch.equal(y, got[0]) for y in got)
        assert float((g - w).norm() / w.norm()) <= INSIDE_REL
        assert float((g != w).float().mean()) <= INSIDE_SHARE


class _Threads:
    """The MoE's collectives of ``runtime.collectives.TPComm`` between
    threads of one process (one thread a rank): each call deposits the
    rank's tensor, waits for every rank, and reduces the deposits in rank
    order. Records the kind of every call (rank 0's)."""

    def __init__(self, rank, shared):
        self.rank, self.sh = rank, shared
        self.size = len(shared["slots"])

    def _exchange(self, t, kind):
        sh = self.sh
        sh["slots"][self.rank] = t.clone()
        sh["barrier"].wait()
        out = torch.stack(sh["slots"])
        out = out.amax(0) if kind == "max" else out.sum(0)
        if self.rank == 0:
            sh["calls"].append(kind)
        sh["barrier"].wait()
        return out

    def all_reduce_max(self, t):
        return t.copy_(self._exchange(t, "max"))

    def all_reduce_sum_f32(self, t):
        return t.copy_(self._exchange(t, "f32"))

    def sum_owned(self, t):
        ints = {2: torch.int16, 4: torch.int32}[t.element_size()]
        bits = t.contiguous().view(ints).to(torch.int32)
        return self._exchange(bits, "owned").to(ints).view(t.dtype)


def run_ranks(tp, fn):
    """``fn(rank, comm)`` on ``tp`` threads; returns (results, calls)."""
    import threading
    sh = {"slots": [None] * tp, "barrier": threading.Barrier(tp),
          "calls": []}
    out, errs = [None] * tp, []

    def go(r):
        try:
            out[r] = fn(r, _Threads(r, sh))
        except Exception as e:              # noqa: BLE001
            errs.append(e)
            sh["barrier"].abort()

    ts = [threading.Thread(target=go, args=(r,)) for r in range(tp)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    if errs:
        raise errs[0]
    return out, sh["calls"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("top", [2, 6])
def test_block_expert_parallel_bitwise(tp, top):
    """``moe_fwd`` with ``n_experts / tp`` experts a rank, ranks as
    threads: every rank's output is the whole block's bits, after one
    owned-slot sum and nothing else."""
    cfg = _cfg(MS, n_layers=1, d_model=64, d_ff=256, n_experts=8,
               n_experts_active=top)
    p = _params(cfg)["layers"][0]["moe"]
    x = torch.randn((3, 21, 64), generator=torch.Generator().manual_seed(
        2)).to(torch.bfloat16)
    want, _ = B.moe_fwd(cfg, make_ctx(POLICY), p, x, with_aux=False)

    def fn(r, comm):
        mesh = Mesh(shape={"data": 1, "model": tp}, rank=r,
                    device=torch.device("cpu"))
        loc = shard_params({"moe": p}, cfg, mesh)["moe"]
        return B.moe_fwd(cfg, make_ctx(POLICY, tp=comm), loc, x,
                         with_aux=False)[0]

    got, calls = run_ranks(tp, fn)
    assert calls == ["owned"]
    for y in got:
        assert torch.equal(y, want)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_banks_and_local_bytes(tp):
    """Reduced moonshot's banks: rank r holds experts [r E/tp, (r+1)
    E/tp) of wg / wu / wd and their scales; the router (its packed plane
    too) whole; ``local_bytes`` counts what ``shard_params`` keeps. With
    6 experts at tp=4 (TP inside): wg / wu cut on d_ff's columns (their
    scales too), wd on d_ff's rows (its scales whole)."""
    pol = parse_policy(POLICY)
    for n_exp in (8, 6):
        cfg = _cfg(MS, n_experts=n_exp)
        params = attach_w4a8_exports(_params(cfg), pol)
        full = dict(bridge.flatten(params))
        e, f = cfg.n_experts, cfg.d_ff
        for r in range(tp):
            mesh = Mesh(shape={"data": 1, "model": tp}, rank=r,
                        device=torch.device("cpu"))
            local = dict(bridge.flatten(shard_params(params, cfg, mesh)))
            for path, t in full.items():
                parts = path.split("/")
                if "router" in parts:
                    assert torch.equal(local[path], t), path
                if "moe" not in parts or parts[-2] not in ("wg", "wu",
                                                           "wd"):
                    continue
                if parts[-1] == "s_in":
                    assert torch.equal(local[path], t), path
                elif e % tp == 0:
                    n = e // tp
                    assert torch.equal(local[path], t[r * n:(r + 1) * n])
                elif parts[-2] == "wd" and parts[-1] == "s_w":
                    assert torch.equal(local[path], t), path
                elif parts[-2] == "wd":
                    n = f // tp
                    assert torch.equal(local[path],
                                       t[:, r * n:(r + 1) * n]), path
                else:
                    n = f // tp
                    assert torch.equal(local[path],
                                       t[..., r * n:(r + 1) * n]), path
            specs = {p: param_spec(cfg, mesh, p, tuple(t.shape))
                     for p, t in full.items()}
            assert local_bytes(params, specs, tp, cfg=cfg) == sum(
                t.numel() * t.element_size() for t in local.values())


def test_cli_tp2_moonshot_on_cpu():
    """``--arch moonshot-v1-16b-a3b --tp 2`` on the pool serves to the
    end; the combine's owned-slot sums ran."""
    from repro_torch.launch import serve
    stats = serve.main(["--arch", MS, "--tp", "2", "--tp-backend", "gloo",
                        "--device", "cpu", "--weights", "w4a8",
                        "--kv-layout", "paged", "--no-spec", "--requests",
                        "3", "--max-new", "4", "--tp-timeout",
                        str(TIMEOUT_S)])
    assert stats["tp_degree"] == 2 and stats["requests_finished"] == 3
    assert stats["collectives"]["all_reduce_owned"] > 0
