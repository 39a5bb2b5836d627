"""Optimistic admission with preemption and swap in the port's paged
engine (CPU, plain versions).

Mirrors the reference's ``TestPreemption`` (``tests/test_prefix_share.py``)
and ``TestSampledPreemptResume`` / ``TestSwapInPolicy``
(``tests/test_tail_wave.py``): the victim policies, exact resume of a
swapped-out request (greedy and sampled) against an uninterrupted solo
run, a chunked prefill swapped out mid-prompt, the swap queue's
head-of-line order, and sustained over-commit (thrash) with prefix
sharing on.

Tolerance: inside the port a resumed stream must equal the solo stream
exactly (the swap moves int8 payloads and scales bit for bit). Against
the JAX paged engine (compiled, ``w4a8_backend="ref"``) the swap
accounting must be equal: the number of preemptions and the bytes moved
each way. It depends only on token counts, not token values, so the
compiled reference's greedy near-tie flips cannot move it.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import init_params as jax_init_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import PREEMPT_POLICIES, Scheduler

POLICY = "A8d-C8-W4"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    cfg = get_reduced_config("qwen2.5-3b")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    params = jqat.calibrate_weight_scales(params, parse_policy(POLICY))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    return cfg, params, tparams


def _mk(uid, plen, mn, cls=Request, **kw):
    return cls(uid=uid, prompt=((np.arange(plen) * 7 + uid) % 250).astype(
        np.int32), max_new_tokens=mn, **kw)


def _engine(served, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("cache_len", 64)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("admission", "optimistic")
    kw.setdefault("prefix_cache", False)
    kw.setdefault("decode_block", 4)
    return ServeEngine(t_get_reduced_config("qwen2.5-3b"), served[2],
                       weights_layout="w4a8", device="cpu", **kw)


def _solo(served, req):
    solo = _engine(served, slots=1, num_blocks=32, admission="reserve")
    solo.submit(req)
    solo.run_until_drained()
    return req.generated


class TestPickVictim:
    def test_pick_victim_policies(self):
        cands = [(0, 5, 40), (1, 9, 10), (2, 2, 80)]
        assert Scheduler.pick_victim(cands, "last_admitted") == 1
        assert Scheduler.pick_victim(cands, "longest_remaining") == 2
        assert Scheduler.pick_victim([], "last_admitted") is None
        with pytest.raises(ValueError, match="preemption"):
            Scheduler.pick_victim(cands, "coin_flip")

    def test_longest_remaining_ties_go_to_the_newest(self):
        cands = [(0, 1, 30), (1, 7, 30), (2, 3, 12)]
        assert Scheduler.pick_victim(cands, "longest_remaining") == 1
        from repro.serve.scheduler import PREEMPT_POLICIES as JPOL
        from repro.serve.scheduler import Scheduler as JScheduler
        assert PREEMPT_POLICIES == JPOL
        for mode in PREEMPT_POLICIES:
            assert Scheduler.pick_victim(cands, mode) == \
                JScheduler.pick_victim(cands, mode)

    @pytest.mark.parametrize("policy", PREEMPT_POLICIES)
    def test_each_policy_resumes_exactly(self, served, policy):
        """Whichever resident the policy evicts, every stream equals its
        uninterrupted solo run."""
        reqs = [_mk(i, 10, 30) for i in (0, 9, 2)]
        solo = [_solo(served, _mk(i, 10, 30)) for i in (0, 9, 2)]
        eng = _engine(served, num_blocks=8, preempt=policy)
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained(max_steps=50_000)
        assert stats["preemptions"] >= 1
        assert [r.generated for r in reqs] == solo


class TestPreemption:
    def test_swap_out_mid_decode_resumes_exact_tokens(self, served):
        """Over-committed optimistic pool: decode growth preempts a
        victim whose blocks go to host memory; after the restore its
        greedy stream equals an uninterrupted run."""
        solo = _solo(served, _mk(9, 10, 30))
        eng = _engine(served, num_blocks=8)     # each request needs 5
        reqs = [_mk(0, 10, 30), _mk(9, 10, 30), _mk(2, 10, 30)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained(max_steps=50_000)
        assert all(r.done for r in reqs)
        assert [len(r.generated) for r in reqs] == [30, 30, 30]
        assert stats["preemptions"] >= 1
        assert stats["swap_out_bytes"] == stats["swap_in_bytes"] > 0
        assert stats["swapped_requests"] == 0
        assert reqs[1].generated == solo
        assert eng.alloc.allocated_blocks == 0
        assert (eng.alloc.tables == eng.num_blocks).all()

    def test_swap_bytes_equal_the_reference_engine(self, served):
        """The same over-committed workload through the JAX paged engine:
        equal preemptions and bytes moved each way (the sink block never
        travels)."""
        cfg, params, _ = served
        kw = dict(slots=4, cache_len=64, kv_layout="paged", block_size=8,
                  num_blocks=8, max_seq_len=96, decode_block=4,
                  admission="optimistic", prefix_cache=False)
        jeng = JServeEngine(cfg, params, weights_layout="w4a8",
                            w4a8_backend="ref", **kw)
        jreqs = [_mk(i, 10, 30, JRequest) for i in (0, 9, 2)]
        for r in jreqs:
            jeng.submit(r)
        ref = jeng.run_until_drained(max_steps=50_000)
        eng = _engine(served, num_blocks=8)
        reqs = [_mk(i, 10, 30) for i in (0, 9, 2)]
        for r in reqs:
            eng.submit(r)
        got = eng.run_until_drained(max_steps=50_000)
        assert ref["preemptions"] >= 1
        for k in ("preemptions", "swap_out_bytes", "swap_in_bytes",
                  "tokens_out", "max_residents"):
            assert got[k] == ref[k], k

    def test_optimistic_admits_more_residents_than_reserve(self, served):
        """Prompt-footprint admission holds more co-residents in the same
        pool than worst-case reservation."""
        def run(admission):
            eng = _engine(served, num_blocks=10, admission=admission)
            reqs = [_mk(i, 8, 24) for i in range(4)]
            for r in reqs:
                eng.submit(r)
            stats = eng.run_until_drained(max_steps=50_000)
            assert all(r.done for r in reqs)
            return stats

        res, opt = run("reserve"), run("optimistic")
        assert opt["max_residents"] > res["max_residents"]
        assert res["preemptions"] == 0

    def test_preempted_chunk_job_resumes(self, served):
        """A long prompt mid-chunked-prefill is itself swapped out (no
        other victim) and restores from its last finished window."""
        eng = _engine(served, slots=2, num_blocks=8, prefill_chunk=16)
        long_req, rival = _mk(0, 60, 4), _mk(1, 8, 30)
        eng.submit(long_req)
        eng.submit(rival)
        stats = eng.run_until_drained(max_steps=50_000)
        assert long_req.done and rival.done
        assert len(long_req.generated) == 4 and len(rival.generated) == 30
        assert stats["preemptions"] >= 1
        assert long_req.generated == _solo(served, _mk(0, 60, 4))

    def test_preemption_thrash_stress(self, served):
        """Sustained over-commit: a dozen decode-heavy requests on a pool
        a fraction of their aggregate need, with prefix sharing on. Every
        request drains with its exact budget and its solo stream, and
        the blocks are conserved."""
        eng = _engine(served, slots=6, num_blocks=16, prefix_cache=True)
        rng = np.random.default_rng(11)
        shape = [(int(rng.integers(4, 30)), int(rng.integers(8, 28)))
                 for _ in range(12)]
        reqs = [_mk(i, p, m) for i, (p, m) in enumerate(shape)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained(max_steps=200_000)
        assert all(r.done for r in reqs)
        assert [len(r.generated) for r in reqs] == [m for _, m in shape]
        assert stats["preemptions"] >= 1
        assert stats["swap_out_bytes"] == stats["swap_in_bytes"]
        assert eng.alloc.allocated_blocks == 0
        assert eng.alloc.free_blocks == eng.num_blocks
        eng.alloc.check()
        for i in (0, 5, 11):
            assert reqs[i].generated == _solo(served, _mk(i, *shape[i]))


class TestSampledPreemptResume:
    def test_sampled_swap_out_resumes_exact_tokens(self, served):
        """With temperature > 0 the swap record carries the slot's PRNG
        key, so the resumed stream equals the solo run token for token."""
        kw = dict(temperature=0.7, top_k=8, seed=5)
        solo = _solo(served, _mk(9, 10, 30, **kw))
        eng = _engine(served, num_blocks=8)
        reqs = [_mk(i, 10, 30, **kw) for i in (0, 9, 2)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained(max_steps=50_000)
        assert all(r.done for r in reqs)
        assert stats["preemptions"] >= 1
        assert reqs[1].generated == solo
        assert eng.alloc.allocated_blocks == 0


class TestSwapInPolicy:
    def test_fcfs_head_blocks_smaller_later_record(self, served):
        """Head-of-line: while the swap queue's head does not fit, a later
        smaller record that would fit is not restored ahead of it."""
        eng = _engine(served, slots=3, num_blocks=10)
        big = Request(uid=0, prompt=np.arange(10, dtype=np.int32),
                      max_new_tokens=60)
        small = Request(uid=1, prompt=np.arange(8, dtype=np.int32) + 50,
                        max_new_tokens=8)
        rival = Request(uid=2, prompt=np.arange(8, dtype=np.int32) + 90,
                        max_new_tokens=40)
        for r in (big, small, rival):
            eng.submit(r)
        eng.step()                          # all three admitted
        slots = {r.uid: s for s, r in eng._slot_req.items()}
        assert set(slots) == {0, 1, 2}
        eng._swap_out(slots[0])             # big first: the queue head
        eng._swap_out(slots[1])             # small behind it
        assert [rec["req"].uid for rec in eng._swapped] == [0, 1]
        need_big = eng.alloc.blocks_for_tokens(10 + 60 - 1)
        need_small = eng.alloc.blocks_for_tokens(8 + 8 - 1)
        assert need_small <= eng.alloc.free_blocks < need_big
        eng._try_swap_in()
        assert [rec["req"].uid for rec in eng._swapped] == [0, 1]
        assert len(eng._slot_req) == 1      # nothing restored
        stats = eng.run_until_drained(max_steps=50_000)
        assert big.done and small.done and rival.done
        assert stats["swap_in_bytes"] == stats["swap_out_bytes"] > 0

    def test_budget_abort_surfaces_swapped_tokens(self, served):
        """A drain cut by its step budget leaves swapped-out requests
        with the tokens they had at preemption."""
        eng = _engine(served, num_blocks=8)
        reqs = [_mk(i, 10, 30) for i in (0, 9, 2)]
        for r in reqs:
            eng.submit(r)
        for _ in range(40):
            eng.step()
            if eng._swapped and eng._swapped[0]["kind"] == "decode":
                break
        assert eng._swapped, "no decode resident was swapped out"
        rec = eng._swapped[0]
        eng.run_until_drained(max_steps=0)
        assert not rec["req"].done
        assert rec["req"].generated == \
            rec["out"][:rec["n_gen"]].tolist() != []
