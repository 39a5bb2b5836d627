"""Prefix sharing on the port's paged KV cache (CPU, plain versions).

Mirrors the reference's ``tests/test_prefix_share.py``: the refcounted
allocator's prefix index (rolling-hash chain, split blocks, copy-on-write,
LRU eviction) on the port's own copy of the allocator, and the engine's
token parity with sharing on vs off (including COW at the split block),
the re-issued prompt after divergent writers, multi-turn reuse of decoded
blocks and same-chain followers of a cold wave. Preemption is held in
``test_torch_preempt.py``, the ``decode_block="auto"`` probe in
``test_torch_frontend.py``.

The prefix-hit and COW counts must equal the JAX paged engine's on the
same requests: they are decisions of the allocator and the admission
loop, so any difference is a port fault, not a rounding one.
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
from repro_torch.serve.block_alloc import BlockAllocator, PoolDry
from repro_torch.serve.engine import Request, ServeEngine

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


def _req(uid, prompt, cls=Request, **kw):
    return cls(uid=uid, prompt=np.asarray(prompt, np.int32), **kw)


class TestPrefixIndex:
    def _alloc(self, **kw):
        kw.setdefault("num_blocks", 16)
        kw.setdefault("block_size", 4)
        kw.setdefault("slots", 4)
        kw.setdefault("table_len", 8)
        return BlockAllocator(**kw)

    def test_full_chain_lookup_caps_below_prompt_end(self):
        a = self._alloc()
        toks = np.arange(12, dtype=np.int32)
        a.register(0)
        a.ensure(0, 12)
        a.register_prefix(0, toks, 12)
        a.release(0)
        # identical prompt: the last full block is not taken (one tail
        # token must be left to recompute)
        ids, cached, partial = a.lookup(toks)
        assert cached == 8 and len(ids) == 2 and not partial
        ids, cached, partial = a.lookup(np.arange(20, dtype=np.int32))
        assert cached == 12 and len(ids) == 3 and not partial

    def test_split_block_matches_exact_divergence_point(self):
        a = self._alloc()
        a.register(0)
        a.ensure(0, 7)                     # 1 full + 3-token split block
        a.register_prefix(0, np.arange(7, dtype=np.int32), 7)
        a.release(0)
        other = np.array([0, 1, 2, 3, 4, 9, 9, 9], np.int32)  # diverges at 5
        ids, cached, partial = a.lookup(other)
        assert cached == 5 and partial     # 4 full + 1 shared split token
        miss = np.array([0, 1, 2, 3, 9, 9, 9], np.int32)      # diverges at 4
        ids, cached, partial = a.lookup(miss)
        assert cached == 4 and not partial

    def test_shared_map_refcounts_and_release_to_lru(self):
        a = self._alloc(num_blocks=4)
        toks = np.arange(8, dtype=np.int32)
        a.register(0)
        a.ensure(0, 8)
        a.register_prefix(0, toks, 8)
        assert a.release(0) == 2
        assert a.cached_blocks == 2 and a.allocated_blocks == 0
        ids, cached, _ = a.lookup(np.arange(12, dtype=np.int32))
        assert a.reserve(1, 12, shared=ids)
        assert a.allocated_blocks == 2     # resurrected from the LRU
        assert a.cached_blocks == 0
        a.check()

    def test_eviction_frees_index_entries_under_pressure(self):
        a = self._alloc(num_blocks=4)
        for i, slot in enumerate((0, 1)):
            toks = np.arange(8, dtype=np.int32) + 100 * i
            a.register(slot)
            a.ensure(slot, 8)
            a.register_prefix(slot, toks, 8)
            a.release(slot)
        assert a.cached_blocks == 4
        a.register(2)
        a.ensure(2, 12)                    # must evict 3 LRU blocks
        assert a.prefix_evictions == 3
        assert a.lookup(np.arange(12, dtype=np.int32))[1] == 0
        a.check()

    def test_cow_on_frozen_split_block_preserves_index_content(self):
        a = self._alloc()
        a.register(0)
        a.ensure(0, 7)
        a.register_prefix(0, np.arange(7, dtype=np.int32), 7)
        a.release(0)
        probe = np.array([0, 1, 2, 3, 4, 9, 9], np.int32)
        ids, cached, partial = a.lookup(probe)
        assert cached == 5 and partial
        a.register(1, shared=ids)
        split = ids[-1]
        pairs = a.cow_range(1, 5, 7)       # writes offsets 1.. of the split
        assert pairs and pairs[0][0] == split
        assert a.owned(1)[-1] == pairs[0][1]
        ids2, cached2, _ = a.lookup(np.arange(7, dtype=np.int32))
        assert split in ids2 and cached2 == 6
        a.check()

    def test_slot_id_reuse_does_not_inherit_write_privilege(self):
        a = self._alloc()
        a.register(2)
        a.ensure(2, 7)
        a.register_prefix(2, np.arange(7, dtype=np.int32), 7)
        probe = np.array([0, 1, 2, 3, 4, 9, 9], np.int32)
        ids, cached, partial = a.lookup(probe)
        a.register(1, shared=ids)          # sharer keeps the block alive
        split = ids[-1]
        a.release(2)                       # owner leaves, ref stays 1
        ids2, cached2, _ = a.lookup(probe)
        assert split in ids2
        a.register(2, shared=ids2)         # same slot id, new request
        pairs = a.cow_range(2, cached2, 7)
        assert [s for s, _ in pairs] == [split]
        a.check()

    def test_owner_appends_beyond_extent_without_copy(self):
        a = self._alloc()
        a.register(0)
        a.ensure(0, 6)
        a.register_prefix(0, np.arange(6, dtype=np.int32), 6)
        assert a.cow_range(0, 6, 8) == []
        a.check()

    def test_reserve_accounts_for_resurrected_shared_hits(self):
        a = self._alloc(num_blocks=4)
        toks = np.arange(8, dtype=np.int32)
        a.register(0)
        a.ensure(0, 8)
        a.register_prefix(0, toks, 8)
        a.release(0)                       # 2 registered blocks -> LRU
        assert a.reserve(1, 8)             # resident takes the other 2
        a.ensure(1, 8)
        ids, cached, partial = a.lookup(np.arange(16, dtype=np.int32))
        assert len(ids) == 2
        assert not a.reserve(2, 16, shared=ids, partial=partial)
        a.check()

    def test_harvest_extends_split_block_and_walks_past_it(self):
        a = self._alloc()
        prompt = np.arange(6, dtype=np.int32)
        a.register(0)
        a.ensure(0, 6)
        a.register_prefix(0, prompt, 6)            # split extent 2
        full = np.arange(11, dtype=np.int32)       # prompt + 5 decoded
        a.ensure(0, 11)
        a.register_prefix(0, full, 11)             # harvest-style pass
        a.release(0)
        ids, cached, partial = a.lookup(np.arange(12, dtype=np.int32))
        assert cached == 11 and partial            # 2 full + 3-token split
        probe = np.array([0, 1, 2, 3, 4, 9, 9], np.int32)
        assert a.lookup(probe)[1] == 5
        a.check()

    def test_pool_dry_raises_for_unreserved_slot(self):
        a = self._alloc(num_blocks=2)
        a.register(0)
        a.ensure(0, 8)
        a.register(1)
        with pytest.raises(PoolDry):
            a.ensure(1, 4)
        a.check()


class TestPrefixSharingEngine:
    BS = 16
    ENGINE = dict(slots=4, cache_len=64, kv_layout="paged", block_size=16,
                  num_blocks=32, max_seq_len=96)

    def _engine(self, served, **kw):
        _, _, tparams = served
        return ServeEngine(t_get_reduced_config("qwen2.5-3b"), tparams,
                           weights_layout="w4a8", device="cpu",
                           **{**self.ENGINE, **kw})

    def _jax_engine(self, served, **kw):
        cfg, params, _ = served
        return JServeEngine(cfg, params, weights_layout="w4a8",
                            w4a8_backend="ref", **{**self.ENGINE, **kw})

    def _shared_reqs(self, cls=Request, n=3, prefix_len=40, tail=5,
                     max_new=6):
        rng = np.random.default_rng(3)
        prefix = rng.integers(0, 250, prefix_len).astype(np.int32)
        return [_req(i, np.concatenate(
                    [prefix, ((np.arange(tail) * (i + 3) + i) % 250)
                     .astype(np.int32)]), cls, max_new_tokens=max_new)
                for i in range(n)]

    def _run_staged(self, eng, reqs):
        """The first request warms the prefix cache, the rest follow."""
        eng.submit(reqs[0])
        eng.run_until_drained()
        for r in reqs[1:]:
            eng.submit(r)
        return eng.run_until_drained()

    def test_token_parity_prefix_sharing_on_vs_off(self, served):
        """Greedy outputs of a shared-prefix batch with sharing on and
        with it off, including the followers that COW the split block
        (the 40-token prefix ends 8 tokens into a block), each equal to
        the JAX engine's in the same mode run op by op; the hit and COW
        counts equal the reference's too.

        A prefix hit reads the cached tokens back quantized where a cold
        prefill computes them, so the two modes need not give the same
        tokens: here the last token of request 1 differs between them,
        in the reference (op by op: 35 on, 216 off; compiled: 216 on, 35
        off) as in the port, and everything else agrees."""
        reqs_on = self._shared_reqs()
        reqs_off = self._shared_reqs()
        on = self._run_staged(self._engine(served, prefix_cache=True),
                              reqs_on)
        off = self._run_staged(self._engine(served, prefix_cache=False),
                               reqs_off)
        assert all(r.done for r in reqs_on + reqs_off)
        assert on["prefix_hit_tokens"] >= 64
        assert on["cow_copies"] >= 2          # split block cloned per fork
        assert off["prefix_hit_tokens"] == 0 and off["cow_copies"] == 0
        assert on["prompt_tokens_prefilled"] < \
            off["prompt_tokens_prefilled"] - 2 * self.BS
        for mode, reqs, stats in ((True, reqs_on, on),
                                  (False, reqs_off, off)):
            jreqs = self._shared_reqs(JRequest)
            with jax.disable_jit():
                ref = self._run_staged(
                    self._jax_engine(served, prefix_cache=mode), jreqs)
            assert [r.generated for r in reqs] == \
                [r.generated for r in jreqs], mode
            for k in ("prefix_hit_tokens", "prefix_hit_blocks",
                      "cow_copies", "prompt_tokens_prefilled",
                      "prefix_lookups"):
                assert stats[k] == ref[k], (mode, k)
        flat_on = [t for r in reqs_on for t in r.generated]
        flat_off = [t for r in reqs_off for t in r.generated]
        assert sum(a != b for a, b in zip(flat_on, flat_off)) <= 1

    def test_cow_protects_original_for_reissued_prompt(self, served):
        """After divergent followers wrote their copies of the split
        block, re-issuing the original prompt reproduces its output."""
        reqs = self._shared_reqs(n=3)
        eng = self._engine(served, prefix_cache=True)
        self._run_staged(eng, reqs)
        reissue = _req(9, reqs[0].prompt, max_new_tokens=6)
        eng.submit(reissue)
        eng.run_until_drained()
        assert reissue.generated == reqs[0].generated
        eng.alloc.check()

    def test_multi_turn_continuation_reuses_decoded_blocks(self, served):
        """Harvest registers prompt + completion: a follow-up prompt
        extending the finished conversation hits blocks written by
        decode, and still matches the unshared engine's tokens."""
        def run(prefix_cache):
            rng = np.random.default_rng(5)
            turn1 = rng.integers(0, 250, 20).astype(np.int32)
            eng = self._engine(served, prefix_cache=prefix_cache)
            r1 = _req(0, turn1, max_new_tokens=8)
            eng.submit(r1)
            eng.run_until_drained()
            turn2 = np.concatenate(
                [turn1, np.asarray(r1.generated, np.int32),
                 rng.integers(0, 250, 4).astype(np.int32)])
            r2 = _req(1, turn2, max_new_tokens=5)
            eng.submit(r2)
            stats = eng.run_until_drained()
            return r1.generated, r2.generated, stats

        g1_on, g2_on, on = run(True)
        g1_off, g2_off, _ = run(False)
        assert (g1_on, g2_on) == (g1_off, g2_off)
        # turn 2 reused more than turn 1's whole prompt: content written
        # by decode (the split block's extended extent) hit too
        assert on["prefix_hit_tokens"] > 20

    def test_wave_admissions_register_and_later_waves_hit(self, served):
        """Admitted requests register their prompts and same-chain
        followers prefill only tails; cross-wave dedup keeps the second
        request of the first pair out of the cold wave, so it prefix-hits
        the first's freshly registered blocks."""
        def reqs(uid0, cls=Request):
            return [_req(uid0 + i,
                         np.concatenate([np.arange(34, dtype=np.int32),
                                         np.asarray([i, i + 1], np.int32)]),
                         cls, max_new_tokens=4) for i in range(2)]

        eng = self._engine(served, prefix_cache=True)
        for r in reqs(0):
            eng.submit(r)
        eng.run_until_drained()
        assert eng.stats()["prefix_hit_tokens"] >= 32
        assert eng.stats()["prompt_tokens_prefilled"] <= 36 + 4
        wave2 = reqs(10)
        for r in wave2:
            eng.submit(r)
        stats = eng.run_until_drained()
        assert all(r.done for r in wave2)
        assert stats["prefix_hit_tokens"] >= 100
        jeng = self._jax_engine(served, prefix_cache=True)
        for wave in (reqs(0, JRequest), reqs(10, JRequest)):
            for r in wave:
                jeng.submit(r)
            jstats = jeng.run_until_drained()
        for k in ("prefix_hit_tokens", "cow_copies", "prefill_calls",
                  "prompt_tokens_prefilled"):
            assert stats[k] == jstats[k], k


def test_submit_rejects_block_table_overflow_with_requirement(served):
    """A request whose block count exceeds the table width is rejected
    at submit() with the computed need."""
    _, _, tparams = served
    eng = ServeEngine(t_get_reduced_config("qwen2.5-3b"), tparams, slots=2,
                      cache_len=64, kv_layout="paged", block_size=16,
                      num_blocks=16, max_seq_len=128, table_len=4,
                      device="cpu")
    with pytest.raises(ValueError,
                       match=r"needs 5 block-table entries.*table_len=4"):
        eng.submit(_req(0, np.arange(60), max_new_tokens=8))  # 67 tokens
    eng.submit(_req(1, np.arange(50), max_new_tokens=8))      # 57 tokens
