"""The batched tail prefill (the tail-wave) of the port's paged engine
(CPU, plain versions).

Mirrors the reference's ``tests/test_tail_wave.py``: token parity of
simultaneous prefix-hit admissions against the one-tail-per-step path
(greedy and sampled, with a COW at the split block during the wave), two
long chunked prompts sharing one wave, prefix-affinity scheduling, and
the host's ``_written`` mirror against the device ``n_gen`` counter. The
preemption classes belong to a later slice of the port.

The wave packs rows of different slots into one call; rows are
independent, so the tokens must equal the serialized path's exactly.
The counts of hits, COW copies and windows are also held against the JAX
paged engine on the same requests.
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
from repro_torch.serve.scheduler import HOT_BYPASS_CAP, Scheduler

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


def _shared_reqs(n=4, prefix_len=40, tail=5, max_new=6, cls=Request, **kw):
    """One common prefix (2 full 16-token blocks + an 8-token split
    block), n distinct tails: every follower COWs the split block."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 250, prefix_len).astype(np.int32)
    return [_req(i, np.concatenate(
                [prefix,
                 ((np.arange(tail) * (i + 3) + i) % 250).astype(np.int32)]),
                cls, max_new_tokens=max_new, **kw)
            for i in range(n)]


def _port(served, **kw):
    return ServeEngine(t_get_reduced_config("qwen2.5-3b"), served[2],
                       weights_layout="w4a8", device="cpu", **kw)


class TestBatchedTailParity:
    ENGINE = dict(slots=6, cache_len=64, kv_layout="paged", block_size=16,
                  num_blocks=48, max_seq_len=96)

    def _run(self, served, tail_batch, reqs, jax_ref=False):
        """The first request warms the prefix cache; the rest arrive as
        one burst of prefix hits."""
        if jax_ref:
            eng = JServeEngine(served[0], served[1], weights_layout="w4a8",
                               w4a8_backend="ref", tail_batch=tail_batch,
                               **self.ENGINE)
        else:
            eng = _port(served, tail_batch=tail_batch, **self.ENGINE)
        eng.submit(reqs[0])
        eng.run_until_drained()
        for r in reqs[1:]:
            eng.submit(r)
        stats = eng.run_until_drained()
        assert all(r.done for r in reqs)
        return [r.generated for r in reqs], stats

    def test_burst_parity_greedy_with_cow_at_split_block(self, served):
        """Three simultaneous prefix-hit tails ride one wave and produce
        the tokens of the one-tail-per-step path; each follower's first
        window writes into the shared split block, so the COW clones
        happen during the wave."""
        g_wave, s_wave = self._run(served, 0, _shared_reqs())
        g_ser, s_ser = self._run(served, 1, _shared_reqs())
        assert g_wave == g_ser
        assert s_wave["prefix_hit_tokens"] == s_ser["prefix_hit_tokens"] > 0
        assert s_wave["cow_copies"] >= 3 and s_ser["cow_copies"] >= 3
        # the wave collapses the followers' admissions into one call
        assert s_wave["prefill_calls"] < s_ser["prefill_calls"]
        assert s_wave["tail_waves"] < s_ser["tail_waves"]
        _, s_ref = self._run(served, 0, _shared_reqs(cls=JRequest),
                             jax_ref=True)
        for k in ("prefix_hit_tokens", "cow_copies", "prefill_calls",
                  "prefill_chunks"):
            assert s_wave[k] == s_ref[k], k

    def test_burst_parity_sampled(self, served):
        """The same burst with temperature + top-k sampling: each
        request's key stream is independent of the wave packing."""
        kw = dict(max_new=8, temperature=0.8, top_k=8, seed=11)
        g_wave, _ = self._run(served, 0, _shared_reqs(**kw))
        g_ser, _ = self._run(served, 1, _shared_reqs(**kw))
        assert g_wave == g_ser
        assert len({t for s in g_wave for t in s}) > 4     # varied

    def test_two_long_prompts_share_one_wave(self, served):
        """Chunked prefill is not one prompt at a time: two long prompts
        advance window by window in the same wave and match the
        serialized engine's tokens."""
        def reqs(cls=Request):
            return [_req(0, np.arange(40, dtype=np.int32) % 250, cls,
                         max_new_tokens=4),
                    _req(1, (np.arange(36) * 3 % 250).astype(np.int32), cls,
                         max_new_tokens=4)]

        def run(tail_batch, jax_ref=False):
            kw = dict(self.ENGINE, tail_batch=tail_batch, prefill_chunk=16,
                      prefix_cache=False, max_seq_len=128)
            if jax_ref:
                eng = JServeEngine(served[0], served[1],
                                   weights_layout="w4a8",
                                   w4a8_backend="ref", **kw)
            else:
                eng = _port(served, **kw)
            rs = reqs(JRequest if jax_ref else Request)
            for r in rs:
                eng.submit(r)
            stats = eng.run_until_drained()
            assert all(r.done for r in rs)
            return [r.generated for r in rs], stats

        g_wave, s_wave = run(0)
        g_ser, s_ser = run(1)
        assert g_wave == g_ser
        # the same windows computed either way, in fewer waves batched
        assert s_wave["prefill_chunks"] == s_ser["prefill_chunks"] == 6
        assert s_wave["tail_waves"] == 3 < s_ser["tail_waves"]
        _, s_ref = run(0, jax_ref=True)
        for k in ("prefill_chunks", "prefill_calls",
                  "prompt_tokens_prefilled"):
            assert s_wave[k] == s_ref[k], k

    def test_tail_batch_validation(self, served):
        with pytest.raises(ValueError, match="tail_batch"):
            _port(served, slots=2, cache_len=64, kv_layout="paged",
                  tail_batch=3)


class TestPrefixAffinity:
    def test_group_key_orders_chain_sharers_back_to_back(self):
        """Requests with equal non-None keys are pulled behind the
        group's first occurrence; keyless requests keep their rank."""
        s = Scheduler("fcfs")
        reqs = [_req(i, np.arange(4) + i) for i in range(5)]
        for r in reqs:
            s.submit(r)
        key = {0: "a", 1: None, 2: "b", 3: "a", 4: "b"}.get
        ordered = s._ordered(group_key=lambda r: key(r.uid))
        assert [r.uid for r in ordered] == [0, 3, 1, 2, 4]
        picked = s.select(3, group_key=lambda r: key(r.uid))
        assert [r.uid for r in picked] == [0, 3, 1]

    def test_hot_bypass_is_starvation_bounded(self):
        """A steady stream of hot-chain sharers may jump the FCFS head
        only HOT_BYPASS_CAP times; then the head orders first again."""
        s = Scheduler("fcfs")
        stranger = _req(999, np.arange(4))
        s.submit(stranger)
        gk = (lambda r: "chain" if r.uid != 999 else None)
        for i in range(HOT_BYPASS_CAP + 2):
            sharer = _req(i, np.arange(4) + 100)
            s.submit(sharer)
            head = s.first(group_key=gk, hot={"chain"})
            if i < HOT_BYPASS_CAP:
                assert head is sharer          # hot jumps the stranger
                s.take(sharer)
            else:
                assert head is stranger        # bound reached: head wins
        s.take(stranger)                       # head admitted: bound resets
        assert s.first(group_key=gk, hot={"chain"}).uid != 999

    def test_engine_admits_chain_sharers_before_stranger(self, served):
        """With affinity on, a late request extending the cached chain is
        admitted in the same tail wave as an earlier sharer although a
        chain-less request sits between them in FCFS order."""
        eng = _port(served, slots=2, cache_len=64, kv_layout="paged",
                    block_size=16, num_blocks=32, max_seq_len=96)
        warm = _shared_reqs(1)[0]
        eng.submit(warm)
        eng.run_until_drained()
        sharers = _shared_reqs(3)[1:]       # uids 1, 2: extend the chain
        stranger = _req(7, (np.arange(12) * 13 % 250).astype(np.int32),
                        max_new_tokens=4)
        eng.submit(sharers[0])
        eng.submit(stranger)                # FCFS-between the two sharers
        eng.submit(sharers[1])
        eng.run_until_drained()
        assert all(r.done for r in sharers + [stranger])
        t = {r.uid: r._timing.admit_t for r in sharers + [stranger]}
        assert max(t[1], t[2]) < t[7]       # sharers first, back-to-back


class TestWrittenAccounting:
    def test_written_tracks_device_n_gen_exactly(self, served):
        """After every engine step the host ``_written`` mirror of each
        resident equals prompt + n_gen - 1 (the newest sampled token's KV
        is not yet committed)."""
        eng = _port(served, slots=4, cache_len=64, kv_layout="paged",
                    block_size=8, num_blocks=32, max_seq_len=96,
                    decode_block=4, prefill_chunk=16)
        reqs = [_req(0, np.arange(6, dtype=np.int32), max_new_tokens=17),
                _req(1, np.arange(30, dtype=np.int32) % 250,
                     max_new_tokens=5),              # chunked: arms mid-run
                _req(2, np.arange(9, dtype=np.int32) + 3,
                     max_new_tokens=2)]              # finishes mid-chunk
        for r in reqs:
            eng.submit(r)
        for _ in range(40):
            eng.step()
            n_gen = eng.state["n_gen"].numpy()
            for s, r in eng._slot_req.items():
                assert eng._written[s] == len(r.prompt) + int(n_gen[s]) - 1
            if all(r.done for r in reqs):
                break
        assert all(r.done for r in reqs)
        assert eng.alloc.allocated_blocks == 0
        eng.alloc.check()
