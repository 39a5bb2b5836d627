"""The port's asyncio frontend, SLO admission and HTTP endpoint (CPU, plain
versions) against the JAX package's.

Mirrors ``tests/test_frontend.py`` on reduced qwen2.5-3b with its
fixtures' shapes (2-4 slots, cache 64, blocks of 8 / 16, decode_block 4),
under w4a8 with calibrated weights (the streams vary). The reference runs
as ``tests/test_torch_engine.py`` runs it: ``w4a8_backend="ref"``,
compiled where only scheduling is compared and op by op where token
values are. The frontend steps its engine in a worker thread, where the
thread-local ``jax.disable_jit`` context does not reach, so op-by-op runs
set the global flag (``_op_by_op``).

Tolerance: everything is exact.
- Scheduler: the same queue under a fixed ``now`` gives the same
  ``fcfs`` / ``sjf`` / ``edf`` order and the same ``shed_overdue`` result
  (reject and downgrade) in both schedulers.
- Shed sets: an over-capacity burst sheds the same uids in both engines
  with the TTFT predictor's rates fixed by hand (the decisions then do
  not depend on the CPU's speed: the margins are seconds).
- Streams: spans come at ``decode_block`` granularity; the frontend's
  streams equal the port's own batch drain bitwise, greedy and sampled,
  and equal the JAX frontend's streams run op by op. Greedy equality of a
  reduced model is weak evidence alone; ``tests/test_torch_engine.py``
  holds the same engine's decode logits bitwise to the op-by-op
  reference.
- HTTP: the same requests give the same JSON bodies (blocking, the SSE
  stream's tokens and finish reason, 400, 404 and 503 when shed) from
  both packages' ``ServeHTTP``.
- The ``decode_block="auto"`` rule, fed fixed chunk times, picks what the
  reference's probe picks, and its memo hits on a second engine.
"""
import asyncio
import json
import threading
from contextlib import contextmanager
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import init_params as jax_init_params
from repro.serve import engine as jengine_mod
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.frontend import AsyncFrontend as JAsyncFrontend
from repro.serve.http import ServeHTTP as JServeHTTP
from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine, pick_decode_block
from repro_torch.serve.frontend import AsyncFrontend
from repro_torch.serve.http import ServeHTTP
from repro_torch.serve.scheduler import (BEST_EFFORT_PRIORITY, POLICIES,
                                         Scheduler)

POLICY = "A8d-C8-W4"
EDF = dict(slots=2, cache_len=64, kv_layout="paged", block_size=16,
           num_blocks=16, max_seq_len=64, decode_block=4,
           sched_policy="edf", slo_shed="reject")
TIGHT = dict(slots=4, cache_len=64, kv_layout="paged", block_size=8,
             num_blocks=8, max_seq_len=96, decode_block=4,
             admission="optimistic", prefix_cache=False,
             sched_policy="edf", slo_shed="reject")


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


def port_engine(served, **kw):
    return ServeEngine(t_get_reduced_config("qwen2.5-3b"), served[2],
                       weights_layout="w4a8", device="cpu",
                       **{**EDF, **kw})


def jax_engine(served, **kw):
    return JServeEngine(served[0], served[1], weights_layout="w4a8",
                        w4a8_backend="ref", **{**EDF, **kw})


@pytest.fixture(scope="module")
def eng(served):
    """Shared EDF engine of the port; tests reset() it."""
    return port_engine(served)


@pytest.fixture(scope="module")
def jeng(served):
    """The same engine of the JAX package (compiled programs survive
    resets, so the module pays each compile once)."""
    return jax_engine(served)


@contextmanager
def _op_by_op():
    jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_jit", False)


def _req(cls, uid, plen, max_new=8, **kw):
    rng = np.random.default_rng(100 + uid)
    return cls(uid=uid, prompt=rng.integers(0, 250, plen).astype(np.int32),
               max_new_tokens=max_new, **kw)


def _queue(seed, n=12):
    """(plen, priority, deadline_ms) of a mixed queue: three priority
    classes, a third of the requests without a deadline."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dl = None if rng.random() < 0.33 else float(rng.integers(1, 40)) * 50
        out.append((int(rng.integers(4, 30)), int(rng.integers(0, 3)), dl))
    return out


def _both_schedulers(policy, queue, now=0.0):
    """The same queue in the port's and the reference's scheduler."""
    out = []
    for sched_cls, req_cls in ((Scheduler, Request), (JScheduler, JRequest)):
        s = sched_cls(policy)
        for uid, (plen, pri, dl) in enumerate(queue):
            s.submit(_req(req_cls, uid, plen, priority=pri, deadline_ms=dl),
                     now=now)
        out.append(s)
    return out


def _drain_order(s, n=3):
    order = []
    while s.pending:
        order.append([r.uid for r in s.select(n)])
    return order


class TestSchedulerSLO:
    """Host-side EDF, SJF and shed semantics (deterministic clock)."""

    def test_edf_orders_by_priority_then_deadline_then_arrival(self):
        for sched_cls, cls in ((Scheduler, Request), (JScheduler, JRequest)):
            s = sched_cls("edf")
            reqs = [_req(cls, 0, 8, priority=5), _req(cls, 1, 8, priority=5),
                    _req(cls, 2, 8, priority=0, deadline_ms=9000.0),
                    _req(cls, 3, 8, priority=0, deadline_ms=1000.0)]
            for r in reqs:
                s.submit(r, now=0.0)
            assert [r.uid for r in s.select(4)] == [3, 2, 0, 1]

    @pytest.mark.parametrize("policy", POLICIES)
    def test_policy_order_matches_reference(self, policy):
        mine, ref = _both_schedulers(policy, _queue(7))
        assert mine.first().uid == ref.first().uid
        assert _drain_order(mine) == _drain_order(ref)

    def test_shed_reject_accounts_backlog_in_policy_order(self):
        """predict = 1 s per 10 prompt tokens: the urgent head (0.8 s)
        meets its 1 s deadline, the same deadline behind it (1.6 s) is
        shed and its work leaves the backlog, so a 3 s deadline behind
        survives."""
        for sched_cls, cls in ((Scheduler, Request), (JScheduler, JRequest)):
            s = sched_cls("edf")
            a, b, c = (_req(cls, i, 8, deadline_ms=d)
                       for i, d in enumerate((1000.0, 1000.0, 3000.0)))
            for r in (a, b, c):
                s.submit(r, now=0.0)
            shed = s.shed_overdue(lambda toks: toks / 10.0, "reject",
                                  now=0.0)
            assert shed == [b]
            assert s.shed_rejected == 1 and s.pending == 2
            assert s.select(3) == [a, c]

    def test_shed_downgrade_demotes_to_best_effort(self):
        for sched_cls, cls in ((Scheduler, Request), (JScheduler, JRequest)):
            s = sched_cls("edf")
            hopeless = _req(cls, 0, 8, deadline_ms=1.0)
            ontime = _req(cls, 1, 8, deadline_ms=60000.0)
            s.submit(hopeless, now=0.0)
            s.submit(ontime, now=0.0)
            assert s.shed_overdue(lambda t: 1.0, "downgrade", now=0.0) == []
            assert s.shed_downgraded == 1
            assert hopeless.deadline_ms is None
            assert hopeless.priority == BEST_EFFORT_PRIORITY
            assert s.shed_overdue(lambda t: 1.0, "downgrade", now=0.0) == []
            assert s.select(2) == [ontime, hopeless]

    @pytest.mark.parametrize("mode", ["reject", "downgrade"])
    @pytest.mark.parametrize("policy", ["edf", "sjf"])
    def test_shed_overdue_matches_reference(self, mode, policy):
        """A 12-request mixed queue, 1 s per 100 prompt tokens, judged at
        now = 0.2 s: the same requests are shed or demoted, the counters
        agree and what remains drains in the same order."""
        mine, ref = _both_schedulers(policy, _queue(11))
        got = [s.shed_overdue(lambda toks: toks / 100.0, mode, now=0.2)
               for s in (mine, ref)]
        assert [r.uid for r in got[0]] == [r.uid for r in got[1]]
        for s in (mine, ref):
            s.demoted = sorted(r.uid for r in s._queue
                               if r.priority == BEST_EFFORT_PRIORITY)
        assert mine.demoted == ref.demoted
        assert (mine.shed_rejected, mine.shed_downgraded) == \
            (ref.shed_rejected, ref.shed_downgraded)
        assert mine.shed_rejected + mine.shed_downgraded > 0
        assert mine.stats()["requests_shed"] == mine.shed_rejected
        assert _drain_order(mine) == _drain_order(ref)


def _serve_spans(engine, cls, reqs):
    """Serve ``reqs`` with an on_tokens recorder; returns the spans as
    (uid, tokens, done) in arrival order."""
    spans = []
    for r in reqs:
        r.on_tokens = lambda rr, toks, done: spans.append(
            (rr.uid, [int(t) for t in toks], done))
        engine.submit(r)
    engine.run_until_drained()
    return spans


class TestEngineStreaming:
    def test_incremental_spans_at_decode_block_granularity(self, eng, jeng):
        """Tokens drain through on_tokens as decode chunks harvest:
        several spans no wider than decode_block, not one burst at
        finish, concatenating to exactly req.generated; the reference
        engine cuts the same spans."""
        lens = []
        for engine, cls in ((eng, Request), (jeng, JRequest)):
            engine.reset()
            r = _req(cls, 0, 12, max_new=12)
            spans = _serve_spans(engine, cls, [r])
            assert r.done and len(r.generated) == 12
            assert [t for _, s, _ in spans for t in s] == list(r.generated)
            assert sum(1 for *_, done in spans if done) == 1
            assert spans[-1][2]
            assert len([s for _, s, _ in spans if s]) >= 3
            assert all(len(s) <= engine.decode_block
                       for _, s, _ in spans[1:])
            lens.append([(len(s), done) for _, s, done in spans])
        assert lens[0] == lens[1]

    def test_edf_priority_order_controls_admission(self, eng, jeng):
        """4 queued requests, 2 slots: the priority-0 pair gets its first
        tokens in wave one, the priority-5 pair waits, in both engines."""
        seen = []
        for engine, cls in ((eng, Request), (jeng, JRequest)):
            engine.reset()
            reqs = [_req(cls, i, 8, max_new=4, priority=pri,
                         deadline_ms=60000.0 if pri == 0 else None)
                    for i, pri in enumerate((5, 5, 0, 0))]
            spans = _serve_spans(engine, cls, reqs)
            assert all(r.done for r in reqs)
            first = []
            for uid, toks, _ in spans:
                if toks and uid not in first:
                    first.append(uid)
            assert set(first[:2]) == {2, 3}
            seen.append(first)
        assert seen[0] == seen[1]


STREAM_SPECS = [dict(plen=10, temperature=0.0, top_k=0, seed=0),
                dict(plen=13, temperature=0.7, top_k=4, seed=3),
                dict(plen=9, temperature=0.0, top_k=0, seed=0),
                dict(plen=17, temperature=0.7, top_k=8, seed=9)]


def _stream_prompts():
    return [np.random.default_rng(40 + i).integers(0, 250, s["plen"])
            .astype(np.int32) for i, s in enumerate(STREAM_SPECS)]


def _frontend_streams(frontend_cls, engine, prompts):
    async def run():
        async with frontend_cls(engine) as fe:
            handles = [await fe.submit(
                list(map(int, prompts[i])), max_new_tokens=8,
                temperature=s["temperature"], top_k=s["top_k"],
                seed=s["seed"]) for i, s in enumerate(STREAM_SPECS)]
            return [(await h.tokens(), h) for h in handles]
    engine.reset()
    return asyncio.run(run())


class TestFrontendStreaming:
    def test_stream_parity_vs_batch_drain_greedy_and_sampled(self, eng,
                                                             jeng):
        """Each RequestStream's tokens equal a batch drain of the same
        requests (same uids: the frontend counts from 0), greedy and
        sampled, and equal the JAX frontend's streams run op by op."""
        prompts = _stream_prompts()
        streamed = _frontend_streams(AsyncFrontend, eng, prompts)
        for toks, h in streamed:
            assert h.submit_t <= h.first_token_t <= h.finish_t
            assert not h.shed and len(toks) == 8
            assert all(type(t) is int for t in toks)
        eng.reset()
        batch = [Request(uid=i, prompt=prompts[i], max_new_tokens=8,
                         temperature=s["temperature"], top_k=s["top_k"],
                         seed=s["seed"]) for i, s in enumerate(STREAM_SPECS)]
        for r in batch:
            eng.submit(r)
        eng.run_until_drained()
        mine = [t for t, _ in streamed]
        assert mine == [r.generated for r in batch]
        assert len({tuple(t) for t in mine}) == len(mine)
        with _op_by_op():
            ref = _frontend_streams(JAsyncFrontend, jeng, prompts)
        assert mine == [t for t, _ in ref]

    def test_overcapacity_burst_sheds_hopeless_keeps_ontime(self, eng):
        """A burst beyond capacity with unmeetable deadlines: the hopeless
        requests shed (empty closed streams, engine counters), the
        deadline-less ones all serve in full."""
        eng.reset()

        async def run():
            async with AsyncFrontend(eng) as fe:
                ontime = [await fe.submit([7 + i] * 8, max_new_tokens=6)
                          for i in range(2)]
                hopeless = [await fe.submit([40 + i] * 8, max_new_tokens=6,
                                            deadline_ms=1e-3)
                            for i in range(3)]
                o = [(await h.tokens(), h) for h in ontime]
                s = [(await h.tokens(), h) for h in hopeless]
                stats = await fe.stats()
            return o, s, stats

        ontime, hopeless, stats = asyncio.run(run())
        assert all(not h.shed and len(t) == 6 for t, h in ontime)
        assert all(h.shed and t == [] and h.request.done
                   for t, h in hopeless)
        assert stats["requests_shed"] == 3
        assert stats["requests_finished"] == 2
        assert json.loads(json.dumps(stats)) == stats

    @pytest.mark.parametrize("mode", ["reject", "downgrade"])
    def test_burst_sheds_the_same_uids_as_reference(self, served, mode):
        """12 requests in one burst through each package's frontend, with
        the predictor fixed at 10 s a prompt token (``_note_rate``
        switched off): the same uids are shed (reject) or demoted
        (downgrade), the on-time ones serve in full, and the first tokens
        come in the same order. Every decision clears its deadline by at
        least 16 s, far beyond the run's own elapsed time (the JAX
        engine's compiles included), so the CPU's speed cannot move it."""
        queue = [(8 + 4 * (i % 3), i % 2, (None, 3e5, 8e5)[i % 3])
                 for i in range(12)]
        out = []
        for engine_fn, fe_cls in ((port_engine, AsyncFrontend),
                                  (jax_engine, JAsyncFrontend)):
            engine = engine_fn(served, slo_shed=mode)
            engine._note_rate = lambda attr, value: None
            engine._pred_per_tok, engine._pred_round_s = 10.0, 0.0
            first = []

            async def run():
                async with fe_cls(engine) as fe:
                    hs = [await fe.submit([3 + i] * plen, max_new_tokens=4,
                                          priority=pri, deadline_ms=dl)
                          for i, (plen, pri, dl) in enumerate(queue)]
                    for h in hs:
                        h.request.on_tokens = _first_recorder(
                            h.request.on_tokens, first)
                    toks = [await h.tokens() for h in hs]
                    return hs, toks, await fe.stats()

            hs, toks, stats = asyncio.run(run())
            shed = [h.request.uid for h in hs if h.shed]
            demoted = [h.request.uid for h in hs
                       if h.request.priority == BEST_EFFORT_PRIORITY]
            assert all(len(t) == 4 for t, h in zip(toks, hs) if not h.shed)
            out.append((shed, demoted, first, stats["requests_shed"],
                        stats["requests_downgraded"]))
        assert out[0] == out[1]
        shed, demoted = out[0][:2]
        assert (shed if mode == "reject" else demoted) and not (
            demoted if mode == "reject" else shed)


def _first_recorder(inner, first):
    def on_tokens(req, toks, done):
        if len(toks) and req.uid not in first:
            first.append(req.uid)
        inner(req, toks, done)
    return on_tokens


class TestDeadlineAcrossSwap:
    def test_deadline_and_stream_survive_preempt_resume(self, served):
        """An over-committed optimistic pool preempts residents mid-stream;
        after swap-in each request finishes its stream on the same handle
        with its deadline and priority intact and exactly the tokens of an
        uninterrupted solo run. The swap accounting equals the JAX
        engine's on the same requests."""
        eng = port_engine(served, **TIGHT)
        prompts = [[30 + 7 * i] * 10 for i in range(3)]

        async def run(engine, fe_cls):
            async with fe_cls(engine) as fe:
                handles = [await fe.submit(p, max_new_tokens=30,
                                           deadline_ms=600000.0,
                                           priority=i % 2)
                           for i, p in enumerate(prompts)]
                toks = [await h.tokens() for h in handles]
                stats = await fe.stats()
            return handles, toks, stats

        handles, toks, stats = asyncio.run(run(eng, AsyncFrontend))
        assert stats["preemptions"] >= 1
        assert stats["swap_out_bytes"] == stats["swap_in_bytes"] > 0
        assert stats["requests_shed"] == 0
        for i, (h, t) in enumerate(zip(handles, toks)):
            assert len(t) == 30 and t == h.request.generated
            assert not h.shed and h.request.done
            assert h.request.deadline_ms == 600000.0
            assert h.request.priority == i % 2
            assert h.submit_t <= h.first_token_t <= h.finish_t
            solo = port_engine(served, slots=1, kv_layout="paged",
                               block_size=8, num_blocks=32, max_seq_len=96,
                               prefix_cache=False)
            r = Request(uid=i, prompt=np.asarray(prompts[i], np.int32),
                        max_new_tokens=30)
            solo.submit(r)
            solo.run_until_drained()
            assert t == r.generated
        _, _, jstats = asyncio.run(run(jax_engine(served, **TIGHT),
                                       JAsyncFrontend))
        for k in ("preemptions", "swap_out_bytes", "swap_in_bytes",
                  "requests_finished", "tokens_out"):
            assert stats[k] == jstats[k], k


async def _sse_completion(port, payload):
    """Minimal SSE client: returns (spans, finish_reason)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(dict(payload, stream=True)).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\n"
                 b"Content-Length: %d\r\n\r\n" % len(body) + body)
    await writer.drain()
    status = (await reader.readline()).split()
    assert status[1] == b"200", status
    while (await reader.readline()) not in (b"\r\n", b"\n"):
        pass
    spans, reason, done = [], None, False
    async for raw in reader:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        data = line[len("data: "):]
        if data == "[DONE]":
            done = True
            break
        choice = json.loads(data)["choices"][0]
        spans.append(choice["token_ids"])
        reason = choice["finish_reason"]
    writer.close()
    await writer.wait_closed()
    assert done, "stream ended without data: [DONE]"
    return spans, reason


async def _json_request(port, method, path, payload=None, raw_body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = raw_body if raw_body is not None else (
        json.dumps(payload).encode() if payload is not None else b"")
    writer.write(b"%s %s HTTP/1.1\r\nContent-Length: %d\r\n\r\n"
                 % (method.encode(), path.encode(), len(body)) + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    header, _, payload = raw.partition(b"\r\n\r\n")
    return int(header.split()[1]), json.loads(payload)


PROMPT = [11, 42, 7, 99, 3, 18]


def _http_session(frontend_cls, http_cls, engine):
    """One server, the reference test's requests plus 404 and a shed
    request (503): returns every status and body."""
    async def run():
        async with frontend_cls(engine) as fe:
            async with http_cls(fe, port=0) as srv:
                sse = await _sse_completion(
                    srv.port, {"prompt": PROMPT, "max_tokens": 8,
                               "temperature": 0.6, "top_k": 4, "seed": 5})
                out = {"sse": sse}
                out["blocking"] = await _json_request(
                    srv.port, "POST", "/v1/completions",
                    {"prompt": PROMPT, "max_tokens": 8})
                out["health"] = await _json_request(srv.port, "GET",
                                                    "/health")
                out["bad_prompt"] = await _json_request(
                    srv.port, "POST", "/v1/completions", {"prompt": "text"})
                out["bad_json"] = await _json_request(
                    srv.port, "POST", "/v1/completions", raw_body=b"{nope")
                out["bad_knob"] = await _json_request(
                    srv.port, "POST", "/v1/completions",
                    {"prompt": PROMPT, "max_tokens": "many"})
                out["too_long"] = await _json_request(
                    srv.port, "POST", "/v1/completions",
                    {"prompt": PROMPT, "max_tokens": 64})
                out["no_route"] = await _json_request(srv.port, "GET",
                                                      "/v1/nope")
                out["shed"] = await _json_request(
                    srv.port, "POST", "/v1/completions",
                    {"prompt": PROMPT, "max_tokens": 8, "deadline_ms": 1e-3})
        return out
    engine.reset()
    return asyncio.run(run())


class TestHTTP:
    def test_sse_stream_blocking_and_errors(self, eng):
        """SSE streaming parity with a batch drain, the blocking JSON
        path, /health, 400 on a malformed body, 503 when shed."""
        out = _http_session(AsyncFrontend, ServeHTTP, eng)
        spans, reason = out["sse"]
        assert reason == "length" and sum(len(s) for s in spans) == 8
        code, body = out["blocking"]
        assert code == 200
        assert len(body["choices"][0]["token_ids"]) == 8
        assert body["usage"]["total_tokens"] == len(PROMPT) + 8
        assert out["health"] == (200, {"status": "ok"})
        assert out["bad_prompt"][0] == 400
        assert "token ids" in out["bad_prompt"][1]["error"]["message"]
        assert out["no_route"][0] == 404
        assert out["shed"][0] == 503
        assert out["shed"][1]["choices"][0]["finish_reason"] == "shed"

        eng.reset()
        ref = Request(uid=0, prompt=np.asarray(PROMPT, np.int32),
                      max_new_tokens=8, temperature=0.6, top_k=4, seed=5)
        eng.submit(ref)
        eng.run_until_drained()
        assert [t for s in spans for t in s] == ref.generated

    def test_http_bodies_match_reference(self, eng, jeng):
        """The same requests give the same status codes and JSON bodies
        from both servers; the SSE stream gives the same tokens and finish
        reason (its span count depends on how fast the client reads)."""
        mine = _http_session(AsyncFrontend, ServeHTTP, eng)
        with _op_by_op():
            ref = _http_session(JAsyncFrontend, JServeHTTP, jeng)
        (ms, mreason), (rs, rreason) = mine.pop("sse"), ref.pop("sse")
        assert [t for s in ms for t in s] == [t for s in rs for t in s]
        assert mreason == rreason == "length"
        assert mine == ref
        assert {k: v[0] for k, v in mine.items()} == {
            "blocking": 200, "health": 200, "bad_prompt": 400,
            "bad_json": 400, "bad_knob": 400, "too_long": 400,
            "no_route": 404, "shed": 503}


class TestDecodeBlockProbe:
    @pytest.mark.parametrize("t1, t8", [(0.010, 0.017), (0.002, 0.030),
                                        (0.050, 0.057), (0.004, 0.010),
                                        (0.0071, 0.0400), (0.020, 0.020),
                                        (0.030, 0.010)])
    def test_pick_rule_matches_reference(self, monkeypatch, t1, t8):
        """The reference's ``_probe_decode_block`` driven by a fake clock
        that advances by the chunk time of the chunk length being timed
        (its jit and device waits replaced) picks what the port's rule
        picks from the same two times."""
        clock = [0.0]
        fake = SimpleNamespace(decode_block=None, params=None)

        def jit(fn, **kw):
            def call(params, state, greedy):
                clock[0] += {1: t1, 8: t8}[fake.decode_block]
                return {"tokens": None}
            return call

        monkeypatch.setattr(jengine_mod, "jax", SimpleNamespace(
            jit=jit, block_until_ready=lambda x: x))
        monkeypatch.setattr(jengine_mod, "time", SimpleNamespace(
            perf_counter=lambda: clock[0]))
        fake._under_mesh = lambda fn: fn
        fake._decode_chunk = None
        fake._probe_state = lambda: None
        ref = JServeEngine._probe_decode_block(fake)
        assert pick_decode_block(t1, t8) == ref

    def test_probe_memo_hits_on_a_second_engine(self, served, monkeypatch):
        """The first auto engine probes (two state allocations: the
        engine's and the reset after the probe, which ran on the
        engine's own cache), the second reuses the memo; both pick a
        candidate, report mode "auto" and serve the streams a fixed
        decode_block serves."""
        monkeypatch.setattr(engine_mod, "_PROBE_CACHE", {})
        probes, blanks = [], []
        probe, blank = ServeEngine._probe_decode_block, \
            ServeEngine._blank_state
        monkeypatch.setattr(ServeEngine, "_probe_decode_block",
                            lambda self: probes.append(1) or probe(self))
        monkeypatch.setattr(ServeEngine, "_blank_state",
                            lambda self: blanks.append(1) or blank(self))
        prompts = _stream_prompts()
        streams = []
        for n_probes, n_blanks, kw in ((1, 2, dict(decode_block="auto")),
                                       (1, 3, dict(decode_block="auto")),
                                       (1, 4, dict(decode_block=4))):
            engine = port_engine(served, **kw)
            assert (len(probes), len(blanks)) == (n_probes, n_blanks)
            if kw["decode_block"] == "auto":
                pr = engine.decode_block_probe
                assert engine.decode_block == pr["pick"] in (4, 8, 16, 32)
                assert pr["pick"] == pick_decode_block(pr["t1_s"],
                                                       pr["t8_s"])
                st = engine.stats()
                assert st["decode_block_mode"] == "auto"
                assert st["decode_steps"] == st["tokens_out"] == 0
            reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                engine.submit(r)
            engine.run_until_drained()
            streams.append([r.generated for r in reqs])
        assert streams[0] == streams[1] == streams[2]

    def test_spec_engine_skips_the_probe(self, served):
        from repro_torch.serve.spec import SpecConfig
        engine = port_engine(served, decode_block="auto",
                             spec=SpecConfig(k=3, draft_layers=1))
        assert engine.decode_block_probe is None
        assert engine.decode_block == 4
        assert engine.stats()["decode_block_mode"] == "spec"


def test_step_worker_binds_the_engines_card(monkeypatch):
    """CUDA's current device is per thread: the frontend's step worker
    sets the card holding the engine's state before its first task (no
    call on the CPU)."""
    bound = []
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    for dev, want in ((torch.device("cuda", 1), [torch.device("cuda", 1)]),
                      (torch.device("cpu"), [])):
        bound.clear()
        fake = SimpleNamespace(state={"tokens": SimpleNamespace(device=dev)})
        fe = AsyncFrontend(fake)
        fe._executor.submit(threading.current_thread).result()
        fe._executor.shutdown(wait=True)
        assert bound == want
