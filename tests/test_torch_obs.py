"""The port's serve observability (tracer, Perfetto export, /v1/metrics,
the serve CLI's --trace / --metrics) against the JAX package's.

Mirrors ``tests/test_obs.py`` on reduced qwen2.5-3b (w4a8, calibrated
weights, CPU plain versions): the ring bound and the disabled no-op
contract, span nesting over a served mixed workload (paged, spec, a
tight optimistic pool that preempts), the request timelines, Chrome
``trace_event`` validity, trace-vs-scheduler latency reconciliation,
``stats()`` as JSON, Prometheus rendering and an HTTP scrape mid-serve.

Tolerance: exact.
- ``chrome_trace`` of one fixed record list gives the same JSON from both
  exporters but for ``otherData.generator``, which names the package; the
  report functions give the same results on that dict.
- ``Histogram`` buckets and quantiles, and ``render(stats)`` of one stats
  dict, give the same text from both packages; ``parse_prometheus``
  rejects the same malformed lines.
- On the tight pool without spec, each request's lifecycle event names
  and the preemption and swap accounting equal the compiled JAX engine's:
  they depend on token counts, not token values. (With spec the accepted
  counts depend on token values, and the compiled reference flips greedy
  near-ties; the port's spec run equals the op-by-op reference's, victims
  included, which is too slow to repeat here.)
- The compile split: the port has no jit and builds its kernels before
  any timed wave, so its engine marks no span ``compiled`` and the split
  is execute time only; a span that does carry ``compiled`` is split as
  the reference splits it.
"""
import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import init_params as jax_init_params
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs.trace import Tracer as JTracer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.obs.export import (chrome_trace, compile_split, load_trace,
                                    render_report, request_attribution,
                                    step_breakdown, write_trace)
from repro_torch.obs.metrics import (Histogram, ServeMetrics,
                                     parse_prometheus)
from repro_torch.obs.trace import NULL_TRACER, SPAN_NAMES, Tracer
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.frontend import AsyncFrontend
from repro_torch.serve.http import ServeHTTP
from repro_torch.serve.spec import SpecConfig

ROOT = Path(__file__).resolve().parents[1]
POLICY = "A8d-C8-W4"
MIXED = dict(slots=4, cache_len=64, kv_layout="paged", block_size=8,
             num_blocks=8, max_seq_len=96, decode_block=4,
             admission="optimistic", prefix_cache=False)


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


def _req(cls, uid, plen, max_new=8, **kw):
    rng = np.random.default_rng(300 + uid)
    return cls(uid=uid, prompt=rng.integers(0, 250, plen).astype(np.int32),
               max_new_tokens=max_new, **kw)


@pytest.fixture(scope="module")
def traced_run(served):
    """One traced mixed run (paged + spec + tight pool -> preemption),
    shared by the timeline / export / report assertions."""
    tracer = Tracer()
    eng = ServeEngine(t_get_reduced_config("qwen2.5-3b"), served[2],
                      weights_layout="w4a8", device="cpu",
                      spec=SpecConfig(k=3, draft_layers=1), trace=tracer,
                      **MIXED)
    reqs = [_req(Request, i, 10, max_new=24) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    assert eng.stats()["preemptions"] >= 1, "workload must exercise swap"
    return eng, tracer, reqs


@pytest.fixture(scope="module")
def plain_runs(served):
    """The mixed workload without spec on both engines (the JAX one
    compiled): (port engine, tracer), (JAX engine, tracer)."""
    cfg, params, tparams = served
    out = []
    for make, cls, tr in (
            (lambda tr: ServeEngine(t_get_reduced_config("qwen2.5-3b"),
                                    tparams, weights_layout="w4a8",
                                    device="cpu", trace=tr, **MIXED),
             Request, Tracer()),
            (lambda tr: JServeEngine(cfg, params, weights_layout="w4a8",
                                     w4a8_backend="ref", trace=tr, **MIXED),
             JRequest, JTracer())):
        eng = make(tr)
        for r in [_req(cls, i, 10, max_new=24) for i in range(3)]:
            eng.submit(r)
        eng.run_until_drained()
        out.append((eng, tr))
    return out


def _timelines(tracer):
    """{uid: [lifecycle event records]} of the requests in ``tracer``."""
    by_uid = {}
    for rec in tracer.events():
        if rec["ph"] == "event" and rec.get("uid") is not None:
            by_uid.setdefault(rec["uid"], []).append(rec)
    return by_uid


class TestTracer:
    def test_ring_bounds_memory_and_counts_evictions(self):
        tr = Tracer(capacity=8)
        for i in range(100):
            tr.event("submit", uid=i)
        assert len(tr) == 8
        assert tr.dropped == 92
        assert [r["uid"] for r in tr.events()] == list(range(92, 100))
        tr.clear()
        assert len(tr) == 0 and tr.dropped == 0

    def test_disabled_records_nothing_but_spans_still_measure(self):
        tr = Tracer(enabled=False)
        with tr.span("step") as sp:
            tr.event("submit", uid=0)
            tr.annotate(compiled="decode")
            time.sleep(0.002)
        assert sp.dt >= 0.002          # engine bookkeeping depends on dt
        assert len(tr) == 0 and tr.dropped == 0 and not tr._stack
        assert not NULL_TRACER.enabled and len(NULL_TRACER) == 0

    def test_nesting_depth_and_annotate_target_innermost(self):
        tr = Tracer()
        with tr.span("step"):
            with tr.span("decode", rows=2):
                tr.annotate(compiled="decode")
        spans = {r["name"]: r for r in tr.events()}
        assert spans["decode"]["depth"] == 1
        assert spans["step"]["depth"] == 0
        assert spans["decode"]["args"] == {"rows": 2, "compiled": "decode"}
        assert spans["step"]["t0"] <= spans["decode"]["t0"]

    def test_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            Tracer(capacity=0)


class TestServedTrace:
    def test_span_vocabulary_nesting_and_step_ordering(self, traced_run):
        """Every span the engine emits is in the vocabulary, steps are
        contiguous ascending, and wave spans sit inside their step."""
        _, tracer, _ = traced_run
        spans = [r for r in tracer.events() if r["ph"] == "span"]
        assert tracer.dropped == 0
        names = {s["name"] for s in spans}
        assert names <= set(SPAN_NAMES)
        assert {"step", "prefill_wave", "spec_draft", "spec_verify",
                "swap_out", "swap_in", "harvest", "sync"} <= names
        steps = {s["step"]: (s["t0"], s["t0"] + s["dur"])
                 for s in spans if s["name"] == "step"}
        assert sorted(steps) == list(range(1, len(steps) + 1))
        eps = 1e-4
        for s in spans:
            if s["name"] == "step" or s["step"] not in steps:
                continue
            lo, hi = steps[s["step"]]
            assert lo - eps <= s["t0"] <= s["t0"] + s["dur"] <= hi + eps, \
                f"{s['name']} escapes its step window"
            assert s["depth"] >= 1

    def test_request_lifecycle_and_swap_timeline(self, traced_run):
        """Each request's events arrive in causal order; a preempted
        request runs submit -> ... -> preempted -> swap_resumed ->
        finished."""
        _, tracer, reqs = traced_run
        by_uid = _timelines(tracer)
        swapped = 0
        for uid, evs in by_uid.items():
            names = [e["name"] for e in evs]
            ts = [e["t"] for e in evs]
            assert ts == sorted(ts)
            assert names[:2] == ["submit", "queued"]
            assert names[-1] == "finished"
            assert names.index("admitted") < names.index("first_token")
            if "preempted" in names:
                swapped += 1
                assert names.index("preempted") \
                    < names.index("swap_resumed") < names.index("finished")
                pre = evs[names.index("preempted")]
                res = evs[names.index("swap_resumed")]
                assert pre["args"]["bytes"] == res["args"]["bytes"] > 0
        assert swapped >= 1

    def test_lifecycles_and_swap_accounting_match_reference(self,
                                                            plain_runs):
        """Without spec, every request's event names (preemptions and
        restores included) and the swap accounting equal the JAX
        engine's on the same tight pool."""
        (eng, tracer), (jeng, jtracer) = plain_runs
        names = [{u: [e["name"] for e in evs]
                  for u, evs in _timelines(tr).items()}
                 for tr in (tracer, jtracer)]
        assert names[0] == names[1]
        assert any("preempted" in n for n in names[0].values())
        st, jst = eng.stats(), jeng.stats()
        for k in ("preemptions", "swap_out_bytes", "swap_in_bytes",
                  "decode_steps", "tokens_out", "requests_finished",
                  "prefill_calls", "prompt_tokens_prefilled"):
            assert st[k] == jst[k], k

    def test_chrome_export_is_valid_and_pairs_async_spans(self, traced_run):
        _, tracer, reqs = traced_run
        trace = chrome_trace(tracer)
        assert json.loads(json.dumps(trace)) == trace
        ev = trace["traceEvents"]
        procs = {e["args"]["name"] for e in ev
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert procs == {"engine waves", "requests"}
        tracks = {e["args"]["name"] for e in ev
                  if e["ph"] == "M" and e["name"] == "thread_name"}
        assert "step" in tracks and "spec_verify" in tracks
        assert all(e["ts"] >= 0 and e["dur"] >= 0
                   for e in ev if e["ph"] == "X")
        for r in reqs:
            b = [e for e in ev if e["ph"] == "b" and e.get("id") == r.uid]
            e_ = [e for e in ev if e["ph"] == "e" and e.get("id") == r.uid]
            assert len(b) == 1 and len(e_) == 1
            assert "truncated" not in e_[0]["args"]
        assert trace["otherData"]["generator"] == "repro_torch.obs"
        assert trace["otherData"]["compile_variants"] == {}

    def test_chrome_trace_json_identical_to_reference(self, traced_run):
        """The port's records through both exporters: the same JSON but
        for the generator's name, and the same reports on it."""
        _, tracer, _ = traced_run
        mine = chrome_trace(tracer)
        ref = jexport.chrome_trace(tracer)
        assert ref["otherData"].pop("generator") == "repro.obs"
        assert mine["otherData"].pop("generator") == "repro_torch.obs"
        assert json.dumps(mine) == json.dumps(ref)
        for fn in ("step_breakdown", "request_attribution",
                   "compile_split", "render_report"):
            assert getattr(jexport, fn)(ref) == \
                globals()[fn](mine), fn

    def test_truncated_request_gets_synthetic_end(self):
        tr = Tracer()
        tr.event("submit", uid=7)
        tr.event("queued", uid=7)
        for export in (chrome_trace, jexport.chrome_trace):
            ends = [e for e in export(tr)["traceEvents"]
                    if e["ph"] == "e" and e.get("id") == 7]
            assert len(ends) == 1 and ends[0]["args"]["truncated"]

    def test_reconciliation_and_reports(self, traced_run):
        """Trace-side submit->finish deltas agree with the scheduler clock
        within 5%; the reports cover every phase; the compile split is
        execute time only, and a span marked ``compiled`` is split as the
        reference splits it."""
        _, tracer, reqs = traced_run
        trace = chrome_trace(tracer)
        ra = request_attribution(trace)
        assert ra["finished"] == len(reqs)
        assert ra["reconcile_max_err"] <= 0.05
        assert ra["latency"]["p95_s"] >= ra["ttft"]["p95_s"] > 0
        bd = step_breakdown(trace)
        assert bd["step"]["pct_of_step"] == pytest.approx(100.0)
        assert 0 < bd["spec_verify"]["total_s"] <= bd["step"]["total_s"]
        cs = compile_split(trace)
        assert not [e for e in trace["traceEvents"]
                    if e["ph"] == "X" and "compiled" in e["args"]]
        assert set(cs) == set(bd)
        for name, d in cs.items():
            assert d["compile_calls"] == 0 and d["compile_s"] == 0.0
            assert d["execute_calls"] == bd[name]["count"]
            assert d["execute_s"] == pytest.approx(bd[name]["total_s"])
        tr = Tracer()
        for compiled in (True, False):
            with tr.span("decode_chunk", steps=4):
                if compiled:
                    tr.annotate(compiled=True)
        marked = compile_split(chrome_trace(tr))
        assert marked == jexport.compile_split(jexport.chrome_trace(tr))
        assert marked["decode_chunk"]["compile_calls"] == 1
        assert marked["decode_chunk"]["execute_calls"] == 1
        report = render_report(trace)
        for needle in ("step-time breakdown", "request attribution",
                       "compile vs execute", "max rel err"):
            assert needle in report


class TestStatsAndMetrics:
    def test_stats_are_json_clean(self, traced_run):
        """stats() serializes with the stock JSON encoder and survives a
        round trip unchanged: no numpy or torch scalar leaks."""
        eng, _, _ = traced_run
        stats = eng.stats()
        assert json.loads(json.dumps(stats)) == stats
        for k, v in stats.items():
            assert not isinstance(v, (np.generic, torch.Tensor)), k
        for k in ("requests_shed", "requests_downgraded",
                  "decode_block_mode"):
            assert k in stats, k

    def test_histogram_buckets_and_quantiles(self):
        obs = (0.005, 0.05, 0.05, 0.5, 5.0, None)
        hs = []
        for cls in (Histogram, jmetrics.Histogram):
            h = cls("x_seconds", "t", buckets=(0.01, 0.1, 1.0))
            for v in obs:
                h.observe(v)
            hs.append(h)
        h = hs[0]
        assert h.count == 5 and h.sum == pytest.approx(5.605)
        parsed = parse_prometheus(h.render())
        assert parsed['x_seconds_bucket{le="0.01"}'] == 1
        assert parsed['x_seconds_bucket{le="1.0"}'] == 4
        assert parsed['x_seconds_bucket{le="+Inf"}'] == 5
        assert h.quantile(50) == 0.1
        assert h.quantile(99) == 1.0
        assert h.render() == hs[1].render()
        assert [h.quantile(q) for q in (1, 25, 50, 75, 95, 100)] == \
            [hs[1].quantile(q) for q in (1, 25, 50, 75, 95, 100)]
        assert h.snapshot() == hs[1].snapshot()

    @pytest.mark.parametrize("text", ["lonely_token\n",
                                      "name not_a_number\n",
                                      "x 1\n y\n", "a{le=\"1\"} one\n"])
    def test_parse_prometheus_rejects_malformed(self, text):
        for parse in (parse_prometheus, jmetrics.parse_prometheus):
            with pytest.raises(ValueError):
                parse(text)

    def test_render_matches_engine_stats(self, traced_run):
        """The scrape projection agrees with stats(), counter for counter,
        including the spec and swap families this workload exercised."""
        eng, _, _ = traced_run
        stats = eng.stats()
        parsed = parse_prometheus(eng.metrics.render(stats))
        for key, name in (("tokens_out", "serve_tokens_out_total"),
                          ("preemptions", "serve_preemptions_total"),
                          ("spec_waves", "serve_spec_waves_total"),
                          ("requests_finished",
                           "serve_requests_finished_total"),
                          ("requests_shed", "serve_requests_shed_total"),
                          ("free_blocks", "serve_free_blocks")):
            assert parsed[name] == pytest.approx(stats[key]), name
        assert parsed["serve_request_latency_seconds_count"] == \
            stats["requests_finished"]
        assert parsed["serve_ttft_seconds_count"] == len(
            eng.scheduler._timings)

    def test_render_text_identical_to_reference(self, traced_run,
                                                plain_runs):
        """``render`` of the port's and of the JAX engine's stats dict
        (with the same histogram observations) gives the same text from
        both packages' ServeMetrics."""
        eng, _, _ = traced_run
        jeng, _ = plain_runs[1]
        for stats in (eng.stats(), jeng.stats()):
            pair = (ServeMetrics(), jmetrics.ServeMetrics())
            for m in pair:
                m.observe_ttft(0.0123)
                m.observe_finished(0.5, 0.4, 9)
                m.observe_finished(2.0, None, 3)
            assert pair[0].render(stats) == pair[1].render(stats)
            assert pair[0].snapshot() == pair[1].snapshot()
        assert "serve_compile_variants" in jeng.metrics.render(jeng.stats())

    def test_observe_finished_derives_tpot(self):
        m = ServeMetrics()
        m.observe_ttft(0.02)
        m.observe_finished(0.5, 0.4, 9)          # 0.4 s over 8 tokens
        snap = m.snapshot()
        assert snap["ttft"]["count"] == snap["latency"]["count"] == 1
        assert snap["tpot"]["count"] == 1
        assert m.tpot.sum == pytest.approx(0.05)
        m.observe_finished(0.5, 0.4, 1)          # single token: no TPOT
        assert m.snapshot()["tpot"]["count"] == 1
        m.reset()
        assert m.snapshot()["latency"]["count"] == 0


async def _text_request(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET %s HTTP/1.1\r\n\r\n" % path.encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    header, _, payload = raw.partition(b"\r\n\r\n")
    lines = header.decode().split("\r\n")
    headers = dict((k.strip().lower(), v.strip()) for k, _, v in
                   (ln.partition(":") for ln in lines[1:]))
    return int(lines[0].split()[1]), headers, payload.decode()


class TestHTTPMetrics:
    def test_scrape_mid_serve_and_after_drain(self, served):
        """GET /v1/metrics parses as Prometheus text while requests are in
        flight (its counters at most the final ones) and after the drain,
        when its counters and histograms agree with GET /v1/stats."""
        eng = ServeEngine(t_get_reduced_config("qwen2.5-3b"), served[2],
                          weights_layout="w4a8", device="cpu", slots=2,
                          cache_len=64, kv_layout="paged", block_size=16,
                          num_blocks=16, max_seq_len=64, decode_block=4,
                          trace=Tracer())

        async def run():
            async with AsyncFrontend(eng) as fe:
                async with ServeHTTP(fe, port=0) as srv:
                    handles = [await fe.submit([9 + i] * 8,
                                               max_new_tokens=12)
                               for i in range(4)]
                    mid = await _text_request(srv.port, "/v1/metrics")
                    for h in handles:
                        await h.tokens()
                    done = await _text_request(srv.port, "/v1/metrics")
                    stats = await _text_request(srv.port, "/v1/stats")
            return mid, done, stats

        mid, done, (code, _, body) = asyncio.run(run())
        stats = json.loads(body)
        assert mid[0] == done[0] == code == 200
        assert done[1]["content-type"].startswith(
            "text/plain; version=0.0.4")
        pm, parsed = parse_prometheus(mid[2]), parse_prometheus(done[2])
        assert pm["serve_pending_requests"] + \
            pm["serve_resident_requests"] > 0
        for name in ("serve_tokens_out_total",
                     "serve_requests_finished_total",
                     "serve_decode_steps_total"):
            assert pm[name] <= parsed[name], name
        assert parsed["serve_requests_finished_total"] == 4
        assert parsed["serve_tokens_out_total"] == \
            stats["tokens_out"] == 4 * 12
        assert parsed["serve_decode_steps_total"] == stats["decode_steps"]
        assert parsed["serve_free_blocks"] == stats["free_blocks"]
        assert parsed["serve_ttft_seconds_count"] == 4
        assert stats["metrics"]["ttft"]["count"] == 4
        assert parsed["serve_ttft_seconds_sum"] == pytest.approx(
            stats["metrics"]["ttft"]["sum"])
        assert json.loads(json.dumps(stats)) == stats


def test_open_loop_cli_writes_a_trace_load_trace_reads(tmp_path):
    """The serve CLI on the CPU in open-loop mode with EDF, a deadline and
    reject shedding: it runs to the end, prints the Prometheus text and
    writes a trace that ``load_trace`` reads and the report summarizes;
    --bench-out holds the same stats."""
    trace_path, bench = tmp_path / "t.json", tmp_path / "b.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--sched", "edf", "--arrival-rate", "40", "--deadline-ms",
         "5000", "--shed", "reject", "--requests", "6", "--max-new", "6",
         "--decode-block", "auto", "--trace", str(trace_path), "--metrics",
         "--bench-out", str(bench)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "first-token SLO" in r.stdout and "decode_block auto" in r.stdout
    assert "serve_requests_finished_total" in r.stdout
    trace = load_trace(str(trace_path))
    ra = request_attribution(trace)
    stats = json.loads(bench.read_text())["stats"]
    assert ra["finished"] + stats["requests_shed"] == 6
    assert stats["requests_finished"] == ra["finished"] > 0
    assert stats["decode_block_mode"] == "auto"
    assert 0.0 <= stats["slo_attainment"] <= 1.0
    assert "step-time breakdown" in render_report(trace)
    # the exported file is what write_trace writes for the same tracer
    tr = Tracer()
    tr.event("submit", uid=0)
    write_trace(str(tmp_path / "one.json"), tr)
    assert load_trace(str(tmp_path / "one.json")) == chrome_trace(tr)
