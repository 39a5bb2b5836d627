"""Chrome/Perfetto export and text reports for serve traces.

:func:`chrome_trace` turns a :class:`repro_torch.obs.trace.Tracer` into
the Chrome ``trace_event`` JSON object format (loadable at
https://ui.perfetto.dev or ``chrome://tracing``):

* **pid 0 — engine waves.** Each span name gets its own named track
  (tid), so the step timeline reads as stacked lanes: ``step`` on top,
  ``admit`` / ``prefill_wave`` / ``tail_wave`` / ``decode`` /
  ``decode_chunk`` / spec / swap / ``harvest`` below, with the blocking
  ``sync`` gaps visible inside each wave. Spans are ``ph:"X"`` complete
  events.
* **pid 1 — requests.** Each request uid becomes one async span
  (``ph:"b"``/``"n"``/``"e"``, ``id`` = uid) running submit→terminal,
  with every lifecycle event as an instant on it. Requests still live
  when the trace was cut get a synthetic end marked ``truncated``.

The report functions (:func:`step_breakdown`,
:func:`request_attribution`, :func:`compile_split`,
:func:`render_report`) operate on the *chrome dict*, not the live
tracer, so they work on the exported artifact; the JAX package's
``tools/trace_report.py`` reads the same format.

**The compile split.** The port has no jit, so nothing is compiled per
argument signature, and its split reports execute time only: no span
the engine records carries ``args.compiled``. A kernel library is built
(``nvcc``) and loaded at its first call in the process
(``kernels/build.py:load``), and that happens before any timed wave:
``chip_smoke.py``'s phase 1 builds every kernel, and the serve CLI's
warm-up pass runs each wave once and then clears the trace.
:func:`compile_split` still counts a span that carries ``compiled``
(a trace of the JAX package's engine) as compile time, as the
reference does; ``variants`` stays empty for the port's traces.

Stdlib-only. The same functions as the JAX package's exporter: for the
same records the Chrome dict differs only in ``otherData.generator``,
which names the package.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.trace import SPAN_NAMES, Tracer

__all__ = ["chrome_trace", "write_trace", "load_trace", "step_breakdown",
           "request_attribution", "compile_split", "render_report"]

WAVE_PID = 0
REQUEST_PID = 1

# terminal lifecycle events: close the request's async span
_TERMINAL = frozenset({"finished", "shed"})


def _percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (reimplemented locally so report code never
    imports the serve layer)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    rank = max(1, int(-(-q / 100.0 * len(s) // 1)))
    return float(s[min(rank, len(s)) - 1])


def chrome_trace(tracer: Tracer,
                 compile_variants: Optional[Dict] = None) -> Dict:
    """Export ``tracer``'s buffer as a Chrome ``trace_event`` object.

    ``compile_variants`` ({wave family: [argument signatures]}) rides
    along in ``otherData`` for the compile-vs-execute report; the port's
    engine has no such registry and passes none.
    """
    records = tracer.events()
    ev: List[Dict] = [
        {"ph": "M", "name": "process_name", "pid": WAVE_PID, "tid": 0,
         "args": {"name": "engine waves"}},
        {"ph": "M", "name": "process_name", "pid": REQUEST_PID, "tid": 0,
         "args": {"name": "requests"}},
    ]

    # stable track ids: known span vocabulary first, stragglers appended
    tids = {name: i for i, name in enumerate(SPAN_NAMES)}
    for r in records:
        if r["ph"] == "span" and r["name"] not in tids:
            tids[r["name"]] = len(tids)
    seen = {r["name"] for r in records if r["ph"] == "span"}
    for name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        if name in seen:
            ev.append({"ph": "M", "name": "thread_name", "pid": WAVE_PID,
                       "tid": tid, "args": {"name": name}})

    def us(t: float) -> float:
        return (t - tracer.t0) * 1e6

    open_reqs: Dict[int, float] = {}     # uid -> last event ts (µs)
    for r in records:
        if r["ph"] == "span":
            args = {"step": r["step"], "depth": r["depth"]}
            if r["args"]:
                args.update(r["args"])
            ev.append({"ph": "X", "name": r["name"], "cat": "wave",
                       "pid": WAVE_PID, "tid": tids[r["name"]],
                       "ts": us(r["t0"]), "dur": r["dur"] * 1e6,
                       "args": args})
        else:
            uid = r["uid"]
            if uid is None:              # engine-level instant, own lane
                ev.append({"ph": "i", "name": r["name"], "s": "p",
                           "pid": WAVE_PID, "tid": tids.get("step", 0),
                           "ts": us(r["t"]),
                           "args": {"step": r["step"], **(r["args"] or {})}})
                continue
            ts = us(r["t"])
            name = f"req:{uid}"
            args = {"event": r["name"], "step": r["step"]}
            if r["args"]:
                args.update(r["args"])
            if uid not in open_reqs:
                ev.append({"ph": "b", "cat": "request", "name": name,
                           "id": uid, "pid": REQUEST_PID, "tid": 0,
                           "ts": ts, "args": args})
            ev.append({"ph": "n", "cat": "request", "name": name,
                       "id": uid, "pid": REQUEST_PID, "tid": 0,
                       "ts": ts, "args": args})
            if r["name"] in _TERMINAL:
                ev.append({"ph": "e", "cat": "request", "name": name,
                           "id": uid, "pid": REQUEST_PID, "tid": 0,
                           "ts": ts, "args": {}})
                open_reqs.pop(uid, None)
            else:
                open_reqs[uid] = ts
    # requests with no terminal event inside the window: close the async
    # span so the viewer renders it, flagged truncated
    for uid, ts in open_reqs.items():
        ev.append({"ph": "e", "cat": "request", "name": f"req:{uid}",
                   "id": uid, "pid": REQUEST_PID, "tid": 0, "ts": ts,
                   "args": {"truncated": True}})

    return {
        "traceEvents": ev,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro_torch.obs",
            "wall_t0": tracer.wall_t0,
            "dropped_records": tracer.dropped,
            "compile_variants": compile_variants or {},
        },
    }


def write_trace(path: str, tracer: Tracer,
                compile_variants: Optional[Dict] = None) -> Dict:
    """Write the Perfetto JSON to ``path``; returns the exported dict."""
    trace = chrome_trace(tracer, compile_variants)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def load_trace(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# reports (input: the chrome dict)
# ---------------------------------------------------------------------------

def _wave_events(trace: Dict) -> List[Dict]:
    return [e for e in trace["traceEvents"]
            if e["ph"] == "X" and e["pid"] == WAVE_PID]


def step_breakdown(trace: Dict) -> Dict[str, Dict]:
    """Wall-time totals per wave family.

    Returns ``{family: {"count", "total_s", "mean_ms", "pct_of_step"}}``.
    Families overlap by nesting (``decode`` contains ``decode_chunk``
    and ``harvest``; waves contain their ``sync``), so percentages are
    each family's share of total ``step`` time, not a partition.
    """
    acc: Dict[str, List[float]] = defaultdict(list)
    for e in _wave_events(trace):
        acc[e["name"]].append(e["dur"] / 1e6)
    step_total = sum(acc.get("step", [])) or sum(
        sum(v) for k, v in acc.items() if k != "step") or 1.0
    out = {}
    for name, durs in acc.items():
        total = sum(durs)
        out[name] = {"count": len(durs), "total_s": total,
                     "mean_ms": 1e3 * total / len(durs),
                     "pct_of_step": 100.0 * total / step_total}
    return out


def request_attribution(trace: Dict) -> Dict:
    """Per-request latency attribution from the lifecycle events.

    Splits each finished request's submit→finish span into queue delay
    (submit→admitted), TTFT (submit→first_token) and decode
    (first_token→finished); derives TPOT from decode time over the
    ``tokens`` count the scheduler stamps on ``finished``. Also
    reconciles the trace-side latency (finished ts − submit ts) against
    the scheduler-clock ``latency_s`` carried on the ``finished`` event
    — ``reconcile_max_err`` is the worst relative disagreement.
    """
    by_uid: Dict[int, Dict[str, Dict]] = defaultdict(dict)
    for e in trace["traceEvents"]:
        if e.get("cat") == "request" and e["ph"] == "n":
            by_uid[e["id"]].setdefault(e["args"]["event"], e)

    queue, ttft, decode, tpot, latency = [], [], [], [], []
    errs = []
    n_finished = 0
    for uid, evs in by_uid.items():
        sub, fin = evs.get("submit"), evs.get("finished")
        if sub is None or fin is None:
            continue
        n_finished += 1
        lat = (fin["ts"] - sub["ts"]) / 1e6
        latency.append(lat)
        if "admitted" in evs:
            queue.append((evs["admitted"]["ts"] - sub["ts"]) / 1e6)
        if "first_token" in evs:
            ft = (evs["first_token"]["ts"] - sub["ts"]) / 1e6
            ttft.append(ft)
            dec = lat - ft
            decode.append(dec)
            toks = fin["args"].get("tokens") or 0
            if toks > 1:
                tpot.append(dec / (toks - 1))
        sched_lat = fin["args"].get("latency_s")
        if sched_lat:
            errs.append(abs(lat - sched_lat) / sched_lat)

    def pcts(xs):
        return {"p50_s": _percentile(xs, 50), "p95_s": _percentile(xs, 95),
                "mean_s": sum(xs) / len(xs) if xs else 0.0, "n": len(xs)}

    return {"finished": n_finished,
            "queue_delay": pcts(queue), "ttft": pcts(ttft),
            "decode": pcts(decode), "tpot": pcts(tpot),
            "latency": pcts(latency),
            "reconcile_max_err": max(errs) if errs else 0.0}


def compile_split(trace: Dict) -> Dict[str, Dict]:
    """Compile-vs-execute wall time per wave family.

    A span is *compile-tainted* when it carries ``args.compiled``; the
    port's engine marks none (see the module docstring), so its traces
    split into execute time only. ``variants`` carries any argument
    signatures recorded in ``otherData``.
    """
    out: Dict[str, Dict] = {}
    for e in _wave_events(trace):
        d = out.setdefault(e["name"], {"compile_s": 0.0, "execute_s": 0.0,
                                       "compile_calls": 0,
                                       "execute_calls": 0})
        if e["args"].get("compiled"):
            d["compile_s"] += e["dur"] / 1e6
            d["compile_calls"] += 1
        else:
            d["execute_s"] += e["dur"] / 1e6
            d["execute_calls"] += 1
    variants = trace.get("otherData", {}).get("compile_variants", {})
    for fam, sigs in variants.items():
        key = {"admit_dense": "prefill_wave", "admit_paged": "prefill_wave",
               "admit_draft": "prefill_wave", "tail": "tail_wave",
               "decode": "decode_chunk"}.get(fam, fam)
        if key in out:
            out[key].setdefault("variants", []).extend(
                str(s) for s in sigs)
    return out


def render_report(trace: Dict) -> str:
    """The trace report's text: step-time breakdown, request attribution
    percentiles, compile-vs-execute split."""
    lines = ["serve trace report", "=================="]
    od = trace.get("otherData", {})
    if od.get("dropped_records"):
        lines.append(f"[window truncated: {od['dropped_records']} oldest "
                     "records evicted by the ring bound]")

    bd = step_breakdown(trace)
    lines += ["", "step-time breakdown by wave family",
              f"{'family':<14}{'count':>7}{'total s':>10}{'mean ms':>10}"
              f"{'% of step':>11}"]
    order = {n: i for i, n in enumerate(SPAN_NAMES)}
    for name in sorted(bd, key=lambda n: order.get(n, 99)):
        d = bd[name]
        lines.append(f"{name:<14}{d['count']:>7}{d['total_s']:>10.3f}"
                     f"{d['mean_ms']:>10.2f}{d['pct_of_step']:>10.1f}%")

    ra = request_attribution(trace)
    lines += ["", f"request attribution ({ra['finished']} finished)",
              f"{'phase':<14}{'n':>5}{'p50 ms':>10}{'p95 ms':>10}"
              f"{'mean ms':>10}"]
    for phase in ("queue_delay", "ttft", "decode", "tpot", "latency"):
        d = ra[phase]
        lines.append(f"{phase:<14}{d['n']:>5}{1e3 * d['p50_s']:>10.2f}"
                     f"{1e3 * d['p95_s']:>10.2f}{1e3 * d['mean_s']:>10.2f}")
    lines.append(f"trace vs scheduler latency: max rel err "
                 f"{100.0 * ra['reconcile_max_err']:.2f}%")

    cs = compile_split(trace)
    lines += ["", "compile vs execute",
              f"{'family':<14}{'compiles':>9}{'compile s':>11}"
              f"{'exec calls':>11}{'exec s':>9}"]
    for name in sorted(cs, key=lambda n: order.get(n, 99)):
        d = cs[name]
        lines.append(f"{name:<14}{d['compile_calls']:>9}"
                     f"{d['compile_s']:>11.3f}{d['execute_calls']:>11}"
                     f"{d['execute_s']:>9.3f}")
        for sig in d.get("variants", []):
            sig = sig if len(sig) <= 68 else sig[:65] + "..."
            lines.append(f"  variant {sig}")
    return "\n".join(lines)
