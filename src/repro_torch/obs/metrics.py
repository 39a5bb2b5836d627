"""Prometheus-style metrics for the serve engine.

Two halves, matching how serving state is actually owned:

* **Histograms** (TTFT / TPOT / request latency) need every observation,
  so the engine pushes into them as requests are admitted and finished
  (:class:`ServeMetrics` rides on the engine; observes are O(#buckets)
  appends on the request path, never the token path).
* **Counters and gauges** already live in ``engine.stats()`` — the
  single source of truth every bench gate reads. Rather than maintain a
  second copy that could drift, :meth:`ServeMetrics.render` maps the
  stats dict onto Prometheus samples at scrape time, so ``GET
  /v1/metrics`` is *by construction* consistent with ``GET /v1/stats``.

The text output is the Prometheus exposition format (``text/plain;
version=0.0.4``): ``# HELP`` / ``# TYPE`` headers, ``_bucket`` samples
with cumulative ``le`` labels plus ``_sum`` / ``_count`` for
histograms. :func:`parse_prometheus` is the matching minimal parser
(tests and the live-dashboard example use it).

Stdlib-only; imports nothing from ``repro_torch.serve``. A copy of
the JAX package's module: ``render`` gives the same text for the same
stats dict.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

__all__ = ["Histogram", "ServeMetrics", "parse_prometheus",
           "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# latency bucket bounds in seconds: log-ish 1ms .. 30s (serve TTFTs on
# the CPU land mid-range, on a GPU at the low end)
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _fmt(v) -> str:
    """Prometheus sample value: integers bare, floats via repr (full
    precision, scientific notation is accepted by the format)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics).

    >>> h = Histogram("x_seconds", "test", buckets=(0.1, 1.0))
    >>> for v in (0.05, 0.5, 0.5, 2.0): h.observe(v)
    >>> h.count, round(h.sum, 2)
    (4, 3.05)
    >>> h.quantile(50)
    1.0
    >>> print(h.render().splitlines()[2])
    x_seconds_bucket{le="0.1"} 1
    """

    def __init__(self, name: str, help_: str,
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS_S):
        self.name = name
        self.help = help_
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)   # last: +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: Optional[float]) -> None:
        if v is None:
            return
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the q-th percentile from the bucket
        counts (the finest answer a fixed-bucket histogram can give;
        observations past the last bound report that bound)."""
        if not self.count:
            return 0.0
        rank = max(1, int(-(-q / 100.0 * self.count // 1)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        cum = 0
        for bound, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{self.name}_sum {_fmt(self.sum)}")
        lines.append(f"{self.name}_count {self.count}")
        return "\n".join(lines)

    def snapshot(self) -> Dict:
        return {"count": self.count, "sum": self.sum,
                "p50_s": self.quantile(50), "p95_s": self.quantile(95)}


# engine.stats() key -> (metric name, type, help). Keys absent from a
# stats dict (dense layout, spec off) simply don't render — the scrape
# surface tracks the engine configuration like stats() does.
STAT_METRICS = (
    ("tokens_out", "serve_tokens_out_total", "counter",
     "Tokens returned to requests (first prefill token + committed "
     "decode tokens)"),
    ("decode_steps", "serve_decode_steps_total", "counter",
     "Device decode steps executed"),
    ("decode_rounds", "serve_decode_rounds_total", "counter",
     "Engine steps that ran a decode chunk or spec wave"),
    ("prefill_calls", "serve_prefill_calls_total", "counter",
     "Compiled prefill/tail-finish admission waves"),
    ("prefill_chunks", "serve_prefill_chunks_total", "counter",
     "Tail-wave rows advanced (batched chunks)"),
    ("prompt_tokens_prefilled", "serve_prompt_tokens_prefilled_total",
     "counter", "Prompt tokens actually computed (prefix hits excluded)"),
    ("prefix_hit_tokens", "serve_prefix_hit_tokens_total", "counter",
     "Prompt tokens served from the prefix cache"),
    ("prefix_lookups", "serve_prefix_lookups_total", "counter",
     "Prefix-index probes"),
    ("prefix_evictions", "serve_prefix_evictions_total", "counter",
     "Indexed blocks reclaimed by allocation pressure"),
    ("cow_copies", "serve_cow_copies_total", "counter",
     "Copy-on-write block clones"),
    ("preemptions", "serve_preemptions_total", "counter",
     "Residents swapped out (optimistic admission)"),
    ("swap_out_bytes", "serve_swap_out_bytes_total", "counter",
     "Quantized cache bytes gathered to host by preemption"),
    ("swap_in_bytes", "serve_swap_in_bytes_total", "counter",
     "Quantized cache bytes restored from host"),
    ("requests_finished", "serve_requests_finished_total", "counter",
     "Requests fully served"),
    ("requests_shed", "serve_requests_shed_total", "counter",
     "Requests rejected by SLO shed-load"),
    ("requests_downgraded", "serve_requests_downgraded_total", "counter",
     "Requests demoted to best-effort by SLO shed-load"),
    ("spec_waves", "serve_spec_waves_total", "counter",
     "Speculative verify-waves run"),
    ("spec_drafted", "serve_spec_drafted_total", "counter",
     "Draft tokens proposed"),
    ("spec_accepted", "serve_spec_accepted_total", "counter",
     "Draft tokens accepted"),
    ("spec_accept_rate", "serve_spec_accept_rate", "gauge",
     "Accepted / drafted draft tokens"),
    ("pending_requests", "serve_pending_requests", "gauge",
     "Requests waiting in the scheduler queue"),
    ("resident_requests", "serve_resident_requests", "gauge",
     "Requests resident in slots (decode + in-flight tail prefills)"),
    ("swapped_requests", "serve_swapped_requests", "gauge",
     "Preempted requests awaiting restore"),
    ("max_residents", "serve_max_residents", "gauge",
     "Peak concurrently resident requests"),
    ("free_blocks", "serve_free_blocks", "gauge",
     "Free cache blocks in the paged pool"),
    ("pool_occupancy", "serve_pool_occupancy", "gauge",
     "Fraction of the paged pool's blocks in use"),
    ("prefix_cache_blocks", "serve_prefix_cache_blocks", "gauge",
     "Evictable blocks alive only in the prefix index"),
    ("cache_tokens_capacity", "serve_cache_tokens_capacity", "gauge",
     "Pool/stripe capacity in tokens"),
    ("peak_cache_tokens", "serve_peak_cache_tokens", "gauge",
     "Peak cache occupancy in tokens"),
    ("cache_bytes", "serve_cache_bytes", "gauge",
     "Total cache allocation in bytes"),
    ("per_device_pool_bytes", "serve_per_device_pool_bytes", "gauge",
     "One device's share of the KV cache"),
    ("per_device_weight_bytes", "serve_per_device_weight_bytes", "gauge",
     "One device's share of the served weights"),
    ("tp_degree", "serve_tp_degree", "gauge",
     "Tensor-parallel degree of the serving mesh"),
    ("decode_step_s", "serve_decode_step_seconds", "gauge",
     "Mean wall seconds per device decode step"),
    ("ttft_p50_s", "serve_ttft_p50_seconds", "gauge",
     "Submit-to-first-token p50 over all finished requests"),
    ("ttft_p95_s", "serve_ttft_p95_seconds", "gauge",
     "Submit-to-first-token p95 over all finished requests"),
    ("latency_p50_s", "serve_latency_p50_seconds", "gauge",
     "Submit-to-finish p50 over all finished requests"),
    ("latency_p95_s", "serve_latency_p95_seconds", "gauge",
     "Submit-to-finish p95 over all finished requests"),
)


class ServeMetrics:
    """The engine's metrics surface: pushed histograms + scrape-time
    projection of ``engine.stats()`` (see module docstring)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.ttft = Histogram(
            "serve_ttft_seconds",
            "Submit-to-first-token latency (admission wave granularity)")
        self.tpot = Histogram(
            "serve_tpot_seconds",
            "Per-output-token latency after the first token")
        self.latency = Histogram(
            "serve_request_latency_seconds",
            "Submit-to-finish request latency")

    # ---- engine-side pushes ----
    def observe_ttft(self, seconds: Optional[float]) -> None:
        self.ttft.observe(seconds)

    def observe_finished(self, latency_s: Optional[float],
                         decode_s: Optional[float], n_tokens: int) -> None:
        """One finished request: total latency plus its mean TPOT
        (decode seconds over the tokens after the first)."""
        self.latency.observe(latency_s)
        if decode_s is not None and n_tokens > 1:
            self.tpot.observe(decode_s / (n_tokens - 1))

    # ---- scrape-time rendering ----
    def render(self, stats: Dict) -> str:
        """Prometheus text for ``stats`` (an ``engine.stats()`` dict)
        plus the pushed histograms."""
        lines: List[str] = []
        for key, name, typ, help_ in STAT_METRICS:
            v = stats.get(key)
            if v is None or isinstance(v, (str, dict, list)):
                continue
            lines += [f"# HELP {name} {help_}", f"# TYPE {name} {typ}",
                      f"{name} {_fmt(v)}"]
        cv = stats.get("compile_variants") or {}
        if cv:
            lines += ["# HELP serve_compile_variants Live compiled "
                      "variants per wave family",
                      "# TYPE serve_compile_variants gauge"]
            lines += [f'serve_compile_variants{{family="{f}"}} {_fmt(n)}'
                      for f, n in sorted(cv.items())]
        for h in (self.ttft, self.tpot, self.latency):
            lines.append(h.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict:
        """JSON-safe digest of the pushed histograms (rides along in
        ``AsyncFrontend.stats()`` / ``GET /v1/stats``)."""
        return {"ttft": self.ttft.snapshot(), "tpot": self.tpot.snapshot(),
                "latency": self.latency.snapshot()}


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal exposition-format parser: ``{"name": v, 'name{le="x"}': v}``.

    Raises ValueError on any malformed sample line, so tests double as a
    well-formedness check of :meth:`ServeMetrics.render` output.

    >>> parse_prometheus('# HELP x y\\n# TYPE x counter\\nx 3\\n')
    {'x': 3.0}
    """
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not name:
            raise ValueError(f"malformed sample line: {line!r}")
        out[name] = float(value)        # ValueError on garbage values
    return out
