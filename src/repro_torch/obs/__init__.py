"""Runtime observability for the port's serve stack.

Three small, dependency-free layers:

* :mod:`repro_torch.obs.trace` — a bounded ring-buffer tracer: engine-step
  spans (``admit`` / ``prefill_wave`` / ``tail_wave`` / ``decode_chunk``
  / ``spec_draft`` / ``spec_verify`` / ``swap_out`` / ``swap_in`` /
  ``cow`` / ``harvest`` plus host-side ``schedule`` / ``sync`` gaps) and
  per-request lifecycle events, correlated by request uid + step index.
* :mod:`repro_torch.obs.export` — Chrome/Perfetto ``trace_event`` JSON
  export and the trace report functions.
* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry
  rendered as Prometheus text at ``GET /v1/metrics``.

``trace``/``metrics`` import nothing from ``repro_torch.serve`` (the
serve layer imports *them*), so there is no import cycle; ``export`` is
pulled in explicitly by its consumers.
"""
from repro_torch.obs.metrics import ServeMetrics, parse_prometheus
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer

__all__ = ["Tracer", "Span", "NULL_TRACER", "ServeMetrics",
           "parse_prometheus"]
