"""Bounded ring-buffer runtime tracer for the serve engine.

One :class:`Tracer` rides on a ``ServeEngine``. The engine opens a
:class:`Span` around every host-side phase of a step — admission, each
prefill wave and decode chunk, the blocking device syncs, harvest
— and emits instant *events* for the per-request lifecycle
(``submit → queued → admitted → first_token → … →
finished | shed | preempted | swap_resumed``). Spans and events both
carry the engine step index, events additionally the request uid, so a
trace correlates "what the engine was doing" with "where each request's
latency went".

Design constraints, in order:

1. **Disabled means free.** The engine's TTFT/rate bookkeeping reads
   span durations, so a span always measures its wall time (two
   ``perf_counter`` calls — exactly the ``t0``/``dt`` plumbing it
   replaced); but with ``enabled=False`` nothing is recorded: ``event``
   / ``annotate`` return on one predicate, ``Span.__exit__`` commits
   nothing, and the nesting stack is never touched.
2. **Bounded memory.** The buffer is a ``deque(maxlen=capacity)``:
   long-running servers evict the oldest records instead of growing;
   ``dropped`` counts evictions so exports can say the window is
   truncated.
3. **No dependencies.** Pure stdlib — importable from the scheduler
   layer without touching torch.

Record shapes (plain dicts, the export layer's input contract)::

    {"ph": "span", "name": ..., "t0": s, "dur": s, "step": i,
     "depth": d, "args": {...} | None}
    {"ph": "event", "name": ..., "uid": u | None, "t": s, "step": i,
     "args": {...} | None}

Timestamps are raw ``perf_counter`` seconds; ``Tracer.t0`` (reset by
``clear``) is the export origin.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "NULL_TRACER", "SPAN_NAMES"]

# the span vocabulary the engine emits (docs + export track ordering;
# unknown names still trace fine — they get tracks after these)
SPAN_NAMES = ("step", "admit", "schedule", "prefill_wave", "tail_wave",
              "decode", "decode_chunk", "spec_draft", "spec_verify",
              "harvest", "swap_out", "swap_in", "cow", "sync")

DEFAULT_CAPACITY = 1 << 16


class Span:
    """One timed host-side phase. Use as a context manager::

        with tracer.span("decode_chunk", rows=3) as sp:
            ...
        elapsed = sp.dt          # measured even when tracing is off

    ``args`` is a mutable dict — callers may add fields before exit
    (e.g. row counts known only after the work ran).
    """

    __slots__ = ("_tracer", "name", "args", "t0", "dt")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[Dict]):
        self._tracer = tracer
        self.name = name
        self.args = args if args is not None else {}
        self.t0 = 0.0
        self.dt = 0.0

    def __enter__(self) -> "Span":
        tr = self._tracer
        if tr.enabled:
            tr._stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.dt = time.perf_counter() - self.t0
        tr = self._tracer
        if tr.enabled:
            if tr._stack and tr._stack[-1] is self:
                tr._stack.pop()
            tr._commit(self)


class Tracer:
    """Bounded ring-buffer tracer (see module docstring).

    Args:
        capacity: ring size in records; the oldest records are evicted
            once exceeded (``dropped`` counts them).
        enabled: record anything at all. A disabled tracer still hands
            out measuring spans (the engine's rate bookkeeping reads
            their ``dt``) but commits nothing.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self.clear()

    def clear(self) -> None:
        """Drop every record and restart the export time origin (the
        engine clears its tracer on ``reset()`` so benchmark reruns
        don't inherit the warmup pass's records)."""
        self._buf: deque = deque(maxlen=self.capacity)
        self._total = 0
        self._stack: List[Span] = []
        self.step = 0                    # engine step index, set per step
        self.t0 = time.perf_counter()    # export origin
        self.wall_t0 = time.time()       # wall-clock anchor for reports

    # ---- recording ----
    def span(self, name: str, **args) -> Span:
        """Open a span; always measures, records only when enabled."""
        return Span(self, name, args or None)

    def event(self, name: str, uid: Optional[int] = None, **args) -> None:
        """Record one instant (request-lifecycle) event."""
        if not self.enabled:
            return
        self._total += 1
        self._buf.append({"ph": "event", "name": name, "uid": uid,
                          "t": time.perf_counter(), "step": self.step,
                          "args": args or None})

    def annotate(self, **kv) -> None:
        """Attach fields to the innermost open span (no-op when none is
        open or tracing is off)."""
        if self.enabled and self._stack:
            self._stack[-1].args.update(kv)

    def _commit(self, span: Span) -> None:
        self._total += 1
        self._buf.append({"ph": "span", "name": span.name, "t0": span.t0,
                          "dur": span.dt, "step": self.step,
                          "depth": len(self._stack),
                          "args": span.args or None})

    # ---- reading ----
    def events(self) -> List[Dict]:
        """Snapshot of the buffered records, oldest first."""
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        """Records evicted by the ring bound since the last clear."""
        return self._total - len(self._buf)


# shared disabled tracer: the default for components constructed without
# one (scheduler, engine), so call sites never branch on None
NULL_TRACER = Tracer(capacity=1, enabled=False)
