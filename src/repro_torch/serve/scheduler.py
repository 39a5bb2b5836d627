"""Request scheduling + latency accounting for the serve engine.

The scheduler owns the waiting queue and all per-request timing; the engine
asks it for the next admission batch whenever slots free up. This port
holds the ``fcfs`` policy (first-come-first-served, arrival order); the
reference's ``sjf`` / ``edf`` policies, prefix-affinity grouping, SLO
shedding and preemption arrive with the slices that need them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.obs.trace import NULL_TRACER

POLICIES = ("fcfs",)


@dataclass
class RequestTiming:
    submit_t: float
    admit_t: Optional[float] = None     # prefill done, first token exists
    finish_t: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        return None if self.admit_t is None else self.admit_t - self.submit_t

    @property
    def latency(self) -> Optional[float]:
        return None if self.finish_t is None else self.finish_t - self.submit_t


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile — the one definition every serve stat uses.

    >>> percentile([0.4, 0.1, 0.3, 0.2], 50)
    0.3
    >>> percentile([], 95)
    0.0
    """
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))
    return ys[i]


class Scheduler:
    """Queue + admission policy + per-request latency bookkeeping."""

    def __init__(self, policy: str = "fcfs", trace=None):
        if policy not in POLICIES:
            raise NotImplementedError(
                f"scheduler policy {policy!r} is not ported; known: "
                f"{POLICIES}")
        self.policy = policy
        self.trace = trace if trace is not None else NULL_TRACER
        self._queue: List = []                   # waiting Requests
        self._timings: List[RequestTiming] = []
        self._seq = 0                            # arrival tiebreaker

    # ---- queue ----
    def submit(self, req, now: Optional[float] = None) -> None:
        """Enqueue ``req`` and start its latency clock (``now`` overrides
        the wall clock for deterministic tests)."""
        req._arrival = self._seq
        self._seq += 1
        t = time.perf_counter() if now is None else now
        req._timing = RequestTiming(submit_t=t)
        self._timings.append(req._timing)
        self._queue.append(req)
        uid = getattr(req, "uid", None)
        self.trace.event("submit", uid=uid,
                         prompt_tokens=len(getattr(req, "prompt", ())))
        self.trace.event("queued", uid=uid, queue_len=len(self._queue))

    @property
    def pending(self) -> int:
        return len(self._queue)

    def select(self, max_n: int) -> List:
        """Pop up to ``max_n`` requests, in arrival order, for one batched
        prefill."""
        if max_n <= 0 or not self._queue:
            return []
        batch = self._queue[:max_n]
        del self._queue[:max_n]
        return batch

    # ---- accounting ----
    def on_admitted(self, reqs, now: Optional[float] = None) -> None:
        t = time.perf_counter() if now is None else now
        for r in reqs:
            r._timing.admit_t = t
            self.trace.event("admitted", uid=getattr(r, "uid", None),
                             queue_delay_s=t - r._timing.submit_t)

    def on_finished(self, req, now: Optional[float] = None) -> None:
        t = time.perf_counter() if now is None else now
        req._timing.finish_t = t
        self.trace.event("finished", uid=getattr(req, "uid", None),
                         latency_s=req._timing.latency,
                         tokens=len(getattr(req, "generated", ()) or ()))

    def stats(self) -> Dict[str, float]:
        """Aggregate latency stats over every request ever submitted."""
        ttfts = [t.ttft for t in self._timings if t.ttft is not None]
        lats = [t.latency for t in self._timings if t.latency is not None]
        return {
            "requests_finished": len(lats),
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p95_s": percentile(ttfts, 95),
            "latency_p50_s": percentile(lats, 50),
            "latency_p95_s": percentile(lats, 95),
        }
