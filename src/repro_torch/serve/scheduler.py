"""Request scheduling + latency accounting for the serve engine.

The scheduler owns the waiting queue and all per-request timing; the engine
asks it for the next admission batch whenever slots free up. This port
holds the ``fcfs`` policy (first-come-first-served, arrival order) and
the paged engine's admission hooks: ``first``/``take`` to peek and remove
the head, ``select`` with a head-of-line ``admit_ok`` predicate, and
prefix-affinity grouping (``group_key`` / ``hot`` / ``skip``), and
``pick_victim``, which chooses whom optimistic admission swaps out. The
reference's ``sjf`` / ``edf`` policies and SLO shedding arrive with the
frontend slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.obs.trace import NULL_TRACER

POLICIES = ("fcfs",)
PREEMPT_POLICIES = ("last_admitted", "longest_remaining")
# how many non-head admissions may jump the policy head via hot-chain
# affinity before grouping pauses and the head admits (starvation bound)
HOT_BYPASS_CAP = 16


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
        self._bypass_head = None     # policy head being jumped via hot
        self._bypass_count = 0       # non-head removals while it waits

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

    def _ordered(self, group_key=None, hot=(), skip=()) -> List:
        """The queue in policy order, prefix-affinity grouped.

        With ``group_key`` (req -> hashable | None), requests sharing a
        cached chain (equal non-None key) are pulled back-to-back behind
        the group's first occurrence, and keys in ``hot`` (chains with an
        admission in flight) rank ahead of everything. Keyless requests
        keep their place. Hot jumping is starvation-bounded: after
        ``HOT_BYPASS_CAP`` admissions have passed the same waiting policy
        head, grouping pauses until the head itself is taken. ``skip``
        leaves out requests the engine holds this step.
        """
        base = self._queue if not skip else \
            [r for r in self._queue if r not in skip]
        base = list(base)
        if group_key is None:
            return base
        if hot and base and self._bypass_head is base[0] \
                and self._bypass_count >= HOT_BYPASS_CAP:
            hot = ()
        first_at: Dict = {}
        ranked = []
        for i, r in enumerate(base):
            k = group_key(r)
            if k is None:
                ranked.append(((i, i), r))
            elif k in hot:
                ranked.append(((-1, i), r))
            else:
                first_at.setdefault(k, i)
                ranked.append(((first_at[k], i), r))
        ranked.sort(key=lambda t: t[0])
        return [r for _, r in ranked]

    def first(self, group_key=None, hot=(), skip=()):
        """Head of the grouped queue (None when empty or fully skipped);
        the paged engine peeks it to route prefix-hit and long prompts
        into tail admission."""
        ordered = self._ordered(group_key, hot, skip)
        return ordered[0] if ordered else None

    def _policy_head(self):
        """Ungrouped policy head (what plain FCFS would admit next)."""
        return self._queue[0] if self._queue else None

    def _note_removal(self, req, head) -> None:
        """Track admissions that bypass the waiting policy head (the
        hot-chain starvation bound)."""
        if req is head or head is None:
            self._bypass_head = None
            self._bypass_count = 0
        else:
            if self._bypass_head is not head:
                self._bypass_head = head
                self._bypass_count = 0
            self._bypass_count += 1

    def take(self, req) -> None:
        """Remove a specific queued request (paired with ``first``)."""
        head = self._policy_head()
        self._queue.remove(req)
        self._note_removal(req, head)

    def select(self, max_n: int, *, equal_length_only: bool = False,
               admit_ok=None, group_key=None, hot=(), skip=()) -> List:
        """Pop up to ``max_n`` requests for one batched prefill.

        ``equal_length_only`` restricts the batch to the leader's prompt
        length. ``admit_ok`` is a per-request admission predicate ("enough
        free cache blocks"); selection stops at the first request it
        refuses (head-of-line blocking, so a big request is not starved by
        smaller ones behind it), and every request it accepted is
        admitted. ``group_key`` / ``hot`` / ``skip`` apply the
        prefix-affinity grouping of :meth:`_ordered`.
        """
        if max_n <= 0 or not self._queue:
            return []
        ordered = self._ordered(group_key, hot, skip)
        batch: List = []
        for r in ordered:
            if len(batch) >= max_n:
                break
            if batch and equal_length_only and \
                    len(r.prompt) != len(batch[0].prompt):
                continue
            if admit_ok is not None and not admit_ok(r):
                break
            batch.append(r)
        head = self._policy_head()
        for r in batch:
            self._queue.remove(r)
        if batch:
            # one bypass event per batch: the head went (reset), or
            # everything admitted jumped it (count once)
            self._note_removal(head if head in batch else batch[0], head)
        return batch

    # ---- preemption ----
    @staticmethod
    def pick_victim(candidates, mode: str = "last_admitted"):
        """Choose which resident the engine swaps out when the block pool
        runs dry under optimistic admission.

        ``candidates``: (slot, admit_seq, remaining_tokens) triples for the
        preemptible residents. ``last_admitted`` evicts the newest resident
        (the oldest work keeps its cache); ``longest_remaining`` evicts the
        resident with the most tokens still to serve (ties newest first).
        Returns the victim slot, or None when there is nothing to preempt.
        """
        if mode not in PREEMPT_POLICIES:
            raise ValueError(
                f"unknown preemption policy {mode!r}; known: "
                f"{PREEMPT_POLICIES}")
        if not candidates:
            return None
        if mode == "longest_remaining":
            return max(candidates, key=lambda c: (c[2], c[1]))[0]
        return max(candidates, key=lambda c: c[1])[0]

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
