"""Request scheduling + latency accounting for the serve engine (the JAX
package's scheduler, policy for policy).

The scheduler owns the waiting queue and all per-request timing; the engine
asks it for the next admission batch whenever slots free up. Policies are
pluggable:

* ``fcfs`` — first-come-first-served (arrival order)
* ``sjf``  — shortest-prompt-first (minimizes mean TTFT under load; ties
  broken by arrival so it stays starvation-bounded for equal lengths)
* ``edf``  — earliest-deadline-first **within priority class**: requests
  order by ``(priority, absolute deadline, arrival)``. ``priority`` is an
  int on the request (lower = more urgent, default 0); requests without a
  deadline sort behind every deadlined request of the same class. The
  SLO-aware policy for open-loop serving — pair it with
  :meth:`Scheduler.shed_overdue` for shed-load behavior under overload.

Batched prefill wants co-admitted prompts of similar length; ``select``
therefore groups the policy-ordered head of the queue into one prefill
bucket: padded engines take any lengths (bucketed up to a common padded
length), exact-length engines (recurrent archs, where right-padding would
corrupt the scan state) only take requests sharing the leader's length.

Prefix-affinity grouping (``group_key`` / ``hot``) layers on top of any
base policy, EDF included: the base order decides each group's rank via
its first occurrence, then sharers of one cached chain admit
back-to-back.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.obs.trace import NULL_TRACER

POLICIES = ("fcfs", "sjf", "edf")
SHED_MODES = ("none", "reject", "downgrade")
# priority class a downgraded request lands in: behind every explicit
# class, so on-time work always outranks work that already missed its SLO
BEST_EFFORT_PRIORITY = 1 << 30
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

    def __init__(self, policy: str = "fcfs", trace=None, clock=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        self.policy = policy
        # the clock every ``now`` reads (perf_counter seconds): a
        # tensor-parallel engine passes rank 0's, broadcast once a host
        # step, so the ranks' admission and shed decisions agree
        self.clock = clock if clock is not None else time.perf_counter
        # request-lifecycle event sink (a repro_torch.obs Tracer; the engine
        # passes its own so queue events land in the same trace as waves)
        self.trace = trace if trace is not None else NULL_TRACER
        self._queue: List = []                   # waiting Requests
        # timing rides on the request object (uids may collide); the
        # scheduler keeps the full list for aggregate stats
        self._timings: List[RequestTiming] = []
        self._seq = 0                            # arrival tiebreaker
        self._bypass_head = None     # policy head being jumped via hot
        self._bypass_count = 0       # non-head removals while it waits
        self.shed_rejected = 0       # requests dropped by shed_overdue
        self.shed_downgraded = 0     # requests demoted to best-effort

    # ---- queue ----
    def submit(self, req, now: Optional[float] = None) -> None:
        """Enqueue ``req`` and start its latency clock.

        Stamps the request's arrival order (the FCFS / tiebreak key), its
        submit time, and — when the request carries a ``deadline_ms`` —
        its *absolute* first-token deadline ``submit_t + deadline_ms/1e3``
        (what EDF ordering and :meth:`shed_overdue` compare against).
        ``now`` overrides the wall clock for deterministic tests.
        """
        req._arrival = self._seq
        self._seq += 1
        t = self.clock() if now is None else now
        req._timing = RequestTiming(submit_t=t)
        dl = getattr(req, "deadline_ms", None)
        req._deadline_t = None if dl is None else t + dl / 1e3
        self._timings.append(req._timing)
        self._queue.append(req)
        uid = getattr(req, "uid", None)
        self.trace.event("submit", uid=uid,
                         prompt_tokens=len(getattr(req, "prompt", ())))
        self.trace.event("queued", uid=uid, queue_len=len(self._queue))

    @property
    def pending(self) -> int:
        return len(self._queue)

    @staticmethod
    def _edf_key(r):
        dl = getattr(r, "_deadline_t", None)
        return (getattr(r, "priority", 0),
                dl if dl is not None else float("inf"), r._arrival)

    def _ordered(self, group_key=None, hot=(), skip=()) -> List:
        base = self._queue if not skip else \
            [r for r in self._queue if r not in skip]
        if self.policy == "sjf":
            base = sorted(base, key=lambda r: (len(r.prompt), r._arrival))
        elif self.policy == "edf":
            base = sorted(base, key=self._edf_key)
        else:
            base = list(base)
        if group_key is None:
            return base
        # prefix-aware affinity: requests sharing a cached chain (equal
        # non-None key) are pulled back-to-back behind the group's first
        # occurrence, so the chain admits while it is still hot in the
        # allocator's LRU. Keys in ``hot`` belong to chains with an
        # admission already in flight — their sharers rank ahead of
        # everything (the anchor that earned the group its position has
        # left the queue, so rank-by-first-occurrence alone would let a
        # stranger split the group). Keyless requests keep their policy
        # position; cold groups never jump an earlier-ranked stranger.
        # Hot jumping is starvation-bounded: once HOT_BYPASS_CAP non-head
        # admissions have passed the same waiting policy head, grouping
        # pauses until the head itself is taken (a steady sharer stream
        # must not pin a stranger at the head forever).
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
        """Policy-ordered head of the queue (None when empty or fully
        skipped). The paged engine peeks it to route prefix-hit / long
        prompts into tail admission; ``group_key``/``hot`` apply the
        same prefix-affinity grouping as ``select``; ``skip`` excludes
        requests the engine is holding this step (cross-wave dedup) so
        unrelated work behind them still admits."""
        ordered = self._ordered(group_key, hot, skip)
        return ordered[0] if ordered else None

    def _policy_head(self):
        """Ungrouped policy head (what pure FCFS/SJF would admit next)."""
        if not self._queue:
            return None
        if self.policy == "sjf":
            return min(self._queue,
                       key=lambda r: (len(r.prompt), r._arrival))
        if self.policy == "edf":
            return min(self._queue, key=self._edf_key)
        return self._queue[0]

    def _note_removal(self, req, head) -> None:
        """Track admissions that bypass the waiting policy head (the
        hot-chain starvation bound; see ``_ordered``)."""
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

        ``equal_length_only``: restrict the batch to the leader's exact
        prompt length (recurrent caches can't absorb right-padding).
        ``admit_ok``: per-request admission predicate (e.g. "enough free
        cache blocks"). Selection stops at the first failing request —
        head-of-line blocking, so a big request can't be starved by smaller
        ones arriving behind it. The predicate may commit resources
        (reservations) for requests it accepts: everything it accepted is
        admitted. ``group_key`` (callable req -> hashable | None) groups
        requests with equal keys back-to-back, and ``hot`` keys (chains
        with an admission in flight) rank first (prefix-affinity; see
        ``_ordered``) before the scan. ``skip`` excludes requests the
        engine is holding this step (cross-wave dedup).
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
            # one bypass event per admission batch: either the head went
            # (reset) or everything admitted jumped it (count once)
            self._note_removal(head if head in batch else batch[0], head)
        return batch

    # ---- SLO shed-load ----
    def shed_overdue(self, predict_s, mode: str = "reject",
                     now: Optional[float] = None) -> List:
        """Shed queued requests whose first-token deadline is already
        unreachable (SLO-aware admission control under overload).

        Walks the queue in policy order accumulating the prefill work
        queued *ahead* of each request; for every request with a
        deadline, the predicted TTFT is ``elapsed-so-far +
        predict_s(tokens_ahead + own prompt)`` where ``predict_s`` maps a
        prompt-token backlog to estimated seconds until the first token
        (the engine supplies one fitted from its measured prefill/decode
        rates). A request predicted to miss is handled per ``mode``:

        * ``"reject"``   — removed from the queue and returned; the
          caller marks it shed and closes its stream. Serving capacity
          is spent only on requests that can still meet their SLO
          (goodput over throughput).
        * ``"downgrade"`` — kept, but its deadline is cleared and its
          priority drops to ``BEST_EFFORT_PRIORITY``: it still serves
          eventually, ordered behind every on-time request, and is never
          shed again (a cleared deadline can't re-trigger).

        Deadline-less requests are never touched. Returns the list of
        rejected requests (empty in ``downgrade`` mode).
        """
        if mode not in SHED_MODES:
            raise ValueError(f"unknown shed mode {mode!r}; known: "
                             f"{SHED_MODES}")
        if mode == "none" or not self._queue:
            return []
        t = self.clock() if now is None else now
        shed: List = []
        ahead = 0
        for r in self._ordered():
            work = ahead + len(r.prompt)
            dl = getattr(r, "_deadline_t", None)
            if dl is not None and t + predict_s(work) > dl:
                if mode == "reject":
                    shed.append(r)
                    continue            # its work never joins the backlog
                r._deadline_t = None
                r.deadline_ms = None
                r.priority = BEST_EFFORT_PRIORITY
                self.shed_downgraded += 1
                self.trace.event("downgraded", uid=getattr(r, "uid", None))
            ahead = work
        for r in shed:
            self._queue.remove(r)
            self.shed_rejected += 1
        return shed

    # ---- preemption ----
    @staticmethod
    def pick_victim(candidates, mode: str = "last_admitted"):
        """Choose which resident the engine swaps out when the block pool
        runs dry under optimistic admission.

        ``candidates``: (slot, admit_seq, remaining_tokens) triples for the
        preemptible residents. ``last_admitted`` evicts the newest resident
        (FCFS-fair: the oldest work keeps its cache warm);
        ``longest_remaining`` evicts the resident with the most tokens
        still to serve (frees the most block-seconds per swap, ties broken
        newest-first). Returns the victim slot, or None when there is
        nothing to preempt.
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
        t = self.clock() if now is None else now
        for r in reqs:
            r._timing.admit_t = t
            self.trace.event("admitted", uid=getattr(r, "uid", None),
                             queue_delay_s=t - r._timing.submit_t)

    def on_finished(self, req, now: Optional[float] = None) -> None:
        t = self.clock() if now is None else now
        req._timing.finish_t = t
        # latency_s here is the scheduler-clock measurement the trace
        # report reconciles its own event-delta latency against
        self.trace.event("finished", uid=getattr(req, "uid", None),
                         latency_s=req._timing.latency,
                         tokens=len(getattr(req, "generated", ()) or ()))

    def stats(self) -> Dict[str, float]:
        """Aggregate latency/SLO stats over every request ever submitted
        (see ``ServeEngine.stats`` for the full key table)."""
        ttfts = [t.ttft for t in self._timings if t.ttft is not None]
        lats = [t.latency for t in self._timings if t.latency is not None]
        return {
            "requests_finished": len(lats),
            "requests_shed": self.shed_rejected,
            "requests_downgraded": self.shed_downgraded,
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p95_s": percentile(ttfts, 95),
            "latency_p50_s": percentile(lats, 50),
            "latency_p95_s": percentile(lats, 95),
        }
