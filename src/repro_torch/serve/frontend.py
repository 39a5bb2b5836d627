"""Asyncio serving frontend: open-loop arrivals over the slot engine.

``ServeEngine`` is a synchronous batch machine — ``submit`` everything,
``step`` until drained. Production traffic is the opposite shape:
requests arrive continuously, every caller wants its tokens *as they
decode*, and nobody is willing to wait for the batch to finish. This
module is the production front half:

* :class:`AsyncFrontend` — the asyncio host loop. Requests enter through
  ``await frontend.submit(...)`` at any time; a single pump task steps
  the engine whenever there is work, running each (blocking, device-
  bound) ``engine.step()`` in a worker thread so the event loop keeps
  accepting arrivals, serving HTTP, and flushing token streams *while*
  the device computes. Engine state is only ever touched from the pump —
  arrivals land in an inbox the pump drains between steps — so the
  single-threaded engine needs no locks.
* :class:`RequestStream` — the per-request handle. Async-iterate it for
  tokens as they decode (``async for tok in handle``), or ``await
  handle.tokens()`` for the collected list. Token spans surface at
  ``decode_block`` / spec-wave granularity straight from the engine's
  incremental harvest hook (``Request.on_tokens``), bridged onto the
  event loop with ``call_soon_threadsafe``.
* **SLO plumbing** — ``submit`` takes ``deadline_ms`` / ``priority``
  per request (defaults configurable on the frontend); pair the engine
  with ``sched_policy="edf"`` and ``slo_shed="reject"|"downgrade"`` for
  earliest-deadline-first admission and shed-load under overload. A
  shed request's stream ends immediately with ``handle.shed == True``.

The wave loop stays decoupled from the host loop by construction — the
pump owns stepping, arrival/egress own the event loop — which is the
precondition for disaggregating prefill and decode waves onto separate
devices/streams later.

Typical use::

    frontend = AsyncFrontend(engine)
    async with frontend:
        handle = await frontend.submit(prompt_ids, max_new_tokens=64,
                                       deadline_ms=500)
        async for tok in handle:
            ...                       # tokens at decode-chunk granularity

(See ``serve.http`` for the OpenAI-style endpoint on top of this; the
JAX package's ``docs/serving_api.md`` has the knob table, which this port
shares.)

**Tensor-parallel serving.** On a mesh the frontend lives on rank 0: its
submissions reach the other ranks at each step (the engine's
``_sync_host``), whose loops run ``engine.follow()``; while the engine
is idle the pump sends a heartbeat every ``HEARTBEAT_S`` seconds
(``engine.heartbeat``), so a follower waiting in its collective sees
one before the process group's timeout however long no request comes;
:meth:`aclose` ends them (``engine.stop_followers``) unless the frontend
was made with ``stop_followers=False`` (a later frontend, or
``run_until_drained``, which ends them, goes on driving the same
followers).

**The worker thread and the device.** CUDA's current device is per
thread, so the step worker binds itself to the card the engine's state
lives on before its first task: a caller's device context, or a second
card, cannot move the engine's work. **The GIL.** The engine is
host-bound: a step issues thousands of kernel launches from Python while
holding the GIL, and the event loop runs only between them, so
arrivals, HTTP and stream flushes wait on the step in flight.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve.engine import Request

_END = object()         # stream sentinel: request left the engine
# on a mesh, the longest the idle pump leaves the followers without a host
# step (``engine.heartbeat``): well inside any process group's timeout
HEARTBEAT_S = 1.0


class RequestStream:
    """Async handle for one in-flight request.

    Iterate it for tokens as they decode::

        handle = await frontend.submit(prompt)
        async for tok in handle:
            ...

    or collect everything at once with ``await handle.tokens()``. After
    the stream ends, ``handle.request`` carries the engine's finished
    :class:`~repro_torch.serve.engine.Request` (``generated`` / ``done`` /
    ``shed``), ``handle.shed`` says whether SLO admission control
    rejected the request, and ``handle.first_token_t`` /
    ``handle.finish_t`` are event-loop timestamps of the first drained
    span and the terminal event (open-loop benchmarks derive client-side
    TTFT/TPOT from them).
    """

    def __init__(self, req: Request, loop: asyncio.AbstractEventLoop):
        self.request = req
        self.submit_t = time.perf_counter()
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self._queue: asyncio.Queue = asyncio.Queue()
        self._loop = loop
        self._ended = False

    # -- engine side (worker thread): Request.on_tokens target ----------
    def _on_tokens(self, _req, toks: List[int], done: bool) -> None:
        self._loop.call_soon_threadsafe(self._post, toks, done)

    # -- loop side -------------------------------------------------------
    def _post(self, toks: List[int], done: bool) -> None:
        now = time.perf_counter()
        if toks and self.first_token_t is None:
            self.first_token_t = now
        for t in toks:
            # plain ints for JSON encoders (serve.http)
            self._queue.put_nowait(int(t))
        if done:
            self.finish_t = now
            self._queue.put_nowait(_END)

    @property
    def shed(self) -> bool:
        """True when SLO admission control rejected the request."""
        return self.request.shed

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        if self._ended:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is _END:
            self._ended = True
            raise StopAsyncIteration
        return item

    async def tokens(self) -> List[int]:
        """Drain the stream to completion and return all tokens."""
        return [t async for t in self]


class AsyncFrontend:
    """Asyncio host loop over a
    :class:`~repro_torch.serve.engine.ServeEngine`.

    Args:
        engine: the (already constructed) engine. The frontend owns its
            stepping for the lifetime of the context; do not call
            ``engine.step`` / ``run_until_drained`` concurrently.
        default_deadline_ms / default_priority: applied to submissions
            that don't specify their own.
        idle_sleep_s: pump back-off while the engine is empty (an
            arrival event wakes it immediately; this only bounds the
            latency of wakeups racing a step).
        stop_followers: on a mesh, whether :meth:`aclose` stops the
            engine's followers (the other ranks' ``engine.follow()``).

    Use as an async context manager (``async with AsyncFrontend(engine)
    as fe:``) or call :meth:`start` / :meth:`aclose` explicitly.
    """

    def __init__(self, engine, *, default_deadline_ms: Optional[float] = None,
                 default_priority: int = 0, idle_sleep_s: float = 0.02,
                 stop_followers: bool = True):
        comm = getattr(engine, "_comm", None)
        if comm is not None and comm.rank != 0:
            raise RuntimeError(
                "on a mesh the frontend lives on rank 0; rank "
                f"{comm.rank} runs engine.follow()")
        self.engine = engine
        self.stop_followers = stop_followers
        self._mesh = comm is not None
        self.default_deadline_ms = default_deadline_ms
        self.default_priority = default_priority
        self.idle_sleep_s = idle_sleep_s
        self._uids = itertools.count()
        self._inbox: List[RequestStream] = []
        self._streams: List[RequestStream] = []
        self._wake: Optional[asyncio.Event] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closing = False
        # one dedicated worker: engine.step is single-threaded by design;
        # it binds itself to the engine's card before its first task
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-step",
            initializer=self._bind_device)

    def _bind_device(self) -> None:
        """Make the card holding the engine's state the step worker's
        current CUDA device (no-op on the CPU)."""
        dev = self.engine.state["tokens"].device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)

    # ---- lifecycle ----
    async def start(self) -> "AsyncFrontend":
        """Start the pump task (idempotent)."""
        if self._pump_task is None:
            self._loop = asyncio.get_running_loop()
            self._wake = asyncio.Event()
            self._closing = False
            self._pump_task = asyncio.create_task(self._pump(),
                                                  name="serve-pump")
        return self

    async def aclose(self) -> None:
        """Stop the pump. In-flight streams are ended (``done`` stays
        False on their requests); the engine keeps its state.

        Shutdown is cooperative (a flag the pump checks each iteration),
        NOT ``task.cancel()``: on Python < 3.12 a cancel landing while
        ``asyncio.wait_for`` resolves its inner future is silently
        swallowed, leaving the pump alive and ``await task`` wedged.
        """
        task, self._pump_task = self._pump_task, None
        if task is not None:
            self._closing = True
            self._wake.set()        # pump exits at its next iteration
            try:
                await task
                if self.stop_followers:
                    # after a clean exit only: a failed step leaves the
                    # followers inside its collectives
                    await asyncio.get_running_loop().run_in_executor(
                        self._executor, self.engine.stop_followers)
            finally:
                self._executor.shutdown(wait=True)
        else:
            self._executor.shutdown(wait=True)
        for h in self._streams:
            if h.finish_t is None:
                h._post([], done=True)
        self._streams.clear()

    async def __aenter__(self) -> "AsyncFrontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # ---- submission ----
    async def submit(self, prompt: Sequence[int], *,
                     max_new_tokens: int = 32, temperature: float = 0.0,
                     top_k: int = 0, seed: int = 0, eos_id: int = -1,
                     deadline_ms: Optional[float] = None,
                     priority: Optional[int] = None) -> RequestStream:
        """Submit one request; returns its :class:`RequestStream`.

        Args mirror :class:`~repro_torch.serve.engine.Request`; ``prompt``
        is a sequence of int token ids. ``deadline_ms`` / ``priority`` default
        to the frontend's configured defaults.

        Raises:
            ValueError: same never-admittable conditions as
                ``ServeEngine.submit`` (checked on the event loop, before
                the request reaches the queue — the caller gets the
                error, not a poisoned engine).
            RuntimeError: if the frontend is not started.
        """
        if self._pump_task is None:
            raise RuntimeError("AsyncFrontend is not started; use "
                               "'async with AsyncFrontend(engine):' or "
                               "await start()")
        req = Request(
            uid=next(self._uids),
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, seed=seed, eos_id=eos_id,
            deadline_ms=(self.default_deadline_ms if deadline_ms is None
                         else deadline_ms),
            priority=(self.default_priority if priority is None
                      else priority))
        self._precheck(req)
        handle = RequestStream(req, self._loop)
        req.on_tokens = handle._on_tokens
        self._inbox.append(handle)
        self._wake.set()
        return handle

    def _precheck(self, req: Request) -> None:
        """Run the engine's never-admittable submit validation without
        touching engine state (pure reads of sizing attributes)."""
        eng = self.engine
        if req.max_new_tokens > eng.max_new_cap:
            raise ValueError(f"max_new_tokens={req.max_new_tokens} exceeds "
                             f"max_new_cap={eng.max_new_cap}")
        need = len(req.prompt) + req.max_new_tokens - 1
        limit = eng.max_seq_len if eng._paged else (
            eng.cache_len if eng._cache_bound else None)
        if limit is not None and need > limit:
            raise ValueError(f"request needs {need} cache tokens but this "
                             f"engine serves at most {limit} per request")

    # ---- pump ----
    def _work_pending(self) -> bool:
        eng = self.engine
        return bool(self._inbox or eng._has_work())

    def _drain_inbox(self) -> None:
        """Move arrivals into the engine queue (pump/loop thread only,
        never concurrent with a step)."""
        while self._inbox:
            handle = self._inbox.pop(0)
            self._streams.append(handle)
            try:
                self.engine.submit(handle.request)
            except ValueError:
                # raced past _precheck (e.g. engine reconfigured):
                # surface as a shed/rejected stream, don't kill the pump
                handle.request.shed = True
                handle._post([], done=True)
        self._streams = [h for h in self._streams if h.finish_t is None]

    async def _pump(self) -> None:
        """The host loop: drain arrivals, step the engine in a worker
        thread (the event loop keeps serving arrivals / HTTP / streams
        while the device computes), park on the wake event when idle.

        Exits when :meth:`aclose` raises the closing flag. If a step
        raises, every open stream is ended first (``request.done`` stays
        False — how clients distinguish an engine failure from a normal
        finish) so no awaiter hangs, then the error surfaces in
        ``aclose``."""
        loop = asyncio.get_running_loop()
        try:
            while not self._closing:
                self._drain_inbox()
                if self._work_pending():
                    await loop.run_in_executor(self._executor,
                                               self.engine.step)
                else:
                    self._wake.clear()
                    if self._closing:
                        break
                    if self._mesh:
                        await loop.run_in_executor(
                            self._executor, self.engine.heartbeat,
                            HEARTBEAT_S)
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               self.idle_sleep_s)
                    except asyncio.TimeoutError:
                        pass
        except Exception:
            for h in self._inbox + self._streams:
                if h.finish_t is None:
                    h._post([], done=True)
            self._inbox.clear()
            raise

    # ---- conveniences ----
    async def complete(self, prompt: Sequence[int], **kw) -> Request:
        """Submit and wait for the full completion (non-streaming path);
        returns the finished engine Request."""
        handle = await self.submit(prompt, **kw)
        await handle.tokens()
        return handle.request

    async def stats(self) -> dict:
        """Engine stats snapshot (keys in ``ServeEngine.stats``), plus a
        ``"metrics"`` digest of the pushed TTFT/TPOT/latency histograms
        (``ServeMetrics.snapshot``).

        Runs on the step worker so the device read serializes with any
        step in flight: the engine's state tensors are replaced and
        updated in place by a step, so they are never read mid-step."""
        def snap():
            st = self.engine.stats()
            st["metrics"] = self.engine.metrics.snapshot()
            return st
        if self._pump_task is None:
            return snap()
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, snap)
