"""Continuous-batching serve engine over the quantized KV cache.

Slot engine in the reference's shape, with the host touching the device
only at admission and harvest:

* **Batched prefill** — the scheduler hands over up to ``slots`` queued
  requests at once; they are right-padded to a length bucket and prefilled
  in one call (per-row ``lengths`` keep the cache and logits exact; see
  ``models.prefill``), and each row's first token is sampled there. A
  recurrent arch (xLSTM) would fold the padding into its state, so it
  admits groups of equal prompt length, unpadded, and its state does not
  bound the context (no ``cache_len`` check); the paged layout needs an
  attention-only decoder and is refused for it.
* **Decode chunks** — sampling (greedy / temperature / top-k, each slot
  with its own jax-style PRNG key), per-slot EOS + max-token tracking and
  the generated-token buffers live in device tensors; a chunk runs up to
  ``decode_block`` decode steps. The host never reads the device inside a
  chunk: it bounds the chunk by the largest remaining token budget it
  knows from the last harvest, and slots that stop early (EOS) ride along
  masked. The host syncs once per chunk, at harvest, to retire finished
  slots.
* **Paged KV cache** (``kv_layout="paged"``) — attention layers share one
  global pool of fixed-size quantized blocks addressed through a per-slot
  block table; ``serve.block_alloc`` owns the refcounted pool on the host.
  Admission asks for enough free blocks instead of a ``cache_len``
  stripe, blocks are allocated lazily as decode crosses block boundaries,
  and harvest returns them. Prompts longer than ``prefill_chunk`` are
  admitted window by window (``models.prefill_tail``).
* **Prefix sharing** (``prefix_cache=True``, paged only) — full blocks of
  written tokens are content-addressed in the allocator's rolling-hash
  index; a request whose prompt extends a cached prefix maps those blocks
  (refcount++) and prefills only the uncached tail. The *split block*
  where two prompts diverge is shared too and cloned on the device on
  first write (copy-on-write: every pool leaf in one launch of
  ``kernels.kvq_attn.ops.copy_pool_blocks_multi``).
* **Batched tail-wave** — up to ``tail_batch`` tail or chunked prefills
  are in flight at once, and every engine step advances all of them by
  one window in one ``prefill_tail`` call with per-row ``(c0, tail_len)``
  offsets. ``prefix_affinity`` orders the queue so requests sharing a
  cached chain admit back-to-back while the chain is hot in the LRU.
* **Preemption / swap** (``admission="optimistic"``, paged only) —
  admission allocates only the prompt's first window instead of debiting
  the worst case; when the pool later runs dry the engine picks a victim
  (``preempt="last_admitted"`` or ``"longest_remaining"``), copies its
  int8 blocks and scales to host memory, requeues it and restores it
  exactly once the pool recovers: decode resumes mid-stream with the same
  tokens.
* **Speculative decoding** (``spec=SpecConfig(...)``, paged only) — a
  draft made of the target's first layers proposes ``k`` tokens per slot
  from its own dense cache, the target verifies every resident's window
  in one verify-wave (``models.spec_verify``) and commits the accepted
  prefix plus one token of its own; the rejected suffix rolls back
  (device counters re-clamped, ``BlockAllocator.trim`` on the host).
  In ``exact`` mode the streams are plain decode's.
* **Kernels** — under ``weights_layout="w4a8"`` every linear runs the
  packed-int4 x int8 matmul; decode attention runs the int8-cache
  flash-decode kernel (dense, and the draft's cache) or its block-table
  walk (paged); the verify-wave's attention runs the multi-query
  block-table kernel; the tail-wave's history read runs the fused
  gather-dequantize kernel, and COW the pool-block copy. On CUDA tensors
  these are the hand-written kernels of ``repro_torch/csrc``, on CPU
  tensors their plain versions.
* **Streaming + SLO-aware admission** — a request may carry an
  ``on_tokens`` callback: freshly decoded spans drain from the harvest at
  decode-chunk / spec-wave granularity (and at swap-out) instead of only
  at finish. Requests may carry a first-token ``deadline_ms`` and a
  ``priority`` class: ``sched_policy="edf"`` admits
  earliest-deadline-first within priority, and ``slo_shed``
  (``"reject"`` / ``"downgrade"``) drops or demotes queued requests
  whose predicted TTFT, fitted from this engine's measured prefill and
  decode rates, already misses their deadline. ``serve.frontend`` and
  ``serve.http`` build the asyncio host loop and the HTTP endpoint on
  these hooks; ``self.metrics`` holds the TTFT / TPOT / latency
  histograms behind ``GET /v1/metrics``.
* **decode_block="auto"** — a probe times one decode chunk of 1 and of 8
  steps at construction and picks the chunk length (memoized per
  process and configuration).

* **Tensor-parallel serving** (``mesh=``, a ``launch.mesh.Mesh`` with a
  ``"model"`` axis of ``tp`` ranks; each rank builds its engine on the
  same requests) — the served tree is cut by
  ``runtime.sharding.shard_params`` after the w4a8 export: column-
  parallel q/k/v/gate/up and the vocabulary-parallel embedding and head,
  row-parallel o/down, whose amax and int32 accumulators are all-reduced
  exactly (``kernels.w4a8.ops.w4a8_linear_row``). Each rank computes
  ``n_heads / tp`` query and ``n_kv_heads / tp`` KV heads and holds the
  pool (and the draft's cache) at ``n_kv_heads / tp`` heads, as
  ``serve_cache_spec`` shards it; where ``tp`` is a multiple of
  ``n_kv_heads`` (more ranks than KV heads), each rank holds the one
  whole KV head its query heads read (``sharding.kv_head_local``); where
  ``tp`` does not divide the heads, every rank holds and runs the whole
  attention and the whole pool (``sharding.attn_replicated``). An MoE
  layer keeps its router whole and ``n_experts / tp`` experts a rank,
  its combine gathering each top-k slot from its owner bit for bit
  (expert parallelism), or, where ``tp`` does not divide the experts,
  every expert's ``d_ff / tp`` slice (TP inside experts, within a
  tolerance of tp=1: ``models.blocks.moe_fwd``). The logits are gathered
  whole on every rank, so the sampled tokens, and the host loop that
  follows them, are the same on every rank; rank 0's clock and measured
  rates are broadcast once a host step, so no admission or shed decision
  reads a rank's own clock. The recurrent blocks serve at tp too
  (``models.recurrent``: the RG-LRU's width and the mLSTM's heads cut
  over the ranks, their states each rank's slice, the sLSTM's
  recurrence whole on every rank; local attention as a sliding window).
  Streams are bitwise tp=1's under ``weights_layout="w4a8"`` (TP inside
  experts apart); under ``"bf16"`` the row-parallel linears sum f32
  partials, within a tolerance of tp=1. An encoder-decoder is refused
  (it is not served at tp=1 either).

  Rank 0 alone takes requests and drives; the other ranks run
  :meth:`ServeEngine.follow` until rank 0's :meth:`stop_followers` (its
  ``run_until_drained`` ends with one). On a mesh rank 0's ``submit``
  only queues a request, and each host step (``step``) starts with one
  broadcast from rank 0 carrying its command (step, admit, reset, an
  idle heartbeat or stop), its clock, its measured rates and the
  requests submitted on it since the last step
  (``runtime.collectives.TPComm.broadcast_submissions``), which every
  rank then enqueues alike, stamped with rank 0's submit time; a
  follower returns its copies of them. Only rank 0 calls ``on_tokens``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.bridge import flatten
from repro_torch.configs.base import (ATTENTION_BLOCKS, BLOCK_ATTN,
                                      BLOCK_MLSTM, BLOCK_RGLRU, BLOCK_SLSTM,
                                      RECURRENT_BLOCKS, ModelConfig)
from repro_torch.core.precision import parse_policy
from repro_torch.core.qat import (attach_w4a8_exports, make_ctx,
                                  w4a8_weight_bytes)
from repro_torch.device import resolve_device
from repro_torch.kernels.kvq_attn.ops import copy_pool_blocks_multi
from repro_torch.models import (decode_step, init_cache, prefill,
                                prefill_tail, spec_verify)
from repro_torch.models.blocks import POOL_KEYS
from repro_torch.obs.metrics import ServeMetrics
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.runtime.collectives import SUBMISSION_KEYS, TPComm
from repro_torch.runtime.sharding import (attn_replicated, bank_leaf,
                                         shard_params)
from repro_torch.serve.block_alloc import BlockAllocator, PoolDry
from repro_torch.serve.sampling import (TOP_K_CAP, fold_step, sample_tokens,
                                        slot_key, token_probs)
from repro_torch.serve.scheduler import (PREEMPT_POLICIES, SHED_MODES,
                                         Scheduler)
from repro_torch.serve.spec import (SpecConfig, accept_exact,
                                    accept_rejection, make_draft)


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= max(n, 1). The tail-wave's history walk is
    bucketed with it as in the reference, so both read the same number of
    table entries and compute the same masked softmax."""
    p = 1
    while p < n:
        p *= 2
    return p


def _jsonable(x):
    """Recursively cast numpy scalars and arrays and torch tensors to
    native Python types. ``stats()`` is an HTTP boundary (``/v1/stats``,
    ``/v1/metrics``): a stray ``np.int64`` deep in the dict is invisible
    until ``json.dumps`` raises in the server."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return _jsonable(x.tolist())
    return x


# decode_block="auto" probe results, memoized per process so scripts
# constructing several engines of one configuration probe once
_PROBE_CACHE: Dict[tuple, Dict] = {}
PROBE_CANDIDATES = (4, 8, 16, 32)


def pick_decode_block(t1: float, t8: float,
                      candidates=PROBE_CANDIDATES) -> int:
    """The ``decode_block="auto"`` rule, from the seconds of one decode
    chunk of 1 step (``t1``) and of 8 steps (``t8``), each with its host
    sync. Their difference splits a chunk into a per-step part and a
    fixed part (dispatch and the sync after every chunk); the pick is the
    smallest candidate whose fixed cost is at most 15% of its steps'
    compute, since a longer chunk wastes steps on slots that finish
    mid-chunk."""
    per_step = max((t8 - t1) / 7.0, 1e-9)
    overhead = max(t1 - per_step, 0.0)
    for c in candidates:
        if overhead <= 0.15 * c * per_step:
            return c
    return candidates[-1]


@dataclass(eq=False)                    # identity equality: the ndarray
class Request:                          # prompt field breaks value __eq__
    uid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                    # -1: never stops early
    temperature: float = 0.0            # <= 0: greedy
    top_k: int = 0                      # 0: no top-k filtering
    seed: int = 0
    # --- SLO class (scheduler policy "edf" + engine slo_shed) ---
    deadline_ms: Optional[float] = None  # first-token SLO, from submit
    priority: int = 0                    # lower = more urgent (EDF class)
    # --- streaming ---
    # called as on_tokens(req, new_tokens, done) with each freshly
    # decoded span (decode_block / spec-wave granularity) instead of only
    # at finish; fires from whatever thread steps the engine
    on_tokens: Optional[Callable] = None
    generated: List[int] = field(default_factory=list)
    done: bool = False
    shed: bool = False                  # rejected by SLO admission control
    _arrival: int = 0                   # set by the scheduler
    _streamed: int = 0                  # tokens already sent to on_tokens


def _clamp_lengths(cache: Dict, lens: torch.Tensor) -> None:
    """Set every layer's per-slot ``length`` and the cache ``position`` to
    ``lens``, in place: the device half of speculative rollback (the
    draft cache before drafting, the target cache after acceptance)."""
    for layer in cache["layers"]:
        layer["length"].copy_(lens)
    cache["position"].copy_(lens)


def _check_tp(cfg: ModelConfig, tp: int, weights_layout: str) -> None:
    """Refuse what tensor-parallel serving does not cover: an encoder
    (its cross caches; the engine serves no encoder-decoder, ROADMAP
    Queue 1 item 3d), an MoE whose experts ``tp`` does not divide with a
    ``d_ff`` it does not divide either (TP inside experts splits every
    expert's d_ff), and a width the rules cut that ``tp`` does not
    divide: a dense ``d_ff`` whose packed row-parallel plane ``tp`` would
    cut inside a nibble pair (w4a8), the RG-LRU's width, the mLSTM's
    heads and width, the sLSTM's up-projection (and, under w4a8, their
    packed rows). Query heads ``tp`` does not divide are served with the
    whole attention on every rank (``runtime.sharding.attn_replicated``);
    both weight layouts are served."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"tensor-parallel serving of {cfg.name!r} needs an encoder and "
            "its cross-attention caches, which the engine does not serve "
            "at tp=1 either (ROADMAP Queue 1 item 3d)")
    if cfg.is_moe and cfg.n_experts % tp and cfg.d_ff % tp:
        raise ValueError(
            f"tp={tp} divides neither {cfg.name!r}'s {cfg.n_experts} "
            f"experts nor their d_ff={cfg.d_ff}: no expert parallelism and "
            "no TP inside the experts")
    packed = weights_layout == "w4a8"
    if not cfg.is_moe and cfg.d_ff and cfg.d_ff % tp == 0 and packed \
            and (cfg.d_ff // 2) % tp:
        raise ValueError(
            f"tp={tp} divides d_ff={cfg.d_ff} but not its packed rows "
            f"({cfg.d_ff // 2}): wd's packed plane would stay whole while "
            "its input is cut")
    kinds = set(cfg.layer_kinds())
    d = cfg.d_model
    # (what, its size, whether a row-parallel linear reads it as K)
    cuts = []
    if BLOCK_RGLRU in kinds:
        cuts.append(("the RG-LRU's width", cfg.resolved_lru_width, True))
    if BLOCK_MLSTM in kinds:
        m = int(cfg.mlstm_proj_factor * d)
        cuts += [("the mLSTM's heads", cfg.n_heads, False),
                 ("the mLSTM's width", m, True)]
    if BLOCK_SLSTM in kinds:
        cuts.append(("the sLSTM's up-projection",
                     int(cfg.slstm_proj_factor * d), True))
    for what, n, rows in cuts:
        rows = rows and packed
        if n % tp or (rows and (n // 2) % tp):
            raise ValueError(
                f"tp={tp} does not divide {cfg.name!r}'s {what} ({n}"
                + (f"; {n // 2} packed rows" if rows else "")
                + "), which its rule cuts over the ranks")
    if BLOCK_MLSTM in kinds and int(cfg.mlstm_proj_factor / tp * d) * tp \
            != int(cfg.mlstm_proj_factor * d):
        raise ValueError(
            f"the mLSTM's width at tp={tp} is not a projection factor of "
            f"d_model={d} a rank (_rank_config)")


def _rank_config(cfg: ModelConfig, tp: int, attn_whole: bool) -> ModelConfig:
    """The config the model code runs on one of ``tp`` ranks: its query
    and KV heads (head-major halves keep each GQA group on one rank;
    where tp exceeds the KV heads, one whole KV head a rank; where tp
    does not divide the heads, every head: ``attn_replicated``), its
    RG-LRU channels (``lru_width / tp``) and its mLSTM heads' width (the
    projection factor over tp; the sLSTM's recurrence is whole)."""
    if tp == 1:
        return cfg
    kw = {}
    if not attn_whole:
        kw.update(n_heads=cfg.n_heads // tp,
                  n_kv_heads=max(cfg.n_kv_heads // tp, 1),
                  head_dim=cfg.resolved_head_dim)
    kinds = set(cfg.layer_kinds())
    if BLOCK_RGLRU in kinds:
        kw["lru_width"] = cfg.resolved_lru_width // tp
    if BLOCK_MLSTM in kinds:
        kw["mlstm_proj_factor"] = cfg.mlstm_proj_factor / tp
    return cfg.replace(**kw)


# a mesh's host-step commands, rank 0's, broadcast by ``_sync_host``
_STEP, _RESET, _STOP, _ADMIT, _PING = 0, 1, 2, 3, 4


def _submission_fields(req: "Request", submit_t: float) -> Dict:
    """What a rank > 0 needs of one of rank 0's submissions
    (``SUBMISSION_KEYS``) besides its prompt."""
    d = {k: getattr(req, k) for k in SUBMISSION_KEYS if k != "submit_t"}
    d["submit_t"] = submit_t
    return d


class _BroadcastClock:
    """A mesh engine's clock: rank 0's ``perf_counter`` as of the last
    host step, set by ``ServeEngine._sync_host``. An object of its own,
    so the scheduler that reads it holds no reference to the engine (a
    cycle would keep a deleted engine's cache and weights alive until
    the garbage collector ran)."""

    __slots__ = ("now",)

    def __init__(self):
        self.now = time.perf_counter()

    def __call__(self) -> float:
        return self.now


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == \
        (b.index if b.index is not None else cur)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, policy: str = "A8d-C8-W4",
                 slots: int = 8, cache_len: int = 512,
                 max_new_cap: int = 256,
                 decode_block: Union[int, str] = 8,
                 sched_policy: str = "fcfs", prefill_bucket: int = 16,
                 kv_layout: str = "dense", block_size: int = 64,
                 num_blocks: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 table_len: Optional[int] = None,
                 prefix_cache: bool = True,
                 admission: str = "reserve",
                 preempt: str = "last_admitted",
                 tail_batch: int = 0,
                 prefix_affinity: bool = True,
                 slo_shed: str = "none",
                 spec=None,
                 mesh=None,
                 weights_layout: str = "bf16",
                 trace: Optional[Tracer] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.mesh = mesh
        self.tp = 1
        if mesh is not None:
            axes = tuple(getattr(mesh, "axis_names", ()))
            if "model" not in axes:
                raise ValueError(
                    "serving mesh needs a 'model' axis for tensor "
                    f"parallelism; got axes {axes}")
            if int(mesh.shape.get("data", 1)) != 1:
                raise NotImplementedError(
                    f"a serving mesh takes one data replica, got "
                    f"{mesh.shape}: serve each replica with its own "
                    "engine on a data-1 mesh")
            self.tp = int(mesh.shape["model"])
            if device is None:
                device = mesh.device
        if self.tp > 1:
            _check_tp(cfg, self.tp, weights_layout)
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                             f"got {kv_layout!r}")
        if cfg.is_encdec:
            # an encoder-decoder's prefill needs each request's encoder
            # input (batch["frames"]), which no request carries
            raise ValueError(
                f"{cfg.name!r} is an encoder-decoder: the engine serves "
                f"decoders only (kv_layout {kv_layout!r}: no request "
                "carries frames); serve it through models.prefill and "
                "models.decode_step with batch['frames']")
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"admission must be 'reserve' or 'optimistic', "
                             f"got {admission!r}")
        if preempt not in PREEMPT_POLICIES:
            raise ValueError(f"preempt must be one of {PREEMPT_POLICIES}, "
                             f"got {preempt!r}")
        if spec is not None and kv_layout != "paged":
            raise ValueError("speculative decoding requires "
                             "kv_layout='paged' (the rollback path is the "
                             "paged allocator's trim)")
        if slo_shed not in SHED_MODES:
            raise ValueError(f"slo_shed must be one of {SHED_MODES}, "
                             f"got {slo_shed!r}")
        if weights_layout not in ("bf16", "w4a8"):
            raise ValueError(f"weights_layout must be 'bf16' or 'w4a8', "
                             f"got {weights_layout!r}")
        if kv_layout == "paged" and (cfg.sliding_window or any(
                k != BLOCK_ATTN for k in cfg.block_pattern)):
            raise ValueError(
                "kv_layout='paged' requires a full-attention decoder (no "
                f"sliding window / recurrence); {cfg.name!r} has block "
                f"pattern {cfg.block_pattern}")
        self.device = resolve_device(device)
        if not _same_device(params["embed"]["w"].device, self.device):
            raise ValueError(
                f"params live on {params['embed']['w'].device} but the "
                f"engine serves on {self.device}; build them there "
                f"(init_params(..., device=...))")
        self.cfg = cfg
        # the config the model code runs: on a mesh, this rank's heads
        # and recurrent widths (_rank_config)
        self._attn_whole = attn_replicated(cfg, self.tp)
        self.mcfg = _rank_config(cfg, self.tp, self._attn_whole)
        self._comm = TPComm(mesh) if self.tp > 1 else None
        # on a mesh: rank 0's submissions since the last host step, with
        # their submit times; a rank > 0's copies of them (follow); when
        # the last host step reached the followers
        self._outbox: List = []
        self._adopted: List[Request] = []
        self._synced_t = time.monotonic()
        self._pred_per_tok: Optional[float] = None
        self._pred_round_s: Optional[float] = None
        # the clock the scheduler and the shed predictor read: on a mesh,
        # rank 0's, broadcast once a host step (_sync_host)
        self._clock = (_BroadcastClock() if self._comm is not None
                       else time.perf_counter)
        # right-padded batched prefill is exact only when every block is
        # attention (causality isolates real tokens from padding);
        # recurrent scans absorb pad steps into their state, so those
        # admit exact-length groups instead
        self._pad_ok = all(k in ATTENTION_BLOCKS for k in cfg.block_pattern)
        # full (non-sliding) attention caches are a hard capacity bound;
        # recurrent state is not
        self._cache_bound = (BLOCK_ATTN in cfg.block_pattern
                             and not cfg.sliding_window)
        # observability rides on the engine from construction: the tracer
        # (a disabled NULL_TRACER unless the caller wants a trace; spans
        # still measure) and the pushed-histogram half of /v1/metrics
        self.trace = trace if trace is not None else NULL_TRACER
        self.metrics = ServeMetrics()
        self.weights_layout = weights_layout
        self._w4a8_bytes = {"packed": 0, "replaced": 0}
        if weights_layout == "w4a8":
            pol = parse_policy(policy)
            # the packed path is real integer arithmetic at int8 activations
            # x int4 weights; a policy trained differently would serve
            # numerics it never saw
            if not (pol.enabled and pol.act_bits == 8 and pol.act_dynamic
                    and pol.weight_bits <= 4):
                raise ValueError(
                    "weights_layout='w4a8' needs a dynamic-A8 W4 policy "
                    f"(e.g. 'A8d-C8-W4'); got {policy!r}")
            params = attach_w4a8_exports(params, pol)
            self._w4a8_bytes = w4a8_weight_bytes(params)
        if self.tp > 1:
            # this rank's slice of every leaf, packed planes included, so
            # the draft built below slices already-sharded leaves
            params = shard_params(params, cfg, mesh)
        self.ctx = make_ctx(policy, weights_layout=weights_layout,
                            tp=self._comm, attn_whole=self._attn_whole)
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.max_new_cap = max_new_cap
        self.prefill_bucket = prefill_bucket
        auto_block = decode_block == "auto"
        self.decode_block = 8 if auto_block else int(decode_block)
        self._paged = kv_layout == "paged"
        if self._paged:
            self.block_size = block_size
            # default pool = the dense engine's total reservation, so the
            # two layouts are comparable at equal memory
            self.num_blocks = num_blocks or max(
                1, slots * cache_len // block_size)
            # default per-request cap matches the dense stripe: the table
            # width bounds how many keys each decode step walks
            self.max_seq_len = max_seq_len or min(
                cache_len, self.num_blocks * block_size)
            self.table_len = table_len or -(-self.max_seq_len // block_size)
            self.prefill_chunk = prefill_chunk or 4 * prefill_bucket
            # tail_batch caps how many tail/chunked prefills ride one
            # wave; 0 = every slot, 1 = one tail per step
            if not 0 <= tail_batch <= slots:
                raise ValueError(f"tail_batch must be in [0, slots={slots}]"
                                 f", got {tail_batch}")
            self.tail_batch = tail_batch or slots
        self.prefix_cache = prefix_cache and self._paged
        self.prefix_affinity = prefix_affinity and self.prefix_cache
        self.admission = admission
        self.preempt = preempt
        self.slo_shed = slo_shed
        self._decode_block_mode = "auto" if auto_block else "fixed"
        self.decode_block_probe: Optional[Dict] = None
        self.spec = None
        if spec is not None:
            self.spec = spec if isinstance(spec, SpecConfig) \
                else SpecConfig(**spec)
            # the draft slices the (export-attached) target tree, so under
            # w4a8 it serves the same packed weights
            self.draft_cfg, self.draft_params = make_draft(self.mcfg,
                                                           params,
                                                           self.spec)
            self.draft_ctx = make_ctx(self.spec.draft_policy or policy,
                                      weights_layout=weights_layout,
                                      tp=self._comm,
                                      attn_whole=self._attn_whole)
            # the draft runs up to k positions past the accepted extent
            # before rollback; its dense ring must never wrap into history
            self._draft_cache_len = self.max_seq_len + self.spec.k + 1
            # one draft + verify wave per engine step commits up to k + 1
            # tokens per slot
            self.decode_block = self.spec.k + 1
            self._decode_block_mode = "spec"
        self._sched_policy = sched_policy
        self.scheduler = Scheduler(sched_policy, trace=self.trace,
                                   clock=self._clock)
        self.reset()
        if auto_block and self.spec is None:
            # with spec on, the draft + verify wave owns step granularity
            # and the probe never runs. Everything that changes a decode
            # step's cost is in the key.
            # The mesh shape is in it: a tp=2 step (collectives, each
            # rank's halved GEMMs) must not replay a tp=1 probe.
            key = (cfg, policy, slots, kv_layout, cache_len, max_new_cap,
                   self.block_size if self._paged else 0,
                   self.num_blocks if self._paged else 0,
                   self.table_len if self._paged else 0,
                   weights_layout, str(self.device),
                   tuple(sorted(mesh.shape.items()))
                   if mesh is not None else None)
            if key not in _PROBE_CACHE:
                _PROBE_CACHE[key] = self._probe_decode_block()
            self.decode_block_probe = _PROBE_CACHE[key]
            self.decode_block = self.decode_block_probe["pick"]

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def _blank_state(self) -> Dict:
        slots, dev = self.slots, self.device
        i32 = {"dtype": torch.int32, "device": dev}
        if self._paged:
            cache = init_cache(self.mcfg, self.ctx, slots, self.cache_len,
                               device=dev, num_blocks=self.num_blocks,
                               page_size=self.block_size,
                               table_len=self.table_len)
        else:
            cache = init_cache(self.mcfg, self.ctx, slots, self.cache_len,
                               device=dev)
        return {
            "cache": cache,
            "tokens": torch.zeros((slots, 1), **i32),
            "out": torch.zeros((slots, self.max_new_cap), **i32),
            "n_gen": torch.zeros((slots,), **i32),
            "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
            "eos": torch.full((slots,), -1, **i32),
            "max_new": torch.ones((slots,), **i32),
            "temp": torch.zeros((slots,), dtype=torch.float32, device=dev),
            "top_k": torch.zeros((slots,), **i32),
            # each slot's PRNG key: two uint32 words held in int64
            "keys": torch.zeros((slots, 2), dtype=torch.int64, device=dev),
            "steps": torch.zeros((), **i32),
            "committed": torch.zeros((), **i32),
        }

    def reset(self) -> None:
        """Clear all serving state: queued, resident and swapped requests,
        the cache (and the draft's), the block allocator, the scheduler
        and every stat.
        Requests submitted before the reset must not be resubmitted with
        their old prefix-lookup memos: an epoch bump invalidates them.
        The old cache is dropped before the new one is allocated, so two
        never live at once. On a mesh rank 0's reset reaches its
        followers as a host step's command, inside :meth:`follow`, or
        every rank calls it outside."""
        if self._sync_host(_RESET) != _RESET:
            raise RuntimeError("mesh ranks out of step: this rank reset "
                               "while rank 0 stepped or stopped")
        self._reset_state()

    def _reset_state(self) -> None:
        self._outbox = []
        self.state = None
        self.state = self._blank_state()
        self._alloc_epoch = getattr(self, "_alloc_epoch", -1) + 1
        self.alloc = (BlockAllocator(self.num_blocks, self.block_size,
                                     self.slots, self.table_len,
                                     prefix_cache=self.prefix_cache)
                      if self._paged else None)
        self._slot_req: Dict[int, Request] = {}
        self._n_gen: Dict[int, int] = {}     # host mirror, as of harvest
        self._written: Dict[int, int] = {}   # paged: tokens committed/slot
        self._tbl_dirty = False              # host table mirror vs device
        self._tail_jobs: List[Dict] = []     # in-progress tail prefills
        self._swapped: List[Dict] = []       # preempted, awaiting restore
        self._admit_seq: Dict[int, int] = {}     # slot -> admission order
        self._seq = 0
        self._max_residents = 0
        self.scheduler = Scheduler(self._sched_policy, trace=self.trace,
                                   clock=self._clock)
        # a fresh run gets a fresh observability window: a rerun must not
        # inherit the previous pass's spans or histogram mass
        self.trace.clear()
        self.metrics.reset()
        self._step_idx = 0
        self._pred_per_tok: Optional[float] = None   # fastest s/prompt-tok
        self._pred_round_s: Optional[float] = None   # fastest decode round
        self._host = {"decode_s": 0.0, "decode_rounds": 0,
                      "prefill_s": 0.0, "prefill_calls": 0,
                      "prefill_tokens": 0, "prefill_chunks": 0,
                      "prompt_tokens": 0, "prefix_hit_tokens": 0,
                      "cow_copies": 0, "tail_waves": 0, "preemptions": 0,
                      "swap_out_bytes": 0, "swap_in_bytes": 0,
                      "swap_s": 0.0}
        if self.spec is not None:
            self._draft_cache = None
            self._draft_cache = init_cache(self.draft_cfg, self.draft_ctx,
                                           self.slots,
                                           self._draft_cache_len,
                                           device=self.device)
            self._host.update({"spec_waves": 0, "spec_drafted": 0,
                               "spec_accepted": 0, "spec_rolled_back": 0,
                               "spec_draft_prefill_tokens": 0})
        cache = self.state["cache"]
        leaves = (cache["pool"].values() if self._paged else
                  [t for layer in cache["layers"] for t in layer.values()])
        self._cache_bytes = sum(t.numel() * t.element_size() for t in leaves)
        self._state_bytes = 0 if self._paged else sum(
            t.numel() * t.element_size()
            for kind, layer in zip(self.cfg.layer_kinds(), cache["layers"])
            if kind in RECURRENT_BLOCKS for t in layer.values())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sync_host(self, cmd: int = _STEP) -> int:
        """On a mesh, once a host step: rank 0's command (``cmd``: a step,
        an admission, a reset, a heartbeat or the followers' stop), its
        clock and its measured prefill and decode rates replace every
        rank's own, so the ranks' host loops take the same decisions
        (admission, shedding) however their clocks drift; with a step or
        an admission, the requests submitted on rank 0 since the last
        step follow in a second broadcast and every rank enqueues them,
        stamped with their submit time on rank 0's clock (a rank > 0
        keeps its copies in ``_adopted``). Returns rank 0's command
        (``cmd`` itself off a mesh)."""
        if self._comm is None:
            return cmd
        lead = self._comm.rank == 0
        subs = self._outbox if lead and cmd in (_STEP, _ADMIT) else []
        nan = float("nan")
        hdr = self._comm.broadcast_floats(
            [cmd, time.perf_counter(),
             nan if self._pred_per_tok is None else self._pred_per_tok,
             nan if self._pred_round_s is None else self._pred_round_s,
             len(subs), sum(len(r.prompt) for r, _ in subs)]
            if lead else [nan] * 6)
        cmd, now, per_tok, round_s = int(hdr[0]), hdr[1], hdr[2], hdr[3]
        self._synced_t = time.monotonic()
        self._clock.now = now
        self._pred_per_tok = None if math.isnan(per_tok) else per_tok
        self._pred_round_s = None if math.isnan(round_s) else round_s
        if int(hdr[4]):
            got = self._comm.broadcast_submissions(
                [(_submission_fields(r, t), r.prompt) for r, t in subs]
                if lead else None, int(hdr[4]), int(hdr[5]))
            for (r, t), (fields, prompt) in zip(
                    subs if lead else [(None, None)] * len(got), got):
                if not lead:
                    r = Request(prompt=prompt.astype(np.int32), **{
                        k: fields[k] for k in SUBMISSION_KEYS
                        if k != "submit_t"})
                    self._adopted.append(r)
                self.scheduler.submit(r, now=fields["submit_t"])
            self._outbox = []
        return cmd

    def follow(self) -> List[Request]:
        """On a rank > 0 of a mesh: take rank 0's host steps, admissions,
        resets and heartbeats, in order, until rank 0 calls
        :meth:`stop_followers`. Returns this rank's copies of the
        requests rank 0 submitted meanwhile, in rank 0's order (they call
        no ``on_tokens``)."""
        if self._comm is None or self._comm.rank == 0:
            raise RuntimeError("follow() runs on the ranks > 0 of a mesh")
        self._adopted = []
        while True:
            cmd = self._sync_host()
            if cmd == _STOP:
                return self._adopted
            if cmd == _RESET:
                self._reset_state()
            elif cmd == _ADMIT:
                self._admit()
            elif cmd == _STEP:
                self._step_body()

    def stop_followers(self) -> None:
        """On rank 0 of a mesh: end the other ranks' :meth:`follow` (a
        later one takes rank 0's next steps). A no-op off a mesh and on a
        rank > 0."""
        if self._comm is not None and self._comm.rank == 0:
            self._sync_host(_STOP)

    def heartbeat(self, idle_s: float = 0.0) -> None:
        """On rank 0 of a mesh, if no host step has reached the followers
        for ``idle_s`` seconds: an empty command, so that a follower
        waiting in :meth:`follow` while rank 0 has no work (an idle
        frontend) sees a collective before the process group's timeout.
        A no-op off a mesh and on a rank > 0."""
        if (self._comm is not None and self._comm.rank == 0
                and time.monotonic() - self._synced_t >= idle_s):
            self._sync_host(_PING)

    def admit(self) -> None:
        """Admit what the queue allows, with no decode round: the state
        one admission wave leaves (``step`` admits, decodes and
        harvests). On a mesh rank 0's reaches its followers."""
        if self._sync_host(_ADMIT) != _ADMIT:
            raise RuntimeError("mesh ranks out of step: this rank admitted "
                               "while rank 0 did not")
        self._admit()

    def submit(self, req: Request) -> None:
        """Enqueue one request for serving.

        ``prompt`` is a 1-D array of token ids in the vocabulary;
        ``max_new_tokens`` bounds generation (the first token comes from
        prefill); ``temperature <= 0`` means greedy and ``top_k == 0``
        disables filtering; ``deadline_ms`` / ``priority`` feed the ``edf``
        scheduler policy and ``slo_shed`` admission control; ``on_tokens``
        (if set) receives every freshly decoded span as ``on_tokens(req,
        tokens, done)``. The request is admitted on a later :meth:`step`;
        ``req.done`` and ``req.generated`` carry the result, or
        ``req.shed`` if SLO admission control rejected it. On a mesh only
        rank 0 takes requests (the others :meth:`follow`); each is
        enqueued at its next :meth:`step`, on every rank (module
        docstring).

        Raises RuntimeError on a rank > 0 of a mesh, and ValueError if
        the request can never be admitted on this
        engine: ``max_new_tokens`` above ``max_new_cap``, ``top_k`` above
        ``TOP_K_CAP``, a token outside the vocabulary, or a footprint
        (``prompt + max_new_tokens - 1``) above ``cache_len`` (dense) or
        above ``max_seq_len``, the block table or the pool (paged). The
        message names the computed need and the knob to raise.
        """
        if self._comm is not None and self._comm.rank != 0:
            raise RuntimeError(
                f"on a mesh rank 0 takes every request; rank "
                f"{self._comm.rank} runs follow()")
        if req.max_new_tokens > self.max_new_cap:
            raise ValueError(
                f"max_new_tokens={req.max_new_tokens} exceeds this engine's "
                f"max_new_cap={self.max_new_cap} (the on-device token "
                f"buffer); construct ServeEngine with a larger max_new_cap")
        if req.top_k > TOP_K_CAP:
            raise ValueError(f"top_k={req.top_k} exceeds TOP_K_CAP="
                             f"{TOP_K_CAP} (static sampling bound)")
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or not len(prompt):
            raise ValueError("prompt must be a non-empty 1-D token array")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt tokens must lie in [0, "
                             f"{self.cfg.vocab_size})")
        # peak cache occupancy is prompt + max_new - 1: the last sampled
        # token is returned but its KV is never written while resident
        need = len(prompt) + req.max_new_tokens - 1
        if self._paged:
            if need > self.max_seq_len:
                raise ValueError(
                    f"request needs {need} cache tokens (prompt "
                    f"{len(prompt)} + max_new_tokens "
                    f"{req.max_new_tokens} - 1) but max_seq_len="
                    f"{self.max_seq_len}; raise max_seq_len or shorten "
                    f"the request")
            nb = self.alloc.blocks_for_tokens(need)
            if nb > self.table_len:
                raise ValueError(
                    f"request needs {nb} block-table entries ({need} tokens "
                    f"at block_size={self.block_size}) but the block table "
                    f"is only table_len={self.table_len} entries wide, so "
                    f"it can never be admitted; raise table_len or "
                    f"max_seq_len")
            if nb > self.num_blocks:
                raise ValueError(
                    f"request needs {nb} cache blocks ({need} tokens at "
                    f"block_size={self.block_size}) but the pool only has "
                    f"num_blocks={self.num_blocks}, so it can never be "
                    f"admitted; raise num_blocks")
        elif self._cache_bound and need > self.cache_len:
            raise ValueError(
                f"request needs {need} cache tokens (prompt "
                f"{len(prompt)} + max_new_tokens {req.max_new_tokens} "
                f"- 1) but cache_len={self.cache_len}; raise cache_len or "
                f"shorten the request")
        if self._comm is None:
            self.scheduler.submit(req)
        else:
            # reaches every rank with the next host step (_sync_host)
            self._outbox.append((req, time.perf_counter()))

    def _note_residency(self) -> None:
        n = len(self._slot_req) + len(self._tail_jobs)
        self._max_residents = max(self._max_residents, n)

    # ------------------------------------------------------------------
    # SLO-aware admission + streaming drain
    # ------------------------------------------------------------------

    def _predict_ttft_s(self, backlog_tokens: int) -> float:
        """Seconds until a queued request's first token when
        ``backlog_tokens`` prompt tokens must prefill before it (the
        requests ahead in policy order plus its own prompt): prefill
        seconds per prompt token times the backlog plus one decode round
        (the one in flight when it reaches the head). 0.0 until the engine
        has measured anything, so a cold engine never sheds blind. Rates
        are the fastest observed per call (a min, not a mean), so the
        first call's one-time cost (a kernel build and the allocator's
        warm-up) is not taken for service time."""
        if self._pred_per_tok is None:
            return 0.0
        return (self._pred_per_tok * backlog_tokens
                + (self._pred_round_s or 0.0))

    def _note_rate(self, attr: str, value: float) -> None:
        """Min-track a measured rate for the TTFT predictor."""
        cur = getattr(self, attr)
        setattr(self, attr, value if cur is None else min(cur, value))

    def _shed_overdue(self) -> None:
        """Shed-load pass before admission (``slo_shed != "none"``):
        requests whose predicted TTFT already exceeds their deadline are
        rejected (``req.shed = True``, stream closed with no tokens) or
        downgraded to best-effort, per the engine's ``slo_shed`` mode."""
        if self.slo_shed == "none" or not self.scheduler.pending:
            return
        for r in self.scheduler.shed_overdue(self._predict_ttft_s,
                                             self.slo_shed):
            r.shed = True
            r.done = True
            self.trace.event("shed", uid=r.uid)
            self._emit_stream(r, (), done=True)

    def _observe_ttft(self, req) -> None:
        tm = getattr(req, "_timing", None)
        if tm is not None:
            self.metrics.observe_ttft(tm.ttft)

    def _streams_to(self, req) -> bool:
        """Whether ``req``'s tokens go to its ``on_tokens`` from this
        engine: rank 0's only, on a mesh."""
        return req.on_tokens is not None and (self._comm is None
                                              or self._comm.rank == 0)

    def _emit_stream(self, req, toks, done: bool) -> None:
        """Deliver freshly decoded tokens, as Python ints, to a streaming
        request's ``on_tokens`` callback (no-op for other requests, and
        on a mesh's ranks > 0)."""
        if self._streams_to(req):
            toks = [int(t) for t in toks]
            req.on_tokens(req, toks, done)
            req._streamed += len(toks)
        elif done:
            req._streamed = len(req.generated)

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    def _free_slots(self) -> List[int]:
        busy = set(self._slot_req)
        busy.update(j["slot"] for j in self._tail_jobs)
        return [s for s in range(self.slots) if s not in busy]

    def _admit(self) -> None:
        self._shed_overdue()
        if self._paged:
            self._admit_paged()
            return
        free = self._free_slots()
        if not free or not self.scheduler.pending:
            return
        reqs = self.scheduler.select(len(free),
                                     equal_length_only=not self._pad_ok)
        if not reqs:
            return
        self._admit_wave(reqs, free[:len(reqs)])
        self._note_residency()

    def _affinity_key(self, req):
        """Grouping key for prefix-aware scheduling: requests whose
        prompts extend the same cached chain share its block-id tuple, so
        the scheduler pulls them back-to-back (a miss returns None). The
        order is a hint, so a stale key is acceptable: each request pays
        one real lookup on first sight and then reuses its last known key
        until a real lookup refreshes it."""
        ver2 = (id(self), self._alloc_epoch)
        memo = getattr(req, "_prefix_hit", None)
        if memo is not None and memo[0] == ver2 + (
                self.alloc.index_version,):
            ids = memo[1][0]
            return tuple(ids) if ids else None
        hint = getattr(req, "_affinity_memo", None)
        if hint is not None and hint[0] == ver2:
            return hint[1]
        ids = self._lookup(req)[0]
        return tuple(ids) if ids else None

    def _admit_paged(self) -> None:
        """Paged admission loop. Each request is first looked up in the
        prefix cache: a hit maps the cached blocks (refcount++) and admits
        through the tail path, computing only the uncached tail; prompts
        longer than ``prefill_chunk`` take the same path window by window.
        Up to ``tail_batch`` tail admissions ride concurrently, advanced
        together by the tail-wave. Everything else admits as a batched
        cold wave under the free-block criterion with head-of-line
        blocking. With ``prefix_affinity`` the queue is grouped so
        requests sharing a cached chain admit back-to-back. Swapped-out
        (preempted) requests restore ahead of new work (head-of-line, so
        preemption cannot starve them)."""
        if self._swapped:
            self._try_swap_in()
            if self._swapped:
                return              # restore before admitting new work
        gk = self._affinity_key if self.prefix_affinity else None
        held: set = set()
        while self.scheduler.pending > len(held):
            free = self._free_slots()
            if not free:
                return
            # chains with a tail admission in flight stay "hot": their
            # queued sharers rank ahead so the chain's LRU blocks are
            # mapped again before anything can evict them
            hot = ({j["akey"] for j in self._tail_jobs
                    if j.get("akey") is not None} if gk else ())
            head = self.scheduler.first(group_key=gk, hot=hot, skip=held)
            if head is None:
                return
            plen = len(head.prompt)
            hit_ids, cached, partial = self._lookup(head)
            if self._dedup_hold(head, cached):
                # cross-wave dedup: this head waits a wave for the
                # in-flight sharer to register; work behind it still admits
                held.add(head)
                continue
            if cached or plen > self.prefill_chunk:
                if len(self._tail_jobs) >= self.tail_batch:
                    return          # wave is full: head waits its turn
                slot = free[0]
                eff = self._paged_admit_slot(slot, head, hit_ids, partial,
                                             cached)
                if eff is None:
                    return          # pool exhausted: head waits
                self.scheduler.take(head)
                self._host["prefix_hit_tokens"] += eff
                self._tail_jobs.append({"req": head, "slot": slot,
                                        "c0": eff,
                                        "akey": tuple(hit_ids) or None})
                self._note_residency()
                continue
            taken: List[int] = []
            batch_reqs: List = []

            def ok(r):
                if len(r.prompt) > self.prefill_chunk:
                    return False        # long prompt: chunked next round
                if r is not head and self._lookup(r)[1]:
                    return False        # cached prefix: tail path next round
                bs = self.block_size
                if self.prefix_cache and len(r.prompt) - 1 >= bs and any(
                        len(q.prompt) >= bs
                        and np.array_equal(np.asarray(r.prompt[:bs]),
                                           q.prompt[:bs])
                        for q in batch_reqs):
                    # cross-wave dedup: r shares >= one full block with a
                    # request already in this forming wave; held one wave,
                    # it prefix-hits the blocks the wave registers
                    return False
                if self._paged_admit_slot(free[len(taken)], r, (),
                                          False, 0) is None:
                    return False
                taken.append(free[len(taken)])
                batch_reqs.append(r)
                return True

            reqs = self.scheduler.select(len(free), admit_ok=ok,
                                         group_key=gk, hot=hot, skip=held)
            if not reqs:
                return
            # lazy prefill allocation: just the prompt's blocks for now
            for s, r in zip(taken, reqs):
                self._ensure(s, len(r.prompt))
            self._admit_wave(reqs, taken)
            self._note_residency()

    def _lookup(self, req):
        """Prefix-cache lookup memoized per request against the allocator
        identity and index version, so re-walking the queue every step
        does not re-hash prompts while nothing changed, and a request
        resubmitted after ``reset()`` cannot replay dead block ids."""
        if not self.prefix_cache:
            return (), 0, False
        ver = (id(self), self._alloc_epoch, self.alloc.index_version)
        memo = getattr(req, "_prefix_hit", None)
        if memo is not None and memo[0] == ver:
            return memo[1]
        hit = self.alloc.lookup(req.prompt)
        req._prefix_hit = (ver, hit)
        req._affinity_memo = (ver[:2], tuple(hit[0]) or None)
        return hit

    def _dedup_hold(self, req, cached: int) -> bool:
        """Cross-wave dedup (tail path): hold ``req`` while an in-flight
        tail job shares at least one block of prompt beyond what ``req``
        prefix-hit; a wave later the job's registered blocks turn that
        overlap into a hit. Only the first ``cached + block_size`` tokens
        are compared, since that is the whole trigger condition."""
        if not self.prefix_cache or not self._tail_jobs:
            return False
        need = cached + self.block_size
        if len(req.prompt) - 1 < need:
            return False
        head = np.asarray(req.prompt[:need])
        for job in self._tail_jobs:
            jp = job["req"].prompt
            if len(jp) >= need and np.array_equal(head, jp[:need]):
                return True
        return False

    def _paged_admit_slot(self, slot: int, req, hit_ids, partial: bool,
                          cached: int) -> Optional[int]:
        """Admit one request into ``slot``: map its shared prefix blocks
        and commit capacity under the engine's admission discipline.
        ``reserve`` debits the worst-case fresh-block count up front;
        ``optimistic`` allocates only the first tail window (the whole
        prompt for a wave row) and relies on preemption for later growth.
        Returns the effective cached-token count (0 when the prefix ended
        up unused), or None, leaving no state behind, when the pool
        cannot take the request now."""
        plen = len(req.prompt)
        need = plen + req.max_new_tokens - 1
        if self.admission == "reserve":
            if not self.alloc.reserve(slot, need, shared=hit_ids,
                                      partial=partial):
                # a shared admission transiently needs more obtainable
                # blocks than an exclusive one (resurrected LRU hits + the
                # split-block COW can exceed a tiny pool); with nothing
                # resident the pool will never get freer, so fall back to
                # an unshared reservation
                idle = (not self._slot_req and not self._tail_jobs
                        and not self._swapped)
                if not (idle and hit_ids and self.alloc.reserve(slot, need)):
                    return None
                hit_ids, cached = (), 0
        else:
            self.alloc.register(slot, shared=hit_ids)
            try:
                self.alloc.ensure(slot, min(cached + self.prefill_chunk,
                                            plen))
            except PoolDry:
                self.alloc.release(slot)
                return None
        if hit_ids or self.admission == "optimistic":
            self._tbl_dirty = True
        self._admit_seq[slot] = self._seq
        self._seq += 1
        return cached

    def _admit_batch(self, tokens, lengths, slot_idx, blk_ids, eos, max_new,
                     temp, top_k, keys, greedy_only) -> None:
        """One batched prefill, then scatter of the n fresh rows into their
        slots: each layer's own cache leaves (dense rows, recurrent state)
        or prompt blocks through ``blk_ids`` (paged; sentinel entries land
        in the sink), position, and the sampling / output state. Recurrent
        archs prefill an exact-length group, without ``lengths``."""
        page = self.block_size if self._paged else 0
        batch = {"tokens": tokens}
        if self._pad_ok:
            batch["lengths"] = lengths
        logits, cache_n = prefill(self.mcfg, self.params, self.ctx, batch,
                                  cache_budget=self.cache_len,
                                  page_size=page)
        first = sample_tokens(
            logits[:, 0],
            None if greedy_only else fold_step(keys,
                                               torch.zeros_like(lengths)),
            temp, top_k, greedy_only=greedy_only)
        cache = self.state["cache"]
        for dst, src in zip(cache["layers"], cache_n["layers"]):
            for key in src:
                if page and key != "length":
                    dst[key][blk_ids] = src[key]
                else:
                    dst[key][slot_idx] = src[key]
        cache["position"][slot_idx] = cache_n["position"]
        self._post_prefill_state(first, slot_idx, eos, max_new, temp, top_k,
                                 keys)

    def _post_prefill_state(self, first, slot_idx, eos, max_new, temp,
                            top_k, keys) -> None:
        """Arm n freshly prefilled slots: first token, output row and
        sampling state."""
        st = self.state
        st["out"][slot_idx] = 0
        st["out"][slot_idx, 0] = first
        st["tokens"][slot_idx, 0] = first
        st["n_gen"][slot_idx] = 1
        st["active"][slot_idx] = (first != eos) & (max_new > 1)
        st["eos"][slot_idx] = eos
        st["max_new"][slot_idx] = max_new
        st["temp"][slot_idx] = temp
        st["top_k"][slot_idx] = top_k
        st["keys"][slot_idx] = keys

    def _request_cols(self, reqs):
        """Per-request eos / max_new / temperature / top_k / PRNG key
        columns on the device. The key is ``fold_in(PRNGKey(seed), uid)``,
        computed on the host as the reference does."""
        dev = self.device

        def col(fn, dtype):
            return torch.tensor([fn(r) for r in reqs], dtype=dtype,
                                device=dev)

        return (col(lambda r: r.eos_id, torch.int32),
                col(lambda r: r.max_new_tokens, torch.int32),
                col(lambda r: r.temperature, torch.float32),
                col(lambda r: r.top_k, torch.int32),
                torch.tensor([slot_key(r.seed, r.uid) for r in reqs],
                             dtype=torch.int64, device=dev))

    def _admit_wave(self, reqs: List[Request], taken: List[int]) -> None:
        """One batched prefill admission of ``reqs`` into slots ``taken``."""
        n = len(reqs)
        dev = self.device
        lens = np.array([len(r.prompt) for r in reqs], np.int32)
        if self._pad_ok:
            L = -(-int(lens.max()) // self.prefill_bucket) \
                * self.prefill_bucket
        else:                       # an exact-length group
            L = int(lens[0])
        toks = np.zeros((n, L), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :lens[i]] = r.prompt
        blk_ids = None
        if self._paged:
            # prefill emits ceil(L / block_size) blocks per row; rows point
            # their own allocated blocks at the pool, the rest at the sink
            nb = self.alloc.blocks_for_tokens(L)
            ids = np.full((n, nb), self.num_blocks, np.int64)
            for i, (s, r) in enumerate(zip(taken, reqs)):
                nb_i = self.alloc.blocks_for_tokens(len(r.prompt))
                ids[i, :nb_i] = self.alloc.tables[s, :nb_i]
            blk_ids = torch.from_numpy(ids).to(dev)
            self._push_tables()
        greedy_only = all(r.temperature <= 0.0 for r in reqs)
        wave_tokens = int(lens.sum())
        with self.trace.span("prefill_wave", rows=n, tokens=wave_tokens,
                        paged=self._paged) as sp:
            self._admit_batch(
                torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
                torch.tensor(taken, dtype=torch.long, device=dev), blk_ids,
                *self._request_cols(reqs), greedy_only)
            with self.trace.span("sync"):
                self._sync()
        self._host["prefill_s"] += sp.dt
        self._host["prefill_calls"] += 1
        self._host["prefill_tokens"] += n     # first token of each request
        self._host["prompt_tokens"] += wave_tokens
        self._note_rate("_pred_per_tok", sp.dt / max(wave_tokens, 1))
        self.scheduler.on_admitted(reqs)
        for s, r in zip(taken, reqs):
            # the admission wave sampled each row's first token, so TTFT
            # lands here (admission-wave granularity)
            self._observe_ttft(r)
            self.trace.event("first_token", uid=r.uid)
            self._slot_req[s] = r
            self._n_gen[s] = 1
            if self._paged:
                self._written[s] = len(r.prompt)
                # content-address the freshly written prompt blocks so
                # later requests sharing the prefix skip their prefill
                self.alloc.register_prefix(s, r.prompt, len(r.prompt))
        self._draft_prefill_rows([(s, r.prompt)
                                  for s, r in zip(taken, reqs)])

    # ------------------------------------------------------------------
    # Paged: tail-wave, block growth, copy-on-write
    # ------------------------------------------------------------------

    def _advance_tail_jobs(self) -> None:
        """Advance every in-progress tail or chunked prefill by one window,
        all jobs in one ``prefill_tail`` call (the tail-wave). ``c0``
        starts at the cached-prefix length (0 for a plain long prompt), and
        per-row ``(c0, tail_len)`` offsets let rows at different depths of
        different prompts share the wave. Rows whose final window completes
        sample their first token and arm their slots together."""
        C = self.prefill_chunk
        with self.trace.span("schedule", kind="tail"):
            ready: List[Dict] = []
            lens: List[int] = []
            for job in list(self._tail_jobs):
                slot, c0 = job["slot"], job["c0"]
                cl = min(C, len(job["req"].prompt) - c0)
                # growth or COW may swap the job itself out on a dry pool
                # (_preempt_for never picks tail jobs, so jobs of one wave
                # cannot evict each other)
                if not self._ensure(slot, c0 + cl):
                    continue
                if not self._cow_guard(slot, c0, c0 + cl):
                    continue
                ready.append(job)
                lens.append(cl)
        if not ready:
            return
        n = len(ready)
        dev = self.device
        done: List[Dict] = []
        with self.trace.span("tail_wave", rows=n,
                             tokens=int(sum(lens))) as sp:
            self._push_tables()
            toks = np.zeros((n, C), np.int32)
            hb_need = 1
            for i, (job, cl) in enumerate(zip(ready, lens)):
                c0 = job["c0"]
                toks[i, :cl] = job["req"].prompt[c0:c0 + cl]
                # table walk bounded by the tokens the deepest row can
                # touch, bucketed as in the reference
                hb_need = max(hb_need, self.alloc.blocks_for_tokens(c0 + C))
            hb = min(_pow2_ceil(hb_need), self.table_len)
            # each row's own bucket: the history a wave of its own walks
            rows_hb = [min(_pow2_ceil(self.alloc.blocks_for_tokens(
                j["c0"] + C)), self.table_len) for j in ready]
            slots_t = torch.tensor([j["slot"] for j in ready],
                                   dtype=torch.int32, device=dev)
            logits, _ = prefill_tail(
                self.mcfg, self.params, self.ctx,
                torch.from_numpy(toks).to(dev), self.state["cache"], slots_t,
                torch.tensor([j["c0"] for j in ready], dtype=torch.int32,
                             device=dev),
                torch.tensor(lens, dtype=torch.int32, device=dev),
                hist_blocks=hb, hist_rows=rows_hb)
            self._host["tail_waves"] += 1
            self._host["prefill_chunks"] += n
            self._host["prompt_tokens"] += int(sum(lens))
            rows: List[int] = []
            for i, (job, cl) in enumerate(zip(ready, lens)):
                job["c0"] += cl
                self.alloc.register_prefix(job["slot"], job["req"].prompt,
                                           job["c0"])
                if job["c0"] >= len(job["req"].prompt):
                    done.append(job)
                    rows.append(i)
            if done:
                reqs = [j["req"] for j in done]
                eos, max_new, temp, top_k, keys = self._request_cols(reqs)
                greedy_only = all(r.temperature <= 0.0 for r in reqs)
                first = sample_tokens(
                    logits[torch.tensor(rows, device=dev)],
                    None if greedy_only else fold_step(
                        keys, torch.zeros_like(eos)),
                    temp, top_k, greedy_only=greedy_only)
                self._post_prefill_state(
                    first, torch.tensor([j["slot"] for j in done],
                                        dtype=torch.long, device=dev),
                    eos, max_new, temp, top_k, keys)
            with self.trace.span("sync"):
                self._sync()
        self._host["prefill_s"] += sp.dt
        self._note_rate("_pred_per_tok", sp.dt / max(int(sum(lens)), 1))
        if not done:
            return
        self._host["prefill_calls"] += 1
        self._host["prefill_tokens"] += len(done)
        self.scheduler.on_admitted(reqs)
        for j in done:
            self._observe_ttft(j["req"])
            self.trace.event("first_token", uid=j["req"].uid)
            self._tail_jobs.remove(j)
            self._slot_req[j["slot"]] = j["req"]
            self._n_gen[j["slot"]] = 1
            self._written[j["slot"]] = len(j["req"].prompt)
        # the tail computed only the uncached suffix, but the draft has no
        # prefix cache: its rows prefill the whole prompt
        self._draft_prefill_rows([(j["slot"], j["req"].prompt)
                                  for j in done])

    def _ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow the slot's block table to cover ``n_tokens``. A dry pool
        preempts a victim, or swaps out ``slot`` itself when no other
        resident can go (optimistic admission; under reserve admission
        the blocks were debited up front and the pool never runs dry).
        Returns False iff ``slot`` was swapped out: the caller must drop
        its pending work for the slot."""
        while True:
            try:
                if self.alloc.ensure(slot, n_tokens):
                    self._tbl_dirty = True
                return True
            except PoolDry:
                if not self._preempt_for(slot):
                    self._swap_out(slot)
                    return False

    def _cow_guard(self, slot: int, start_tok: int, end_tok: int) -> bool:
        """Resolve copy-on-write for a pending write of token positions
        ``[start_tok, end_tok)``: shared blocks in the range are replaced
        by fresh blocks whose int8 payload and scales are cloned on the
        device before the write executes. A dry pool preempts as in
        :meth:`_ensure` (``cow_range`` checks its need first, so a raise
        applies nothing); returns False iff ``slot`` was swapped out."""
        while True:
            try:
                pairs = self.alloc.cow_range(slot, start_tok, end_tok)
                break
            except PoolDry:
                if not self._preempt_for(slot):
                    self._swap_out(slot)
                    return False
        if pairs:
            self._apply_cow(pairs)
        return True

    def _apply_cow(self, pairs) -> None:
        """Device-side block clones for resolved COW pairs: one copy
        launch clones the pairs in every layer of every pool leaf; the
        (src, dst) ids travel as one (2, n) int32 tensor, one host-to-device
        copy."""
        ids = torch.tensor([[p[0] for p in pairs], [p[1] for p in pairs]],
                           dtype=torch.int32, device=self.device)
        pool = self.state["cache"]["pool"]
        with self.trace.span("cow", blocks=len(pairs)):
            copy_pool_blocks_multi([pool[key] for key in POOL_KEYS], ids)
        self._host["cow_copies"] += len(pairs)
        self._tbl_dirty = True

    def _push_tables(self) -> None:
        """Push the host block-table mirror to the device iff it changed
        since the last push (block growth, COW or a harvest-time release,
        which parks freed rows on the sentinel): one non-blocking
        host-to-device copy of the whole table."""
        if self._tbl_dirty:
            host = torch.from_numpy(self.alloc.tables.astype(np.int32))
            self.state["cache"]["block_tbl"].copy_(host, non_blocking=True)
            self._tbl_dirty = False

    def _ensure_decode_blocks(self) -> None:
        """Grow resident slots' block tables to cover the coming decode
        chunk (lazy allocation at block-boundary crossings) and resolve
        copy-on-write for shared blocks in each slot's write range. Under
        optimistic admission either may preempt a victim, possibly a slot
        this loop has yet to visit."""
        for s in list(self._slot_req):
            if s not in self._slot_req:
                continue            # preempted by an earlier iteration
            r = self._slot_req[s]
            cap = len(r.prompt) + r.max_new_tokens - 1
            w = self._written[s]
            target = min(w + self.decode_block, cap)
            if not self._ensure(s, target):
                continue            # s itself was swapped out
            if s in self._slot_req:
                self._cow_guard(s, w, target)
        self._push_tables()

    # ------------------------------------------------------------------
    # Preemption: swap-out / swap-in of quantized blocks
    # ------------------------------------------------------------------

    def _preempt_for(self, slot: int) -> bool:
        """Swap out one scheduler-chosen victim to free blocks. Candidates
        are the decode residents other than ``slot`` (tail jobs are never
        in ``_slot_req``, so they are never picked and jobs of one wave
        cannot evict each other). False when no other resident can go."""
        cands = []
        for s, r in self._slot_req.items():
            if s == slot:
                continue
            remaining = (len(r.prompt) + r.max_new_tokens - 1
                         - self._written[s])
            cands.append((s, self._admit_seq.get(s, 0), remaining))
        victim = self.scheduler.pick_victim(cands, self.preempt)
        if victim is None:
            return False
        self._swap_out(victim)
        return True

    def _gather_blocks(self, ids: List[int]) -> Dict[str, torch.Tensor]:
        """Copy the listed pool blocks' int8 payload and scales, every
        layer at once, to host memory: one ``index_select`` per
        layer-stacked pool leaf into a pinned host buffer (on CUDA), all
        copies issued without blocking and joined by the caller's one
        sync. Returns {leaf: (L, len(ids), ...) host tensor}."""
        pool = self.state["cache"]["pool"]
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        pin = self.device.type == "cuda"
        out = {}
        for key in POOL_KEYS:
            blocks = pool[key].index_select(1, idx)
            host = torch.empty(blocks.shape, dtype=blocks.dtype,
                               pin_memory=pin)
            host.copy_(blocks, non_blocking=pin)
            out[key] = host
        return out

    def _scatter_blocks(self, slot: int, ids: List[int],
                        payload: Dict[str, torch.Tensor], w: int) -> None:
        """Restore a swap payload into the slot's freshly allocated pool
        blocks ``ids``, one ``index_copy_`` per layer-stacked leaf (no
        pool-sized temporary), and rebuild the slot's per-layer lengths
        and position at ``w`` written tokens."""
        cache = self.state["cache"]
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        for key in POOL_KEYS:
            cache["pool"][key].index_copy_(
                1, idx, payload[key].to(self.device, non_blocking=True))
        for layer in cache["layers"]:
            layer["length"][slot] = w
        cache["position"][slot] = w

    def _swap_out(self, slot: int) -> None:
        """Preempt ``slot``: copy its written blocks to host memory (int8
        payloads move 4x cheaper than an f32 cache would), release the
        blocks to the pool and park the request on the swap queue for a
        later restore. Works for decode residents and for in-progress
        tail jobs (which resume from their last finished window). One
        host sync per swap."""
        with self.trace.span("swap_out", slot=slot) as sp:
            job = next((j for j in self._tail_jobs if j["slot"] == slot),
                       None)
            w = job["c0"] if job is not None else self._written[slot]
            # only blocks holding written tokens travel; lazily grown
            # blocks past ``w`` hold nothing and are re-allocated on restore
            ids = self.alloc.owned(slot)[:self.alloc.blocks_for_tokens(w)]
            payload = self._gather_blocks(ids)
            nbytes = sum(t.numel() * t.element_size()
                         for t in payload.values())
            if job is not None:
                # the affinity key rides along so a restored tail job keeps
                # its chain "hot" for queued sharers
                rec = {"req": job["req"], "kind": "prefill", "w": w,
                       "akey": job.get("akey")}
                self._tail_jobs.remove(job)
                self._sync()
            else:
                req = self._slot_req.pop(slot)
                self._written.pop(slot)
                self._n_gen.pop(slot, None)
                st = self.state
                # the live sampling key travels with the record, so the
                # restore resumes the slot's PRNG state verbatim
                row = torch.cat([st["n_gen"][slot:slot + 1].long(),
                                 st["tokens"][slot].long(),
                                 st["keys"][slot],
                                 st["out"][slot].long()]).cpu()
                rec = {"req": req, "kind": "decode", "w": w,
                       "n_gen": int(row[0]), "last": int(row[1]),
                       "key": row[2:4].clone(),
                       "out": row[4:].to(torch.int32)}
                st["active"][slot] = False
                # tokens decoded before preemption stream out now (the out
                # row is already on the host); the stream resumes at the
                # next harvest after restore: same tokens, same order
                self._emit_stream(req, rec["out"][req._streamed:rec["n_gen"]],
                                  done=False)
            rec["payload"] = payload
            rec["bytes"] = nbytes
            self.alloc.release(slot)
            self._admit_seq.pop(slot, None)
            self._tbl_dirty = True
            self._swapped.append(rec)
            self._host["preemptions"] += 1
            self._host["swap_out_bytes"] += nbytes
        self._host["swap_s"] += sp.dt
        self.trace.event("preempted", uid=rec["req"].uid, kind=rec["kind"],
                         bytes=nbytes)

    def _try_swap_in(self) -> None:
        """Restore swapped-out requests while slots and blocks allow.

        Strictly FCFS over the swap queue, head-of-line: a later, smaller
        record never restores ahead of the head, which was already
        preempted once. The gate is the request's full remaining worst
        case, so a restore cannot immediately become the next victim and
        thrash the swap bandwidth."""
        free = self._free_slots()
        while self._swapped:
            rec = self._swapped[0]
            req = rec["req"]
            if rec["kind"] == "prefill" \
                    and len(self._tail_jobs) >= self.tail_batch:
                return
            if not free:
                return
            need = len(req.prompt) + req.max_new_tokens - 1
            if self.alloc.blocks_for_tokens(need) > self.alloc.free_blocks:
                return              # the head does not fit: nobody jumps it
            self._restore(free.pop(0), rec)
            self._swapped.pop(0)
            self._note_residency()

    def _restore(self, slot: int, rec: Dict) -> None:
        """Swap a preempted request back in: fresh blocks, the payload
        copied in, and the slot's sampling and output state rebuilt as it
        was, so greedy and sampled decode resume with the same tokens."""
        with self.trace.span("swap_in", slot=slot, kind=rec["kind"]) as sp:
            self._restore_body(slot, rec)
        self._host["swap_in_bytes"] += rec["bytes"]
        self._host["swap_s"] += sp.dt
        self.trace.event("swap_resumed", uid=rec["req"].uid,
                         kind=rec["kind"], bytes=rec["bytes"])

    def _restore_body(self, slot: int, rec: Dict) -> None:
        req, w = rec["req"], rec["w"]
        need = len(req.prompt) + req.max_new_tokens - 1
        if self.admission == "reserve":
            # preemption only happens under optimistic admission, but a
            # reserve-mode restore must re-debit to stay accounted
            if not self.alloc.reserve(slot, need):
                raise RuntimeError("swap-in gate admitted an unreservable "
                                   "request: accounting bug")
        else:
            self.alloc.register(slot)
        self.alloc.ensure(slot, w)
        self._tbl_dirty = True
        self._scatter_blocks(slot, self.alloc.owned(slot), rec["payload"], w)
        self._admit_seq[slot] = self._seq
        self._seq += 1
        if rec["kind"] == "prefill":
            self._tail_jobs.append({"req": req, "slot": slot, "c0": w,
                                    "akey": rec.get("akey")})
            return
        st = self.state
        dev = self.device
        st["tokens"][slot, 0] = rec["last"]
        st["out"][slot] = rec["out"].to(dev)
        st["n_gen"][slot] = rec["n_gen"]
        st["active"][slot] = True
        st["eos"][slot] = req.eos_id
        st["max_new"][slot] = req.max_new_tokens
        st["temp"][slot] = req.temperature
        st["top_k"][slot] = req.top_k
        st["keys"][slot] = rec["key"].to(dev)
        self._slot_req[slot] = req
        self._n_gen[slot] = rec["n_gen"]
        self._written[slot] = w
        # the draft cache never travels with a swap record: rebuild it from
        # the consumed stream (prompt + generated so far but the last)
        self._draft_prefill_rows([(slot, np.concatenate(
            [np.asarray(req.prompt, np.int32),
             rec["out"][:rec["n_gen"] - 1].numpy()]))])

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def _decode_chunk(self) -> None:
        """Up to ``decode_block`` decode steps over every slot, with no
        host read of the device. The chunk ends after the largest
        remaining token budget among the residents (known on the host);
        a slot that stops earlier (EOS) rides along masked, and ``steps``
        counts only steps that had an active slot, as the reference's
        ``while_loop`` does."""
        if not self._slot_req:
            return                  # every resident was just preempted
        budget = max(r.max_new_tokens - self._n_gen[s]
                     for s, r in self._slot_req.items())
        n_steps = min(self.decode_block, max(budget, 0))
        greedy_only = all(r.temperature <= 0.0
                          for r in self._slot_req.values())
        self._decode_steps(n_steps, greedy_only)

    def _decode_steps(self, n_steps: int, greedy_only: bool) -> None:
        """``n_steps`` decode steps over every slot (inactive ones ride
        along masked), with no host read of the device."""
        st = self.state
        cap = self.max_new_cap
        for _ in range(n_steps):
            logits, _ = decode_step(self.mcfg, self.params, self.ctx,
                                    st["tokens"], st["cache"])
            # this step's keys fold in the generated-token count; an
            # all-greedy chunk draws nothing and skips them
            keys = None if greedy_only else fold_step(st["keys"],
                                                      st["n_gen"])
            toks = sample_tokens(logits[:, -1], keys, st["temp"],
                                 st["top_k"], greedy_only=greedy_only)
            act = st["active"]
            # commit only active slots (explicit mask for the reference's
            # out-of-range drop)
            row = torch.clamp_max(st["n_gen"], cap - 1).long()[:, None]
            cur = torch.gather(st["out"], 1, row)[:, 0]
            st["out"].scatter_(1, row, torch.where(act, toks, cur)[:, None])
            n_gen = st["n_gen"] + act.to(torch.int32)
            st["tokens"] = torch.where(act[:, None], toks[:, None],
                                       st["tokens"])
            st["n_gen"] = n_gen
            st["active"] = act & (toks != st["eos"]) & (n_gen < st["max_new"])
            st["steps"] += act.any().to(torch.int32)
            st["committed"] += act.sum(dtype=torch.int32)

    def _harvest(self, act=None, n_gen=None) -> None:
        """The chunk's one sync: pull the per-slot (active, n_gen), then
        the finished slots' token buffers. ``act``/``n_gen`` may come
        pre-fetched (the spec step reads them for its accounting), which
        keeps one sync per step. Paged slots return their blocks to the
        pool; their decoded content is registered in the prefix index
        first, so a follow-up prompt extending prompt + completion (a chat
        turn) reuses those blocks."""
        if not self._slot_req:
            return
        with self.trace.span("harvest"):
            st = self.state
            if act is None:
                with self.trace.span("sync"):
                    act, n_gen = self._fetch_act_ngen()
            for s, r in self._slot_req.items():
                self._n_gen[s] = int(n_gen[s])
                if self._paged and act[s]:
                    # each decode step writes the KV of the token it
                    # consumes: prompt + (n_gen - 1) tokens are written
                    self._written[s] = len(r.prompt) + int(n_gen[s]) - 1
            finished = [s for s in self._slot_req if not act[s]]
            # incremental drain: streaming residents surface the tokens
            # decoded since the last harvest (decode_block / spec-wave
            # granularity); their rows ride the finished slots' one copy
            streaming = [s for s, r in self._slot_req.items()
                         if act[s] and self._streams_to(r)
                         and int(n_gen[s]) > r._streamed]
            fetch = finished + streaming
            if not fetch:
                return
            with self.trace.span("sync", rows=len(fetch)):
                all_rows = st["out"][torch.tensor(fetch, device=self.device)
                                     ].cpu().numpy()
            for i, s in enumerate(streaming):
                r = self._slot_req[s]
                self._emit_stream(r, all_rows[len(finished) + i,
                                              r._streamed:int(n_gen[s])],
                                  done=False)
            for i, s in enumerate(finished):
                req = self._slot_req.pop(s)
                self._n_gen.pop(s)
                req.generated = all_rows[i, :n_gen[s]].tolist()
                req.done = True
                self._emit_stream(req, req.generated[req._streamed:],
                                  done=True)
                self.scheduler.on_finished(req)
                tm = getattr(req, "_timing", None)
                if tm is not None and tm.admit_t is not None \
                        and tm.finish_t is not None:
                    self.metrics.observe_finished(
                        tm.latency, tm.finish_t - tm.admit_t,
                        len(req.generated))
                if self._paged:
                    self._release(s, req, int(n_gen[s]))

    def _fetch_act_ngen(self):
        """(active, n_gen) of every slot, in one device-to-host copy."""
        st = self.state
        act_ngen = torch.stack([st["active"].to(torch.int32),
                                st["n_gen"]]).cpu().numpy()
        return act_ngen[0].astype(bool), act_ngen[1]

    def _release(self, slot: int, req: Request, n_gen: int) -> None:
        """Return a finished paged slot's blocks to the pool. [0, true_w)
        is intact even for an early-EOS slot: its masked post-EOS steps
        only rewrote positions >= true_w."""
        if self.prefix_cache and req.generated:
            true_w = len(req.prompt) + n_gen - 1
            content = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.generated[:-1], np.int32)])
            self.alloc.register_prefix(slot, content, true_w)
        self.alloc.release(slot)
        self._written.pop(slot, None)
        self._admit_seq.pop(slot, None)
        self._tbl_dirty = True              # row parked on the sentinel

    # ------------------------------------------------------------------
    # Speculative decoding
    # ------------------------------------------------------------------

    def _draft_prefill_rows(self, rows) -> None:
        """Prefill the draft's dense cache rows of freshly armed decode
        residents. ``rows``: (slot, consumed tokens) pairs, the prompt at
        admission or tail completion, or prompt + generated-so-far on a
        swap-in restore (the draft cache never travels with a swap
        record: it is rebuilt from tokens, which keeps the swap bytes
        unchanged and the draft a pure performance hint)."""
        if self.spec is None or not rows:
            return
        dev = self.device
        lens = np.array([len(t) for _, t in rows], np.int32)
        L = -(-int(lens.max()) // self.prefill_bucket) * self.prefill_bucket
        toks = np.zeros((len(rows), L), np.int32)
        for i, (_, t) in enumerate(rows):
            toks[i, :len(t)] = t
        slot_idx = torch.tensor([s for s, _ in rows], dtype=torch.long,
                                device=dev)
        _, cache_n = prefill(self.draft_cfg, self.draft_params,
                             self.draft_ctx,
                             {"tokens": torch.from_numpy(toks).to(dev),
                              "lengths": torch.from_numpy(lens).to(dev)},
                             cache_budget=self._draft_cache_len)
        dcache = self._draft_cache
        for dst, src in zip(dcache["layers"], cache_n["layers"]):
            for key in src:
                dst[key][slot_idx] = src[key]
        dcache["position"][slot_idx] = cache_n["position"]
        self._host["spec_draft_prefill_tokens"] += int(lens.sum())

    def _spec_draft(self, greedy_only: bool):
        """Draft ``k`` proposals per slot: ``k + 1`` decode steps of the
        draft on its dense cache.

        The draft cache's counters are first re-clamped to the target's
        committed extent (the draft-side rollback of what the last wave
        over-drafted). Step j consumes the previous proposal (step 0 the
        slot's last committed token) and samples proposal j + 1 with the
        plain-decode key ``fold_in(key, n_gen + j)``, so a self-draft
        proposes exactly plain decode's tokens. The last step only
        commits its input's KV, so the draft cache ends the wave covering
        every token the target may accept. Under ``rejection`` mode the
        draft's distributions ride along. Returns (dtoks (S, k), dq
        (S, k, V) or None)."""
        st = self.state
        k = self.spec.k
        dcache = self._draft_cache
        _clamp_lengths(dcache, st["cache"]["position"])
        want_q = self.spec.accept_mode == "rejection" and not greedy_only
        tok = st["tokens"]
        dtoks, dqs = [], []
        for j in range(k + 1):
            logits, _ = decode_step(self.draft_cfg, self.draft_params,
                                    self.draft_ctx, tok, dcache)
            if j == k:
                break               # the final step only commits its KV
            keys = None if greedy_only else fold_step(st["keys"],
                                                      st["n_gen"] + j)
            nxt = sample_tokens(logits[:, -1], keys, st["temp"],
                                st["top_k"], greedy_only=greedy_only)
            dtoks.append(nxt)
            if want_q:
                dqs.append(token_probs(logits[:, -1], st["temp"],
                                       st["top_k"]))
            tok = nxt[:, None]
        return (torch.stack(dtoks, dim=1),
                torch.stack(dqs, dim=1) if want_q else None)

    def _spec_wave(self, dtoks, dq, tail_len: torch.Tensor,
                   hist_blocks: int, greedy_only: bool) -> None:
        """Verify every resident's drafted window in one verify-wave and
        commit the accepted prefix.

        The window ``[last_token, draft_1..draft_k]`` goes through
        ``models.spec_verify`` (decode's numerics), the target's own
        samples are drawn with the plain-decode key stream, and acceptance
        picks how many tokens commit: the leading draft matches plus one
        target token (the correction at the first mismatch, or the bonus
        when every draft survives), cut at the first committed EOS and at
        the row's remaining ``max_new`` budget. The rejected positions
        roll back here on the device (every layer's ``length`` and
        ``position`` re-clamp to the accepted extent, so the stale KV past
        it is never read); the host releases their whole blocks right
        after (``BlockAllocator.trim``)."""
        st = self.state
        S, C = self.slots, self.spec.k + 1
        dev = self.device
        cap = self.max_new_cap
        cache = st["cache"]
        c0 = cache["position"].clone()
        window = torch.cat([st["tokens"], dtoks.to(torch.int32)], dim=1)
        logits, _ = spec_verify(self.mcfg, self.params, self.ctx, window,
                                cache, torch.arange(S, dtype=torch.int32,
                                                    device=dev),
                                c0, tail_len, hist_blocks=hist_blocks)
        n_gen, act = st["n_gen"], st["active"]
        # one flattened (S * C)-row sampling call: per row exactly what C
        # sequential decode steps would run
        V = logits.shape[-1]
        flat = logits.reshape(S * C, V)
        jc = torch.arange(C, device=dev)
        temp_rep = st["temp"].repeat_interleave(C)
        topk_rep = st["top_k"].repeat_interleave(C)
        keys = None
        if not greedy_only:
            keys = fold_step(st["keys"].repeat_interleave(C, dim=0),
                             (n_gen[:, None] + jc[None]).reshape(S * C))
        tt = sample_tokens(flat, keys, temp_rep, topk_rep,
                           greedy_only=greedy_only).reshape(S, C)
        n_draft = torch.clamp_min(tail_len - 1, 0)
        if self.spec.accept_mode == "rejection" and not greedy_only:
            p = token_probs(flat, temp_rep, topk_rep).reshape(S, C, V)
            n_acc, committed = accept_rejection(dtoks, dq, p, tt, st["keys"],
                                                n_gen, n_draft)
        else:
            n_acc, committed = accept_exact(dtoks, tt, n_draft), tt
        m = n_acc + 1
        is_eos = committed == st["eos"][:, None]
        first_eos = torch.argmax(is_eos.to(torch.int32), dim=1) + 1
        m = torch.where(is_eos.any(dim=1), torch.minimum(m, first_eos), m)
        m = torch.where(act, torch.minimum(m, torch.clamp_min(tail_len, 1)),
                        torch.zeros_like(m)).to(torch.int32)
        # commit out[s, n_gen + j] = committed[s, j] for j < m (a masked
        # write over the whole row stands in for the reference's dropping
        # scatter)
        rel = torch.arange(cap, device=dev)[None] - n_gen[:, None].long()
        keep = (rel >= 0) & (rel < m[:, None])
        vals = torch.gather(committed, 1, torch.clamp(rel, 0, C - 1))
        st["out"] = torch.where(keep, vals, st["out"])
        n_gen2 = n_gen + m
        lastj = torch.clamp_min(m.long() - 1, 0)[:, None]
        last = torch.gather(committed, 1, lastj)[:, 0]
        hit_eos = torch.gather(is_eos, 1, lastj)[:, 0]
        st["tokens"] = torch.where(act[:, None], last[:, None], st["tokens"])
        st["n_gen"] = n_gen2
        st["active"] = act & ~hit_eos & (n_gen2 < st["max_new"])
        st["steps"] += 1
        st["committed"] += m.sum(dtype=torch.int32)
        _clamp_lengths(cache, (c0 + m).to(torch.int32))

    def _spec_step(self) -> None:
        """One speculative wave over every decode resident: the draft
        proposes ``k`` tokens per slot, the target verifies all windows in
        one verify-wave, the accepted prefix plus one target token commit,
        and the rejected suffix rolls back (the wave re-clamps the device
        counters; this driver releases the whole blocks past each
        survivor's accepted extent with ``BlockAllocator.trim``). Capacity
        and COW for the whole window are secured first, as for a decode
        chunk, so preemption and prefix-shared blocks compose with the
        wave unchanged."""
        C = self.spec.k + 1
        tail = np.zeros((self.slots,), np.int32)
        hb_need = 1
        with self.trace.span("schedule", kind="spec"):
            for s in list(self._slot_req):
                if s not in self._slot_req:
                    continue        # preempted by an earlier iteration
                r = self._slot_req[s]
                w = self._written[s]
                # the window is clamped to the row's remaining budget, so
                # occupancy never exceeds the admission-time worst case
                t = min(C, len(r.prompt) + r.max_new_tokens - 1 - w)
                if not self._ensure(s, w + t):
                    continue        # s itself was swapped out
                if s not in self._slot_req \
                        or not self._cow_guard(s, w, w + t):
                    continue
                tail[s] = t
                hb_need = max(hb_need, self.alloc.blocks_for_tokens(w + t))
            for s in range(self.slots):
                # a slot secured and then swapped out by a later
                # iteration's preemption rides the wave fully masked (its
                # table row is already parked on the sentinel)
                if tail[s] and s not in self._slot_req:
                    tail[s] = 0
        if not self._slot_req:
            return
        if not tail.any():
            # no slot has budget to draft: every resident finished at
            # admission (max_new == 1); they still need harvesting
            self._harvest()
            return
        self._push_tables()
        greedy_only = all(r.temperature <= 0.0
                          for r in self._slot_req.values())
        n_gen_before = {s: self._written[s] - len(r.prompt) + 1
                        for s, r in self._slot_req.items()}
        with self.trace.span("spec_draft", rows=len(self._slot_req)):
            dtoks, dq = self._spec_draft(greedy_only)
        with self.trace.span("spec_verify"):
            hb = min(_pow2_ceil(hb_need), self.table_len)
            self._spec_wave(dtoks, dq,
                            torch.from_numpy(tail).to(self.device), hb,
                            greedy_only)
            # one host sync per wave, as for a decode chunk: the
            # harvest's (active, n_gen) also gives each committed count
            with self.trace.span("sync"):
                act, n_gen = self._fetch_act_ngen()
        drafted = accepted = 0
        for s, n0 in n_gen_before.items():
            m_s = int(n_gen[s]) - n0
            if m_s > 0:
                # rows committing nothing were inactive the whole wave
                # (finished at admission): their proposals never counted
                drafted += max(int(tail[s]) - 1, 0)
                accepted += m_s - 1
        self._host["spec_waves"] += 1
        self._host["spec_drafted"] += drafted
        self._host["spec_accepted"] += accepted
        self._host["spec_rolled_back"] += drafted - accepted
        self._harvest(act, n_gen)
        # host-side rollback: finished slots were released by the harvest;
        # survivors drop the whole blocks past their accepted extent
        # (grown for this wave, so never shared or indexed)
        for s in list(self._slot_req):
            if self.alloc.trim(s, self._written[s]):
                self._tbl_dirty = True

    # ------------------------------------------------------------------
    # Drive
    # ------------------------------------------------------------------

    def step(self) -> None:
        """One admission + one tail-wave window of the in-progress tail or
        chunked admissions + one decode round (a draft + verify wave with
        spec on, else one decode chunk) + harvest. On a mesh it starts
        with rank 0's host-step broadcast (:meth:`_sync_host`)."""
        if self._sync_host(_STEP) != _STEP:
            raise RuntimeError("mesh ranks out of step: this rank stepped "
                               "while rank 0 reset or stopped")
        self._step_body()

    def _step_body(self) -> None:
        self._step_idx += 1
        self.trace.step = self._step_idx
        with self.trace.span("step"):
            with self.trace.span("admit"):
                self._admit()
            if self._tail_jobs:
                self._advance_tail_jobs()
            if self._slot_req:
                with self.trace.span("decode") as sp:
                    if self.spec is not None:
                        self._spec_step()   # draft, verify, harvest, trim
                    else:
                        if self._paged:
                            with self.trace.span("schedule", kind="decode"):
                                self._ensure_decode_blocks()
                        with self.trace.span("decode_chunk",
                                             rows=len(self._slot_req)):
                            self._decode_chunk()
                        # the harvest's device read doubles as the sync
                        self._harvest()
                self._host["decode_s"] += sp.dt
                self._host["decode_rounds"] += 1
                self._note_rate("_pred_round_s", sp.dt)

    def _has_work(self) -> bool:
        """Requests queued (on a mesh, also those not yet broadcast),
        resident, mid-prefill or swapped out."""
        return bool(self._outbox or self.scheduler.pending
                    or self._slot_req or self._tail_jobs or self._swapped)

    def _flush_partial(self) -> None:
        """Surface still-resident slots' tokens (budget-aborted drain);
        swapped-out requests surface the tokens taken at preemption."""
        for rec in self._swapped:
            if rec["kind"] == "decode":
                rec["req"].generated = rec["out"][:rec["n_gen"]].tolist()
        if not self._slot_req:
            return
        resident = sorted(self._slot_req)
        n_gen = self.state["n_gen"].cpu().numpy()
        rows = self.state["out"][torch.tensor(resident, device=self.device)
                                 ].cpu().numpy()
        for i, s in enumerate(resident):
            self._slot_req[s].generated = rows[i, :n_gen[s]].tolist()

    def run_until_drained(self, max_steps: int = 10_000) -> Dict:
        """Serve until queue, slots, tail jobs and the swap queue are
        empty; ``max_steps`` bounds the total decode-step budget
        (chunk-granular). If the budget aborts the drain, in-flight
        requests keep their partial ``generated`` output (``done`` stays
        False). On rank 0 of a mesh it ends with :meth:`stop_followers`;
        the other ranks :meth:`follow` it."""
        chunks = 0
        while self._has_work() and chunks * self.decode_block < max_steps:
            self.step()
            chunks += 1
        self._flush_partial()
        self.stop_followers()
        return self.stats()

    # ------------------------------------------------------------------
    # decode_block auto-tuning
    # ------------------------------------------------------------------

    def _probe_arm(self) -> None:
        """Arm every slot of the engine's own state for a full decode chunk
        from an empty cache, in place: the probe allocates no second
        cache. (A paged table is all sentinel, so its writes land in the
        sink block.)"""
        st = self.state
        S, dev = self.slots, self.device
        for layer in st["cache"]["layers"]:
            if "length" in layer:           # attention layers
                layer["length"].zero_()
        st["cache"]["position"].zero_()
        st["tokens"] = torch.zeros((S, 1), dtype=torch.int32, device=dev)
        st["n_gen"] = torch.zeros((S,), dtype=torch.int32, device=dev)
        st["active"] = torch.ones((S,), dtype=torch.bool, device=dev)
        st["max_new"] = torch.full((S,), self.max_new_cap,
                                   dtype=torch.int32, device=dev)

    def _probe_decode_block(self) -> Dict:
        """Measured decode-chunk probe (``decode_block="auto"``): one
        greedy chunk of 1 and of 8 steps over every slot, each followed by
        the harvest's read of (active, n_gen), timed between device syncs
        as the min of 3 after one untimed call; :func:`pick_decode_block`
        turns the two times into the chunk length. Runs on the engine's
        own state, which is reset afterwards. Returns {"pick", "t1_s",
        "t8_s", "per_step_s", "overhead_s"}."""
        def chunk_time(c: int) -> float:
            best = float("inf")
            for i in range(4):            # one warm-up, then min of 3
                self._probe_arm()
                self._sync()
                t0 = time.perf_counter()
                self._decode_steps(c, True)
                self._fetch_act_ngen()
                self._sync()
                if i:
                    best = min(best, time.perf_counter() - t0)
            return best

        t1, t8 = chunk_time(1), chunk_time(8)
        if self._comm is not None:
            # rank 0's times, so every rank picks the same chunk length
            t1, t8 = self._comm.broadcast_floats([t1, t8])
        self.reset()
        per_step = max((t8 - t1) / 7.0, 1e-9)
        return {"pick": pick_decode_block(t1, t8), "t1_s": t1, "t8_s": t8,
                "per_step_s": per_step,
                "overhead_s": max(t1 - per_step, 0.0)}

    # ------------------------------------------------------------------
    # Stats
    # ------------------------------------------------------------------

    def _served_weight_leaves(self) -> List[torch.Tensor]:
        """The weight tensors this rank's serve forward streams: under
        w4a8 the packed export planes, under bf16 the whole tree."""
        return [t for p, t in flatten(self.params)
                if isinstance(t, torch.Tensor) and (
                    self.weights_layout != "w4a8"
                    or "w4a8" in p.split("/"))]

    def stats(self) -> Dict:
        """Serving counters and latency stats (one host sync).

        ==========================  =========================================
        key                         meaning
        ==========================  =========================================
        tokens_out                  tokens returned to requests (first
                                    prefill token + committed decode tokens)
        decode_steps                device decode steps with an active slot
        decode_s / decode_step_s    wall seconds in decode / per device step
        decode_rounds               engine steps that ran a decode chunk
        prefill_calls               batched prefill admissions and tail
                                    waves that finished a prompt
        prefill_chunks              tail-wave rows advanced (windows)
        tail_waves                  tail-wave calls
        prompt_tokens_prefilled     prompt tokens computed (prefix-cache
                                    hits excluded)
        prefill_s                   wall seconds in prefill + tail waves
        prefix_hit_tokens           prompt tokens served from the prefix
                                    cache instead of being prefilled
        cow_copies                  copy-on-write block clones
        preemptions                 swap-outs (optimistic admission)
        swap_out_bytes/_in_bytes    quantized bytes moved by swaps
        swap_s                      wall seconds in swap copy/restore
        max_residents               peak concurrently resident requests
                                    (decode + in-flight tail prefills)
        pending_requests            requests waiting in the scheduler queue
        resident_requests           requests resident in slots
        swapped_requests            preempted requests awaiting restore
        cache_tokens_capacity       stripe / pool capacity in tokens
        peak_cache_tokens/_bytes    peak occupancy in tokens / bytes
        cache_bytes                 total cache allocation (this rank's)
        mesh_shape                  the mesh's axis sizes (None off a mesh)
        tp_degree                   ranks on the "model" axis (1 off it)
        per_device_pool_bytes       this rank's cache (pool) bytes
        per_device_state_bytes      of which recurrent layers' state
                                    (their slice or whole: sharding)
        per_device_weight_bytes     this rank's served weight bytes (the
                                    packed planes under w4a8)
        per_device_bank_bytes       this rank's MoE expert banks' bytes
                                    (bf16 weights and scales, never
                                    packed; 0 without experts)
        decode_block(_mode)         chunk length and how it was chosen
                                    ("fixed" / "auto" / "spec")
        weights_layout              serve weight layout ("bf16" / "w4a8")
        packed_weight_bytes         int4-packed weight + scale + bias bytes
                                    the w4a8 forward streams (0 under bf16)
        weight_hbm_saved_bytes      bf16 weight bytes per forward the packed
                                    layout no longer reads (0 under bf16)
        device                      the device the engine serves on
        paged                       True under kv_layout="paged"
        free_blocks                 free blocks of the pool (paged)
        pool_occupancy              fraction of pool blocks in use (paged)
        prefix_lookups/_hit_blocks  prefix-index probes / whole blocks hit
        prefix_cache_blocks         evictable blocks alive only in the index
        prefix_evictions            indexed blocks reclaimed by allocation
        spec_waves/_drafted/        verify-waves run, draft tokens proposed
        _accepted/_rolled_back      / accepted / rolled back (spec only)
        spec_draft_prefill_tokens   tokens prefilled into the draft cache
        spec_accept_rate            accepted / drafted (spec only)
        spec_k/_draft_layers/       the SpecConfig serving (spec only)
        _accept_mode
        requests_finished           requests fully served
        requests_shed               requests rejected by SLO shed-load
        requests_downgraded         requests demoted to best-effort by it
        ttft_p50_s/p95_s            submit -> first-token percentiles
        latency_p50_s/p95_s         submit -> finish percentiles
        ==========================  =========================================

        The pool-only keys (``free_blocks`` … ``prefix_evictions``) appear
        only with ``kv_layout="paged"``, the spec keys only with ``spec``.
        Every value is a native Python scalar or container: the dict
        round-trips through ``json.dumps`` unchanged, which is what the
        ``/v1/stats`` and ``/v1/metrics`` HTTP surfaces serve.
        """
        counts = torch.stack([self.state["steps"], self.state["committed"]]
                             ).cpu().tolist()
        steps, committed = int(counts[0]), int(counts[1])
        d = dict(self._host)
        prefill_tokens = d.pop("prefill_tokens")
        d["prompt_tokens_prefilled"] = d.pop("prompt_tokens")
        d["decode_steps"] = steps
        d["tokens_out"] = committed + prefill_tokens
        d["decode_step_s"] = d["decode_s"] / max(steps, 1)
        d["max_residents"] = self._max_residents
        d["decode_block"] = self.decode_block
        d["decode_block_mode"] = self._decode_block_mode
        d["mesh_shape"] = (dict(self.mesh.shape)
                           if self.mesh is not None else None)
        d["tp_degree"] = self.tp
        d["per_device_pool_bytes"] = self._cache_bytes
        d["per_device_state_bytes"] = self._state_bytes
        d["per_device_weight_bytes"] = sum(
            t.numel() * t.element_size()
            for t in self._served_weight_leaves())
        d["per_device_bank_bytes"] = sum(
            t.numel() * t.element_size() for p, t in flatten(self.params)
            if isinstance(t, torch.Tensor) and bank_leaf(p))
        d["weights_layout"] = self.weights_layout
        d["packed_weight_bytes"] = self._w4a8_bytes["packed"]
        d["weight_hbm_saved_bytes"] = max(
            self._w4a8_bytes["replaced"] - self._w4a8_bytes["packed"], 0)
        d["device"] = str(self.device)
        d["pending_requests"] = self.scheduler.pending
        d["resident_requests"] = len(self._slot_req) + len(self._tail_jobs)
        d["swapped_requests"] = len(self._swapped)
        if self.spec is not None:
            drafted = d["spec_drafted"]
            d["spec_accept_rate"] = (d["spec_accepted"] / drafted
                                     if drafted else 0.0)
            d["spec_k"] = self.spec.k
            d["spec_draft_layers"] = self.spec.resolved_layers(self.cfg)
            d["spec_accept_mode"] = self.spec.accept_mode
        d["paged"] = self._paged
        if self._paged:
            d["prefix_lookups"] = self.alloc.prefix_lookups
            d["prefix_hit_blocks"] = self.alloc.prefix_hit_blocks
            d["prefix_cache_blocks"] = self.alloc.cached_blocks
            d["prefix_evictions"] = self.alloc.prefix_evictions
            d["free_blocks"] = self.alloc.free_blocks
            d["pool_occupancy"] = (1.0 - self.alloc.free_blocks
                                   / max(self.num_blocks, 1))
            cap_tokens = self.num_blocks * self.block_size
            d["peak_cache_tokens"] = self.alloc.peak_blocks * self.block_size
        else:
            cap_tokens = self.slots * self.cache_len
            # a dense stripe is reserved whole for a slot's lifetime
            d["peak_cache_tokens"] = self._max_residents * self.cache_len
        d["cache_tokens_capacity"] = cap_tokens
        d["cache_bytes"] = self._cache_bytes
        d["peak_cache_bytes"] = int(
            self._cache_bytes * d["peak_cache_tokens"] / max(cap_tokens, 1))
        d.update(self.scheduler.stats())
        return _jsonable(d)
