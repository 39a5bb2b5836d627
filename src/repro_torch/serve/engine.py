"""Continuous-batching serve engine over the quantized dense KV cache.

Slot engine in the reference's shape, with the host touching the device
only at admission and harvest:

* **Batched prefill** — the scheduler hands over up to ``slots`` queued
  requests at once; they are right-padded to a length bucket and prefilled
  in one call (per-row ``lengths`` keep the cache and logits exact; see
  ``models.prefill``), and each row's first token is sampled there.
* **Decode chunks** — sampling (greedy / temperature / top-k), per-slot
  EOS + max-token tracking and the generated-token buffers live in device
  tensors; a chunk runs up to ``decode_block`` decode steps. The host
  never reads the device inside a chunk: it bounds the chunk by the
  largest remaining token budget it knows from the last harvest, and
  slots that stop early (EOS) ride along masked. The host syncs once per
  chunk, at harvest, to retire finished slots.
* **Kernels** — under ``weights_layout="w4a8"`` every linear runs the
  packed-int4 x int8 matmul, and decode attention runs the int8-cache
  flash-decode kernel; on CUDA tensors both are the hand-written kernels
  of ``repro_torch/csrc``, on CPU tensors their plain versions.

Only the dense cache layout is ported. The paged pool, prefix sharing,
speculative decoding, SLO shedding, the ``decode_block="auto"`` probe
and mesh serving arrive with later slices; their arguments raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import parse_policy
from repro_torch.core.qat import (attach_w4a8_exports, make_ctx,
                                  w4a8_weight_bytes)
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serve.sampling import TOP_K_CAP, sample_tokens, step_seed
from repro_torch.serve.scheduler import Scheduler

_CACHE_KEYS = ("k_q", "v_q", "s_k", "s_v", "length")


@dataclass(eq=False)                    # identity equality: the ndarray
class Request:                          # prompt field breaks value __eq__
    uid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                    # -1: never stops early
    temperature: float = 0.0            # <= 0: greedy
    top_k: int = 0                      # 0: no top-k filtering
    seed: int = 0
    generated: List[int] = field(default_factory=list)
    done: bool = False
    _arrival: int = 0                   # set by the scheduler


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
                 kv_layout: str = "dense",
                 slo_shed: str = "none",
                 spec=None,
                 mesh=None,
                 weights_layout: str = "bf16",
                 trace: Optional[Tracer] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if kv_layout == "paged":
            raise NotImplementedError("kv_layout='paged' is not ported yet")
        if kv_layout != "dense":
            raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                             f"got {kv_layout!r}")
        if spec is not None:
            raise NotImplementedError("speculative decoding is not ported "
                                      "yet")
        if mesh is not None:
            raise NotImplementedError("mesh (tensor-parallel) serving is not "
                                      "ported yet")
        if slo_shed != "none":
            raise NotImplementedError("SLO shedding is not ported yet")
        if decode_block == "auto":
            raise NotImplementedError("the decode_block='auto' probe is not "
                                      "ported yet; pass an int")
        if weights_layout not in ("bf16", "w4a8"):
            raise ValueError(f"weights_layout must be 'bf16' or 'w4a8', "
                             f"got {weights_layout!r}")
        self.device = resolve_device(device)
        if not _same_device(params["embed"]["w"].device, self.device):
            raise ValueError(
                f"params live on {params['embed']['w'].device} but the "
                f"engine serves on {self.device}; build them there "
                f"(init_params(..., device=...))")
        self.cfg = cfg
        self.trace = trace if trace is not None else NULL_TRACER
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
        self.ctx = make_ctx(policy, weights_layout=weights_layout)
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.max_new_cap = max_new_cap
        self.prefill_bucket = prefill_bucket
        self.decode_block = int(decode_block)
        self._sched_policy = sched_policy
        self.scheduler = Scheduler(sched_policy, trace=self.trace)
        self.reset()

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def _blank_state(self) -> Dict:
        slots, dev = self.slots, self.device
        i32 = {"dtype": torch.int32, "device": dev}
        return {
            "cache": init_cache(self.cfg, self.ctx, slots, self.cache_len,
                                device=dev),
            "tokens": torch.zeros((slots, 1), **i32),
            "out": torch.zeros((slots, self.max_new_cap), **i32),
            "n_gen": torch.zeros((slots,), **i32),
            "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
            "eos": torch.full((slots,), -1, **i32),
            "max_new": torch.ones((slots,), **i32),
            "temp": torch.zeros((slots,), dtype=torch.float32, device=dev),
            "top_k": torch.zeros((slots,), **i32),
            "steps": torch.zeros((), **i32),
            "committed": torch.zeros((), **i32),
        }

    def reset(self) -> None:
        """Clear all serving state: queued and resident requests, the
        cache, the scheduler and every stat."""
        self.state = self._blank_state()
        self._slot_req: Dict[int, Request] = {}
        self._n_gen: Dict[int, int] = {}     # host mirror, as of harvest
        self._max_residents = 0
        self.scheduler = Scheduler(self._sched_policy, trace=self.trace)
        self.trace.clear()
        self._step_idx = 0
        self._host = {"decode_s": 0.0, "decode_rounds": 0,
                      "prefill_s": 0.0, "prefill_calls": 0,
                      "prefill_tokens": 0, "prompt_tokens": 0}
        self._cache_bytes = sum(
            t.numel() * t.element_size()
            for layer in self.state["cache"]["layers"] for t in layer.values())

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, req: Request) -> None:
        """Enqueue one request for serving.

        ``prompt`` is a 1-D array of token ids in the vocabulary;
        ``max_new_tokens`` bounds generation (the first token comes from
        prefill); ``temperature <= 0`` means greedy and ``top_k == 0``
        disables filtering. The request is admitted on a later
        :meth:`step`; ``req.done`` and ``req.generated`` carry the result.

        Raises ValueError if the request can never be admitted on this
        engine: ``max_new_tokens`` above ``max_new_cap``, ``top_k`` above
        ``TOP_K_CAP``, a token outside the vocabulary, or a footprint
        (``prompt + max_new_tokens - 1``) above ``cache_len``.
        """
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
        if need > self.cache_len:
            raise ValueError(
                f"request needs {need} cache tokens (prompt "
                f"{len(prompt)} + max_new_tokens {req.max_new_tokens} "
                f"- 1) but cache_len={self.cache_len}; raise cache_len or "
                f"shorten the request")
        self.scheduler.submit(req)

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.slots) if s not in self._slot_req]

    def _admit(self) -> None:
        free = self._free_slots()
        if not free or not self.scheduler.pending:
            return
        reqs = self.scheduler.select(len(free))
        if not reqs:
            return
        self._admit_wave(reqs, free[:len(reqs)])
        self._max_residents = max(self._max_residents, len(self._slot_req))

    def _admit_batch(self, tokens, lengths, slot_idx, eos, max_new, temp,
                     top_k, seeds, greedy_only) -> None:
        """One batched prefill, then scatter of the n fresh rows into
        their slots: cache rows, position and sampling/output state."""
        logits, cache_n = prefill(self.cfg, self.params, self.ctx,
                                  {"tokens": tokens, "lengths": lengths},
                                  cache_budget=self.cache_len)
        first = sample_tokens(logits[:, 0], temp, top_k, seeds,
                              greedy_only=greedy_only)
        st = self.state
        cache = st["cache"]
        for dst, src in zip(cache["layers"], cache_n["layers"]):
            for key in _CACHE_KEYS:
                dst[key][slot_idx] = src[key]
        cache["position"][slot_idx] = cache_n["position"]
        st["out"][slot_idx] = 0
        st["out"][slot_idx, 0] = first
        st["tokens"][slot_idx, 0] = first
        st["n_gen"][slot_idx] = 1
        st["active"][slot_idx] = (first != eos) & (max_new > 1)
        st["eos"][slot_idx] = eos
        st["max_new"][slot_idx] = max_new
        st["temp"][slot_idx] = temp
        st["top_k"][slot_idx] = top_k

    def _admit_wave(self, reqs: List[Request], taken: List[int]) -> None:
        """One batched prefill admission of ``reqs`` into slots ``taken``."""
        n = len(reqs)
        dev = self.device
        lens = np.array([len(r.prompt) for r in reqs], np.int32)
        L = -(-int(lens.max()) // self.prefill_bucket) * self.prefill_bucket
        toks = np.zeros((n, L), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :lens[i]] = r.prompt

        def col(fn, dtype):
            return torch.tensor([fn(r) for r in reqs], dtype=dtype,
                                device=dev)

        greedy_only = all(r.temperature <= 0.0 for r in reqs)
        seeds = [step_seed(r.seed, r.uid, 0) if r.temperature > 0 else None
                 for r in reqs]
        wave_tokens = int(lens.sum())
        with self.trace.span("prefill_wave", rows=n,
                             tokens=wave_tokens) as sp:
            self._admit_batch(
                torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
                torch.tensor(taken, dtype=torch.long, device=dev),
                col(lambda r: r.eos_id, torch.int32),
                col(lambda r: r.max_new_tokens, torch.int32),
                col(lambda r: r.temperature, torch.float32),
                col(lambda r: r.top_k, torch.int32), seeds, greedy_only)
            with self.trace.span("sync"):
                self._sync()
        self._host["prefill_s"] += sp.dt
        self._host["prefill_calls"] += 1
        self._host["prefill_tokens"] += n     # first token of each request
        self._host["prompt_tokens"] += wave_tokens
        self.scheduler.on_admitted(reqs)
        for s, r in zip(taken, reqs):
            self.trace.event("first_token", uid=r.uid)
            self._slot_req[s] = r
            self._n_gen[s] = 1

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
        budget = max(r.max_new_tokens - self._n_gen[s]
                     for s, r in self._slot_req.items())
        n_steps = min(self.decode_block, max(budget, 0))
        sampled = {s: r for s, r in self._slot_req.items()
                   if r.temperature > 0.0}
        st = self.state
        cap = self.max_new_cap
        for i in range(n_steps):
            logits, _ = decode_step(self.cfg, self.params, self.ctx,
                                    st["tokens"], st["cache"])
            seeds = None
            if sampled:
                seeds = [step_seed(sampled[s].seed, sampled[s].uid,
                                   self._n_gen[s] + i)
                         if s in sampled else None
                         for s in range(self.slots)]
            toks = sample_tokens(logits[:, -1], st["temp"], st["top_k"],
                                 seeds, greedy_only=not sampled)
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

    def _harvest(self) -> None:
        """The chunk's one sync: pull the per-slot (active, n_gen), then
        the finished slots' token buffers."""
        if not self._slot_req:
            return
        with self.trace.span("harvest"):
            st = self.state
            with self.trace.span("sync"):
                act_ngen = torch.stack([st["active"].to(torch.int32),
                                        st["n_gen"]]).cpu().numpy()
            act, n_gen = act_ngen[0].astype(bool), act_ngen[1]
            for s in self._slot_req:
                self._n_gen[s] = int(n_gen[s])
            finished = [s for s in self._slot_req if not act[s]]
            if not finished:
                return
            with self.trace.span("sync", rows=len(finished)):
                rows = st["out"][torch.tensor(finished, device=self.device)
                                 ].cpu().numpy()
            for i, s in enumerate(finished):
                req = self._slot_req.pop(s)
                self._n_gen.pop(s)
                req.generated = rows[i, :n_gen[s]].tolist()
                req.done = True
                self.scheduler.on_finished(req)

    # ------------------------------------------------------------------
    # Drive
    # ------------------------------------------------------------------

    def step(self) -> None:
        """One admission + one decode chunk + harvest."""
        self._step_idx += 1
        self.trace.step = self._step_idx
        with self.trace.span("step"):
            with self.trace.span("admit"):
                self._admit()
            if self._slot_req:
                with self.trace.span("decode") as sp:
                    with self.trace.span("decode_chunk",
                                         rows=len(self._slot_req)):
                        self._decode_chunk()
                    # the harvest's device read doubles as the sync
                    self._harvest()
                self._host["decode_s"] += sp.dt
                self._host["decode_rounds"] += 1

    def _flush_partial(self) -> None:
        """Surface still-resident slots' tokens (budget-aborted drain)."""
        if not self._slot_req:
            return
        resident = sorted(self._slot_req)
        n_gen = self.state["n_gen"].cpu().numpy()
        rows = self.state["out"][torch.tensor(resident, device=self.device)
                                 ].cpu().numpy()
        for i, s in enumerate(resident):
            self._slot_req[s].generated = rows[i, :n_gen[s]].tolist()

    def run_until_drained(self, max_steps: int = 10_000) -> Dict:
        """Serve until queue + slots are empty; ``max_steps`` bounds the
        total decode-step budget (chunk-granular). If the budget aborts the
        drain, in-flight requests keep their partial ``generated`` output
        (``done`` stays False)."""
        chunks = 0
        while ((self.scheduler.pending or self._slot_req)
               and chunks * self.decode_block < max_steps):
            self.step()
            chunks += 1
        self._flush_partial()
        return self.stats()

    # ------------------------------------------------------------------
    # Stats
    # ------------------------------------------------------------------

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
        prefill_calls               batched prefill admissions
        prompt_tokens_prefilled     prompt tokens computed
        prefill_s                   wall seconds in prefill
        max_residents               peak concurrently resident requests
        pending_requests            requests waiting in the scheduler queue
        resident_requests           requests resident in slots
        cache_tokens_capacity       slots * cache_len
        peak_cache_tokens/_bytes    peak occupancy in tokens / bytes
        cache_bytes                 total cache allocation
        decode_block(_mode)         chunk length and how it was chosen
        weights_layout              serve weight layout ("bf16" / "w4a8")
        packed_weight_bytes         int4-packed weight + scale + bias bytes
                                    the w4a8 forward streams (0 under bf16)
        weight_hbm_saved_bytes      bf16 weight bytes per forward the packed
                                    layout no longer reads (0 under bf16)
        device                      the device the engine serves on
        requests_finished           requests fully served
        ttft_p50_s/p95_s            submit -> first-token percentiles
        latency_p50_s/p95_s         submit -> finish percentiles
        ==========================  =========================================
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
        d["decode_block_mode"] = "fixed"
        d["weights_layout"] = self.weights_layout
        d["packed_weight_bytes"] = self._w4a8_bytes["packed"]
        d["weight_hbm_saved_bytes"] = max(
            self._w4a8_bytes["replaced"] - self._w4a8_bytes["packed"], 0)
        d["device"] = str(self.device)
        d["pending_requests"] = self.scheduler.pending
        d["resident_requests"] = len(self._slot_req)
        cap_tokens = self.slots * self.cache_len
        d["cache_tokens_capacity"] = cap_tokens
        # a dense stripe is reserved whole for a slot's lifetime
        d["peak_cache_tokens"] = self._max_residents * self.cache_len
        d["cache_bytes"] = self._cache_bytes
        d["peak_cache_bytes"] = int(
            self._cache_bytes * d["peak_cache_tokens"] / max(cap_tokens, 1))
        d.update(self.scheduler.stats())
        return d
