"""Model stack of the dense GQA decoder (the qwen2.5 family).

The reference scans stacked layers with ``lax.scan``; here each layer is
an entry of ``params["layers"]`` and the stack is a Python loop over them.

Entry points:
* ``init_params``  — random weights from a seed, made on the target device
* ``forward``      — training / teacher / calibration path (logits, and
  the calibration statistics on request)
* ``init_cache``   — a blank dense or paged serving cache
* ``prefill``      — forward over the prompt + the quantized serving cache
* ``decode_step``  — one token against the quantized cache (in place)
* ``prefill_tail`` — one window of a chunked / prefix-hit tail prefill for
  a batch of slots, against the paged pool (in place)
* ``spec_verify``  — the speculative verify-wave: logits at every window
  position of a batch of slots, with decode's numerics (in place)
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import BLOCK_ATTN, ModelConfig
from repro_torch.core.qat import QuantCtx, cache_dtype, qlinear, subcol
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.common import init_norm, rms_norm, rope_tables


def _check_supported(cfg: ModelConfig) -> None:
    if (any(k != BLOCK_ATTN for k in cfg.block_pattern) or cfg.sliding_window
            or cfg.norm_type != "rms" or cfg.mlp_type != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name!r}: the port serves dense full-attention RMS-norm "
            "SwiGLU decoders only")


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype=torch.bfloat16) -> Dict:
    """Random parameters drawn from a ``torch.Generator`` on ``device``
    (``cuda`` unless told otherwise), so a full-width model never passes
    through host memory."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        dtype=torch.float32, device=dev) * 0.02
    params: Dict = {
        "embed": {"w": embed.to(dtype)},
        "final_norm": init_norm(cfg.d_model, dev, dtype),
        "layers": [{"ln1": init_norm(cfg.d_model, dev, dtype),
                    "attn": B.init_attention(cfg, gen, dtype),
                    "ln2": init_norm(cfg.d_model, dev, dtype),
                    "mlp": B.init_mlp(cfg, gen, dtype)}
                   for _ in range(cfg.n_layers)],
    }
    del embed
    if cfg.tie_embeddings:
        # the tied head still owns its quantizer scales (8-bit head site)
        params["head"] = {
            "s_w": torch.ones((1, cfg.vocab_size), dtype=torch.float32,
                              device=dev),
            "s_in": torch.tensor(1.0, dtype=torch.float32, device=dev)}
    else:
        from repro_torch.core.qat import init_linear
        params["head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                     dtype=dtype)
    return params


def head_logits(cfg: ModelConfig, params: Dict, ctx: QuantCtx,
                x: torch.Tensor, col: Optional[Dict] = None) -> torch.Tensor:
    hb = ctx.policy.head_bits
    if cfg.tie_embeddings:
        p = {"w": params["embed"]["w"].T, "s_w": params["head"]["s_w"],
             "s_in": params["head"]["s_in"]}
        if "w4a8" in params["head"]:
            # packed export of embed.w.T (attach_w4a8_exports tied case)
            p["w4a8"] = params["head"]["w4a8"]
    else:
        p = params["head"]
    return qlinear(ctx, x, p, subcol(col, "head"), act_bits=hb,
                   weight_bits=hb)


def _ffn_tail(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
              col: Optional[Dict] = None) -> torch.Tensor:
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + B.mlp_fwd(cfg, ctx, p["mlp"], h, subcol(col, "mlp"))


def _layer_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
               rope, col: Optional[Dict]) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + B.attn_fwd(cfg, ctx, p["attn"], h, rope, subcol(col, "attn"),
                       window=cfg.sliding_window)
    return _ffn_tail(cfg, ctx, p, x, col)


def forward(cfg: ModelConfig, params: Dict, ctx: QuantCtx, batch: Dict,
            collect_stats: bool = False,
            remat: Union[bool, str] = False):
    """Training / teacher / calibration forward over ``batch["tokens"]``
    (B, S). Returns (logits (B, S, V), {"moe_aux", ["qstats"]}).

    ``collect_stats`` (with ``ctx.mode == "calib"``) returns each
    activation site's |x| statistic under ``aux["qstats"]``, a tree that
    mirrors the params (``{"layers": [...], "head": ...}``).
    ``remat`` (True or ``"block"``) recomputes each layer in the backward
    instead of keeping its activations (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint`` around the scanned layer body).
    """
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = params["embed"]["w"][tokens]
    S = tokens.shape[1]
    rope = None
    if cfg.rope_theta:
        rope = rope_tables(torch.arange(S, device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    col: Optional[Dict] = {} if collect_stats else None
    layer_cols: List[Optional[Dict]] = []
    for p in params["layers"]:
        c = {} if collect_stats else None
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _layer_fwd, cfg, ctx, p, x, rope, c, use_reentrant=False)
        else:
            x = _layer_fwd(cfg, ctx, p, x, rope, c)
        layer_cols.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(cfg, params, ctx, x, col)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    if collect_stats:
        col["layers"] = layer_cols
        aux["qstats"] = col
    return logits, aux


def prefill(cfg: ModelConfig, params: Dict, ctx: QuantCtx, batch: Dict,
            cache_budget: int = 0, page_size: int = 0):
    """Forward pass that also emits the quantized serving cache.

    ``batch["tokens"]`` (B, S); ``batch["lengths"]`` (B,) optionally marks
    the valid prefix of right-padded rows: logits are taken at each row's
    last real token and the cache records true lengths. ``cache_budget``:
    cache capacity (>= prompt length). ``page_size`` > 0 emits
    block-shaped caches (B, nb, Hkv, page_size, D) for the paged engine to
    scatter into its pool. Returns (logits (B, 1, V),
    {"layers": [per-layer cache], "position": (B,)}).
    """
    _check_supported(cfg)
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    x = params["embed"]["w"][tokens]
    Bn, S = tokens.shape
    hd = cfg.resolved_head_dim
    rope = None
    if cfg.rope_theta:
        rope = rope_tables(torch.arange(S, device=x.device), hd,
                           cfg.rope_theta)
    caches = []
    for p in params["layers"]:
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, c = B.attn_prefill(cfg, ctx, p["attn"], h, rope,
                              cache_len=cache_budget or S, lengths=lengths,
                              page_size=page_size)
        x = _ffn_tail(cfg, ctx, p, x + a)
        caches.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if lengths is None:
        x_last = x[:, -1:]
        position = torch.full((Bn,), S, dtype=torch.int32, device=x.device)
    else:
        idx = torch.clamp_min(lengths.long() - 1, 0)
        x_last = torch.gather(
            x, 1, idx[:, None, None].expand(Bn, 1, x.shape[-1]))
        position = lengths.to(torch.int32, copy=True)
    logits = head_logits(cfg, params, ctx, x_last)
    return logits, {"layers": caches, "position": position}


def decode_step(cfg: ModelConfig, params: Dict, ctx: QuantCtx,
                tokens1: torch.Tensor, cache: Dict):
    """One decode step. tokens1 (B, 1) -> (logits (B, 1, V), cache).

    The cache is updated in place (each layer's new K/V row, lengths and
    ``position``) and returned. A ``block_tbl`` in the cache switches the
    layers to the paged layout: commits and reads go through the per-slot
    block table into the pool (see ``init_cache`` with ``num_blocks``).
    """
    positions = cache["position"]
    block_tbl = cache.get("block_tbl")
    x = params["embed"]["w"][tokens1]
    rope = None
    if cfg.rope_theta:        # once per step, shared by every layer
        rope = rope_tables(positions[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
    for p, c in zip(params["layers"], cache["layers"]):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = B.attn_decode(cfg, ctx, p["attn"], h, c, positions,
                             block_tbl=block_tbl, rope=rope)
        x = _ffn_tail(cfg, ctx, p, x + a)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(cfg, params, ctx, x)
    cache["position"] += 1
    return logits, cache


def _tail_prologue(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                   cache: Dict, slot: torch.Tensor, offset: torch.Tensor,
                   hist_blocks: int):
    """Entry of the batched-window path: embed one window per row at
    per-row absolute offsets, build per-position RoPE tables, and take each
    row's block table (its first ``hist_blocks`` entries when > 0)."""
    if "block_tbl" not in cache:
        raise ValueError("the batched-window path requires a paged cache "
                         "(init_cache(..., num_blocks=...))")
    C = tokens.shape[1]
    positions = offset.long()[:, None] + torch.arange(
        C, device=tokens.device)[None]                      # (n, C)
    x = params["embed"]["w"][tokens]                        # (n, C, d)
    rope = None
    if cfg.rope_theta:
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    tbl = cache["block_tbl"][slot.long()]                   # (n, T)
    if hist_blocks:
        tbl = tbl[:, :hist_blocks]
    return x, rope, tbl.contiguous()


def _tail_stack(cfg: ModelConfig, params: Dict, ctx: QuantCtx,
                x: torch.Tensor, rope, cache: Dict, tbl: torch.Tensor,
                slot: torch.Tensor, offset: torch.Tensor,
                chunk_len: torch.Tensor, attn_fn) -> torch.Tensor:
    """Run the decoder stack over one batched window, committing every
    layer's K/V through the block table. ``attn_fn`` is the per-layer
    attention: ``blocks.attn_chunk_prefill`` for a tail or chunked
    prefill (exact bf16 window K/V) or ``blocks.attn_spec_verify`` for
    the verify-wave (decode's quantized reads); both share this loop so
    the batched-window contract cannot drift apart. Returns the
    final-norm'd x."""
    for p, c in zip(params["layers"], cache["layers"]):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = attn_fn(cfg, ctx, p["attn"], h, rope, c, tbl, slot, offset,
                       chunk_len)
        x = _ffn_tail(cfg, ctx, p, x + a)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def prefill_tail(cfg: ModelConfig, params: Dict, ctx: QuantCtx,
                 tokens: torch.Tensor, cache: Dict, slot: torch.Tensor,
                 start: torch.Tensor, n_tokens: torch.Tensor,
                 hist_blocks: int = 0, hist_rows: Optional[List[int]] = None):
    """Partial prefill from per-row token offsets for a batch of slots.

    Behind both prefix-shared admission (the first ``start[i]`` tokens
    were found in the prefix cache and their pool blocks are already
    mapped into ``cache["block_tbl"][slot[i]]``, so only the tail is
    computed) and chunked prefill (one window of a long prompt per call).
    ``tokens`` (n, C) holds one window per row, row i's first token at
    absolute position ``start[i]``, its first ``n_tokens[i]`` real. Every
    row is a real slot: the port does not pad the wave.

    Queries attend over the ``start[i]`` tokens resident in the pool,
    read back dequantized as decode reads them, plus the window itself
    (``blocks.attn_chunk_prefill``); the window's K/V are committed
    through the table in place. The engine grows each table to cover
    ``start + n_tokens`` and resolves copy-on-write for shared blocks in
    that range before calling. ``hist_blocks`` > 0 limits the table walk
    to each row's first ``hist_blocks`` entries (it must cover every
    row's ``start + n_tokens``). ``hist_rows`` (host ints) gives each
    row's own history extent in blocks; on CUDA the attention then runs
    row by row over it, so a row's result does not depend on the wave
    (``blocks.attn_chunk_prefill``).

    Returns (logits (n, V) at each row's last real token, cache).
    """
    offset, chunk_len = start, n_tokens
    x, rope, tbl = _tail_prologue(cfg, params, tokens, cache, slot, offset,
                                  hist_blocks)
    x = _tail_stack(cfg, params, ctx, x, rope, cache, tbl, slot, offset,
                    chunk_len, functools.partial(B.attn_chunk_prefill,
                                                 hist_rows=hist_rows))
    n = x.shape[0]
    idx = torch.clamp_min(chunk_len.long() - 1, 0)
    x_last = torch.gather(x, 1, idx[:, None, None].expand(n, 1, x.shape[-1]))
    logits = head_logits(cfg, params, ctx, x_last)[:, 0]
    cache["position"][slot.long()] = (offset + chunk_len).to(torch.int32)
    return logits, cache


def spec_verify(cfg: ModelConfig, params: Dict, ctx: QuantCtx,
                tokens: torch.Tensor, cache: Dict, slot: torch.Tensor,
                start: torch.Tensor, n_tokens: torch.Tensor,
                hist_blocks: int = 0):
    """Speculative-decode verify pass: the target's logits at every window
    position of a batch of slots, in one call.

    The batched-window contract of :func:`prefill_tail`: ``tokens`` (n, C)
    holds row i's window ``[last_committed_token, draft_1..draft_k]`` from
    absolute position ``start[i]``, ``n_tokens[i]`` of it real. Where a
    tail prefill attends with exact bf16 window K/V, the verify pass
    commits the window's quantized K/V first and reads them back through
    the table (``blocks.attn_spec_verify``), so the logits at position j
    are what ``decode_step`` gives after consuming the window through j.
    ``hist_blocks`` bounds the table walk as in ``prefill_tail``.

    Returns (logits (n, C, V), cache) with ``length``/``position`` at
    ``start + n_tokens``; the engine re-clamps them to the accepted
    extent.
    """
    offset, chunk_len = start, n_tokens
    x, rope, tbl = _tail_prologue(cfg, params, tokens, cache, slot, offset,
                                  hist_blocks)
    x = _tail_stack(cfg, params, ctx, x, rope, cache, tbl, slot, offset,
                    chunk_len, B.attn_spec_verify)
    logits = head_logits(cfg, params, ctx, x)
    cache["position"][slot.long()] = (offset + chunk_len).to(torch.int32)
    return logits, cache


def init_cache(cfg: ModelConfig, ctx: QuantCtx, batch_size: int,
               cache_len: int, *, device, num_blocks: int = 0,
               page_size: int = 0, table_len: int = 0) -> Dict:
    """Blank serving cache with capacity ``cache_len`` per slot.

    ``num_blocks`` > 0 switches to the paged layout: one global pool of
    ``num_blocks`` x ``page_size``-token quantized blocks per layer (plus
    the sink block), held as layer-stacked leaves under ``"pool"`` with
    per-layer views under ``"layers"``, and a top-level ``block_tbl``
    (batch_size, table_len) int32 mapping each slot's logical block i to
    a pool block, initialised to the ``num_blocks`` sentinel.
    """
    _check_supported(cfg)
    qdt = cache_dtype(ctx)
    position = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    if num_blocks:
        pool, layers = B.init_paged_attn_cache(
            cfg, batch_size, num_blocks, page_size, layers=cfg.n_layers,
            device=device, dtype=qdt)
        tbl = torch.full((batch_size, table_len or num_blocks), num_blocks,
                         dtype=torch.int32, device=device)
        return {"pool": pool, "layers": layers, "position": position,
                "block_tbl": tbl}
    return {"layers": [B.init_attn_cache(cfg, batch_size, cache_len,
                                         device=device, dtype=qdt)
                       for _ in range(cfg.n_layers)],
            "position": position}


def clone_cache(cache: Dict) -> Dict:
    """Deep copy of a serving cache (decode_step mutates its argument).
    A paged copy gets its own stacked pool with fresh per-layer views."""
    if "pool" in cache:
        pool = {k: v.clone() for k, v in cache["pool"].items()}
        B_ = cache["position"].shape[0]
        layers = B.paged_layer_views(
            pool, B_, [c["length"].clone() for c in cache["layers"]])
        return {"pool": pool, "layers": layers,
                "position": cache["position"].clone(),
                "block_tbl": cache["block_tbl"].clone()}
    return {"layers": [{k: v.clone() for k, v in c.items()}
                       for c in cache["layers"]],
            "position": cache["position"].clone()}
