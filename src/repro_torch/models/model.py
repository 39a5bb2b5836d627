"""Model stack of the dense and MoE GQA decoders (the qwen2.5 family,
mixtral, moonshot), the hybrid RG-LRU and local-attention stack
(recurrentgemma), the xLSTM family (mLSTM and sLSTM blocks), the
encoder-decoder (whisper) and the M-RoPE VLM backbone (qwen2-vl).

The reference scans stacked layers with ``lax.scan``; here each layer is
an entry of ``params["layers"]`` and the stack is a Python loop over them,
layer i of kind ``cfg.layer_kinds()[i]``: an attention layer (global or
local) holds ``{"ln1", "attn", "ln2", "mlp"}`` (``"moe"`` in place of
``"mlp"`` in an MoE config), an RG-LRU layer ``{"ln1", "rglru", "ln2",
"mlp"}``, an xLSTM one ``{"ln1", "cell"}``. A local-attention layer
attends over the last ``cfg.local_window`` positions and serves from a
ring of that many rows; a global one over the last ``cfg.sliding_window``
when that is set (mixtral), with a ring of as many rows.

An encoder-decoder (``cfg.is_encdec``) holds ``params["encoder"] =
{"pos_embed", "layers", "final_norm"}``: bidirectional attention layers
over ``batch["frames"]`` (B, encoder_seq, d), precomputed frame
embeddings, plus learned positions; each decoder layer adds ``{"ln_x",
"xattn"}``, a cross-attention over the encoder's output, whose K/V the
prefill freezes into a ``"cross"`` cache beside the layer's self cache.
Learned absolute positions (``params["pos_embed"]``) are added to the
decoder's embeddings. A VLM (``cfg.mrope``) takes ``batch["patches"]``
(B, vision_tokens, d) as a prefix of the sequence and ``batch
["positions"]`` (3, B, S), the (t, h, w) streams of the multimodal
rotary; its decode goes on with plain RoPE at the next position.

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

from repro_torch.configs.base import (ATTENTION_BLOCKS, BLOCK_ATTN,
                                      BLOCK_LOCAL_ATTN, BLOCK_MLSTM,
                                      BLOCK_RGLRU, BLOCK_SLSTM, ModelConfig)
from repro_torch.core.qat import (QuantCtx, cache_dtype, qlinear, subcol,
                                  train_tp)
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import recurrent as R
from repro_torch.models.common import (init_norm, mrope_tables, norm,
                                       rope_tables)

_PORTED_KINDS = (BLOCK_ATTN, BLOCK_LOCAL_ATTN, BLOCK_RGLRU, BLOCK_MLSTM,
                 BLOCK_SLSTM)


def _check_supported(cfg: ModelConfig) -> None:
    if (any(k not in _PORTED_KINDS for k in cfg.block_pattern)
            or cfg.norm_type not in ("rms", "ln")
            or cfg.mlp_type not in ("swiglu", "gelu")):
        raise NotImplementedError(
            f"{cfg.name!r}: the port runs RMS- or LayerNorm, SwiGLU or GELU "
            "(dense or MoE) stacks of global, sliding-window and local "
            "attention, RG-LRU, mLSTM and sLSTM blocks only")


def _norm(cfg: ModelConfig, x: torch.Tensor, p: Dict) -> torch.Tensor:
    return norm(x, p, cfg.norm_type, cfg.norm_eps)


def _window(cfg: ModelConfig, kind: str) -> int:
    """The attention window of a layer of ``kind`` (0: full)."""
    return cfg.local_window if kind == BLOCK_LOCAL_ATTN else \
        cfg.sliding_window


def _attention_only(cfg: ModelConfig) -> bool:
    return all(k in ATTENTION_BLOCKS for k in cfg.block_pattern)


def _init_layer(cfg: ModelConfig, kind: str, gen: torch.Generator, dev,
                dtype, cross: bool = False) -> Dict:
    nk = cfg.norm_type
    p = {"ln1": init_norm(cfg.d_model, dev, dtype, nk)}
    if kind in ATTENTION_BLOCKS:
        p["attn"] = B.init_attention(cfg, gen, dtype)
        if cross:
            p.update(ln_x=init_norm(cfg.d_model, dev, dtype, nk),
                     xattn=B.init_attention(cfg, gen, dtype, cross=True))
        p["ln2"] = init_norm(cfg.d_model, dev, dtype, nk)
        if cfg.is_moe:
            p["moe"] = B.init_moe(cfg, gen, dtype)
        else:
            p["mlp"] = B.init_mlp(cfg, gen, dtype)
    elif kind == BLOCK_RGLRU:
        p.update(rglru=R.init_rglru(cfg, gen, dtype),
                 ln2=init_norm(cfg.d_model, dev, dtype, nk),
                 mlp=B.init_mlp(cfg, gen, dtype))
    elif kind == BLOCK_MLSTM:
        p["cell"] = R.init_mlstm(cfg, gen, dtype)
    else:
        p["cell"] = R.init_slstm(cfg, gen, dtype)
    return p


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE tables at ``positions`` when some layer attends, else None."""
    if not cfg.rope_theta or not any(k in ATTENTION_BLOCKS
                                     for k in cfg.block_pattern):
        return None
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _rope_for(cfg: ModelConfig, batch: Dict, S: int, device):
    """The forward's and prefill's tables: M-RoPE at a VLM's ``batch
    ["positions"]`` (3, B, S) when given, else RoPE at 0..S-1."""
    if cfg.mrope and cfg.rope_theta and "positions" in batch:
        return mrope_tables(batch["positions"], cfg.resolved_head_dim,
                            cfg.rope_theta)
    return _rope(cfg, torch.arange(S, device=device))


def _lookup(cfg: ModelConfig, ctx: QuantCtx, params: Dict,
            tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``. On a tensor-parallel mesh
    (``ctx.tp``) the table is this rank's shard and the rows are summed
    (vocabulary shard) or gathered (d_model shard) over the ranks."""
    w = params["embed"]["w"]
    if ctx.tp is not None and ctx.tp.size > 1:
        return ctx.tp.embed_lookup(w, tokens, cfg.vocab_size, cfg.d_model)
    return w[tokens]


def _embed(cfg: ModelConfig, ctx: QuantCtx, params: Dict,
           batch: Dict) -> torch.Tensor:
    """Token embeddings, after a VLM's patch prefix, plus learned
    positions from ``batch.get("pos_offset", 0)`` (clamped, as the
    reference's dynamic slice clamps, to fit the table)."""
    x = _lookup(cfg, ctx, params, batch["tokens"])
    if "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    if "pos_embed" in params:
        pos = params["pos_embed"]["w"]
        S = x.shape[1]
        off = min(max(int(batch.get("pos_offset", 0)), 0), pos.shape[0] - S)
        x = x + pos[off:off + S][None]
    return x


def _encoder_layer(cfg: ModelConfig, ctx: QuantCtx, p: Dict,
                   x: torch.Tensor, col: Optional[Dict]) -> torch.Tensor:
    """One bidirectional encoder layer. Its statistics are collected
    under ``"0attn"`` and ``"0mlp"``, the reference's keys, which do not
    mirror the layer's params: ``merge_act_scales`` writes no encoder
    activation scale in either package."""
    h = _norm(cfg, x, p["ln1"])
    x = x + B.attn_fwd(cfg, ctx, p["attn"], h, None, subcol(col, "0attn"),
                       causal=False)
    h = _norm(cfg, x, p["ln2"])
    return x + B.mlp_fwd(cfg, ctx, p["mlp"], h, subcol(col, "0mlp"))


def _encode(cfg: ModelConfig, ctx: QuantCtx, params: Dict, batch: Dict,
            col: Optional[Dict], remat=False) -> torch.Tensor:
    """The encoder over ``batch["frames"]`` plus its learned positions,
    then its final norm. ``remat``: recompute each layer in the
    backward (as the decoder's)."""
    enc = params["encoder"]
    h = batch["frames"].to(enc["pos_embed"]["w"].dtype)
    h = h + enc["pos_embed"]["w"][None, :h.shape[1]]
    cols = []
    for p in enc["layers"]:
        c = {} if col is not None else None
        if remat and torch.is_grad_enabled():
            h = torch.utils.checkpoint.checkpoint(
                _encoder_layer, cfg, ctx, p, h, c, use_reentrant=False)
        else:
            h = _encoder_layer(cfg, ctx, p, h, c)
        cols.append(c)
    if col is not None:
        col["encoder"] = {"layers": cols}
    return _norm(cfg, h, enc["final_norm"])


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

    def table(rows):
        return (torch.randn((rows, cfg.d_model), generator=gen,
                            dtype=torch.float32, device=dev) * 0.02).to(dtype)

    params: Dict = {
        "embed": {"w": table(cfg.vocab_size)},
        "final_norm": init_norm(cfg.d_model, dev, dtype, cfg.norm_type),
        "layers": [_init_layer(cfg, kind, gen, dev, dtype, cfg.is_encdec)
                   for kind in cfg.layer_kinds()],
    }
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
    if cfg.max_position_embeddings:
        params["pos_embed"] = {"w": table(cfg.max_position_embeddings)}
    if cfg.is_encdec:
        params["encoder"] = {
            "pos_embed": {"w": table(cfg.encoder_seq)},
            "layers": [_init_layer(cfg, BLOCK_ATTN, gen, dev, dtype)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": init_norm(cfg.d_model, dev, dtype,
                                    cfg.norm_type)}
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
    if train_tp(ctx):
        x = ctx.tp.copy_in(x)
    logits = qlinear(ctx, x, p, subcol(col, "head"), act_bits=hb,
                     weight_bits=hb)
    if ctx.tp is not None and logits.shape[-1] < cfg.vocab_size:
        # column-parallel on the vocabulary: the ranks' slices in order
        # (in training every rank's loss reads them whole, so the
        # gradient of its own slice is this rank's)
        logits = (ctx.tp.gather_last(logits) if logits.requires_grad
                  else ctx.tp.all_gather_last(logits))
    return logits


def _ffn_tail(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
              col: Optional[Dict] = None, *, with_aux: bool = False):
    """ln2 + MoE or MLP + residual: the post-mixer half of a layer, shared
    by the forward, prefill, decode and batched-window paths. Returns (x,
    the MoE's load-balance aux; None for a dense MLP, zero unless
    ``with_aux``)."""
    h = _norm(cfg, x, p["ln2"])
    if "moe" in p:
        y, aux = B.moe_fwd(cfg, ctx, p["moe"], h, subcol(col, "moe"),
                           with_aux=with_aux)
        return x + y, aux
    return x + B.mlp_fwd(cfg, ctx, p["mlp"], h, subcol(col, "mlp")), None


def _block_fwd(cfg: ModelConfig, ctx: QuantCtx, kind: str, p: Dict,
               x: torch.Tensor, rope, col: Optional[Dict],
               enc_out: Optional[torch.Tensor] = None):
    """One layer of the training / teacher / calibration forward: (x, the
    layer's MoE aux or None). A decoder layer of an encoder-decoder
    cross-attends over ``enc_out`` after its self-attention."""
    h = _norm(cfg, x, p["ln1"])
    if kind in ATTENTION_BLOCKS:
        x = x + B.attn_fwd(cfg, ctx, p["attn"], h, rope, subcol(col, "attn"),
                           window=_window(cfg, kind))
        if "xattn" in p:
            h = _norm(cfg, x, p["ln_x"])
            x = x + B.attn_fwd(cfg, ctx, p["xattn"], h, None,
                               subcol(col, "xattn"), enc_out=enc_out)
        return _ffn_tail(cfg, ctx, p, x, col, with_aux=True)
    if kind == BLOCK_RGLRU:
        x = x + R.rglru_fwd(cfg, ctx, p["rglru"], h, subcol(col, "rglru"))
        return _ffn_tail(cfg, ctx, p, x, col)
    fwd = R.mlstm_fwd if kind == BLOCK_MLSTM else R.slstm_fwd
    return x + fwd(cfg, ctx, p["cell"], h, subcol(col, "cell")), None


def _block_prefill(cfg: ModelConfig, ctx: QuantCtx, kind: str, p: Dict,
                   x: torch.Tensor, rope, enc_out=None, **attn_kw):
    """One layer of the prefill: (x, the layer's serving cache; a decoder
    layer of an encoder-decoder adds its frozen ``"cross"`` cache)."""
    h = _norm(cfg, x, p["ln1"])
    if kind in ATTENTION_BLOCKS:
        a, c = B.attn_prefill(cfg, ctx, p["attn"], h, rope,
                              window=_window(cfg, kind), **attn_kw)
        x = x + a
        if "xattn" in p:
            h = _norm(cfg, x, p["ln_x"])
            a, c["cross"] = B.attn_prefill(
                cfg, ctx, p["xattn"], h, None, enc_out=enc_out,
                row_lengths=attn_kw.get("row_lengths"))
            x = x + a
        return _ffn_tail(cfg, ctx, p, x)[0], c
    if kind == BLOCK_RGLRU:
        y, c = R.rglru_prefill(cfg, ctx, p["rglru"], h)
        return _ffn_tail(cfg, ctx, p, x + y)[0], c
    mod = R.mlstm_prefill if kind == BLOCK_MLSTM else R.slstm_prefill
    y, c = mod(cfg, ctx, p["cell"], h)
    return x + y, c


def _block_decode(cfg: ModelConfig, ctx: QuantCtx, kind: str, p: Dict,
                  x1: torch.Tensor, cache: Dict, positions: torch.Tensor,
                  block_tbl, rope) -> torch.Tensor:
    """One layer of a decode step; the layer's cache is updated in place
    (a cross cache is read, never written)."""
    h = _norm(cfg, x1, p["ln1"])
    if kind in ATTENTION_BLOCKS:
        # a local layer's ring (min(cache_len, window) rows) keeps its
        # window: attn_decode attends over the ring's min(length, Sc) rows
        a, _ = B.attn_decode(cfg, ctx, p["attn"], h, cache, positions,
                             block_tbl=block_tbl, rope=rope)
        x1 = x1 + a
        if "xattn" in p:
            h = _norm(cfg, x1, p["ln_x"])
            a, _ = B.attn_decode(cfg, ctx, p["xattn"], h, cache["cross"],
                                 positions, cross=True)
            x1 = x1 + a
        return _ffn_tail(cfg, ctx, p, x1)[0]
    if kind == BLOCK_RGLRU:
        y, _ = R.rglru_decode(cfg, ctx, p["rglru"], h, cache)
        return _ffn_tail(cfg, ctx, p, x1 + y)[0]
    dec = R.mlstm_decode if kind == BLOCK_MLSTM else R.slstm_decode
    y, _ = dec(cfg, ctx, p["cell"], h, cache)
    return x1 + y


def forward(cfg: ModelConfig, params: Dict, ctx: QuantCtx, batch: Dict,
            collect_stats: bool = False,
            remat: Union[bool, str] = False):
    """Training / teacher / calibration forward over ``batch["tokens"]``
    (B, S) (and an encoder-decoder's ``batch["frames"]``, a VLM's
    ``batch["patches"]`` prefix and ``batch["positions"]``). Returns
    (logits (B, S + vision prefix, V), {"moe_aux", ["qstats"]}):
    ``moe_aux`` is the MoE layers' load-balance aux summed over layers
    (zero without experts).

    ``collect_stats`` (with ``ctx.mode == "calib"``) returns each
    activation site's |x| statistic under ``aux["qstats"]``, a tree that
    mirrors the params (``{"layers": [...], "head": ...}``; an encoder's
    under ``"encoder"``, keyed as the reference keys it).
    ``remat`` (True or ``"block"``) recomputes each layer (the encoder's
    too) in the backward
    instead of keeping its activations (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint`` around the scanned layer body).
    """
    _check_supported(cfg)
    x = _embed(cfg, ctx, params, batch)
    rope = _rope_for(cfg, batch, x.shape[1], x.device)
    col: Optional[Dict] = {} if collect_stats else None
    enc_out = (_encode(cfg, ctx, params, batch, col, remat)
               if cfg.is_encdec else None)
    layer_cols: List[Optional[Dict]] = []
    moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(cfg.layer_kinds(), params["layers"]):
        c = {} if collect_stats else None
        if remat and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(
                _block_fwd, cfg, ctx, kind, p, x, rope, c, enc_out,
                use_reentrant=False)
        else:
            x, a = _block_fwd(cfg, ctx, kind, p, x, rope, c, enc_out)
        if a is not None:
            moe_aux = moe_aux + a
        layer_cols.append(c)
    x = _norm(cfg, x, params["final_norm"])
    logits = head_logits(cfg, params, ctx, x, col)
    aux = {"moe_aux": moe_aux}
    if collect_stats:
        col["layers"] = layer_cols
        aux["qstats"] = col
    return logits, aux


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, ctx: QuantCtx, batch: Dict,
            cache_budget: int = 0, page_size: int = 0):
    """Forward pass that also emits the quantized serving cache.

    ``batch["tokens"]`` (B, S); ``batch["lengths"]`` (B,) optionally marks
    the valid prefix of right-padded rows: logits are taken at each row's
    last real token and the cache records true lengths. ``cache_budget``:
    cache capacity (>= prompt length). ``page_size`` > 0 emits
    block-shaped caches (B, nb, Hkv, page_size, D) for the paged engine to
    scatter into its pool. ``lengths`` and ``page_size`` need an
    attention-only decoder without an encoder: a recurrent scan would
    fold the padding into its state. An encoder-decoder reads
    ``batch["frames"]`` and each layer's cache holds the frozen
    ``"cross"`` K/V of the encoder's output; a VLM reads ``batch
    ["patches"]`` (a prefix counted in the position) and ``batch
    ["positions"]``. It serves and runs without a gradient, so an
    encoder's attention is the flash kernel on CUDA
    (``blocks.attn_fwd``). Returns (logits (B, 1, V),
    {"layers": [per-layer cache], "position": (B,)}).
    """
    _check_supported(cfg)
    lengths = batch.get("lengths")
    if (lengths is not None or page_size) and (cfg.is_encdec or
                                               not _attention_only(cfg)):
        raise ValueError(
            "batch['lengths'] (right-padded prefill) and page_size (paged "
            "cache) require an attention-only decoder; "
            f"{cfg.name!r} has block pattern {cfg.block_pattern}"
            + (" and an encoder" if cfg.is_encdec else ""))
    x = _embed(cfg, ctx, params, batch)
    Bn, S = x.shape[0], x.shape[1]
    rope = _rope_for(cfg, batch, S, x.device)
    # CUDA attends row by row over the true lengths, read here once (an
    # encoder-decoder's rows are whole)
    rows = None
    if x.is_cuda and lengths is not None:
        rows = lengths.tolist()
    elif x.is_cuda and cfg.is_encdec:
        rows = [S] * Bn
    enc_out = (_encode(cfg, ctx, params, batch, None) if cfg.is_encdec
               else None)
    caches = []
    for kind, p in zip(cfg.layer_kinds(), params["layers"]):
        x, c = _block_prefill(cfg, ctx, kind, p, x, rope, enc_out=enc_out,
                              cache_len=cache_budget or S, lengths=lengths,
                              page_size=page_size, row_lengths=rows)
        caches.append(c)
    x = _norm(cfg, x, params["final_norm"])
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

    The cache is updated in place (each attention layer's new K/V row and
    length, each recurrent layer's state, and ``position``) and returned.
    A ``block_tbl`` in the cache switches the layers to the paged layout:
    commits and reads go through the per-slot block table into the pool
    (see ``init_cache`` with ``num_blocks``). Learned positions are added
    at ``min(position, max_position_embeddings - 1)``; a VLM decodes with
    plain RoPE at its position (after the patch prefix), as the
    reference does.
    """
    positions = cache["position"]
    block_tbl = cache.get("block_tbl")
    x = _lookup(cfg, ctx, params, tokens1)
    if "pos_embed" in params:
        pe = params["pos_embed"]["w"]
        x = x + pe[torch.clamp_max(positions.long(), pe.shape[0] - 1)][:, None]
    rope = _rope(cfg, positions[:, None])   # once per step, for every layer
    for kind, p, c in zip(cfg.layer_kinds(), params["layers"],
                          cache["layers"]):
        x = _block_decode(cfg, ctx, kind, p, x, c, positions, block_tbl,
                          rope)
    x = _norm(cfg, x, params["final_norm"])
    logits = head_logits(cfg, params, ctx, x)
    cache["position"] += 1
    return logits, cache


def _tail_prologue(cfg: ModelConfig, params: Dict, ctx: QuantCtx,
                   tokens: torch.Tensor, cache: Dict, slot: torch.Tensor,
                   offset: torch.Tensor, hist_blocks: int):
    """Entry of the batched-window path: embed one window per row at
    per-row absolute offsets, build per-position RoPE tables, and take each
    row's block table (its first ``hist_blocks`` entries when > 0)."""
    if "block_tbl" not in cache:
        raise ValueError("the batched-window path requires a paged cache "
                         "(init_cache(..., num_blocks=...))")
    C = tokens.shape[1]
    positions = offset.long()[:, None] + torch.arange(
        C, device=tokens.device)[None]                      # (n, C)
    x = _lookup(cfg, ctx, params, tokens)                   # (n, C, d)
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
        h = _norm(cfg, x, p["ln1"])
        a, _ = attn_fn(cfg, ctx, p["attn"], h, rope, c, tbl, slot, offset,
                       chunk_len)
        x = _ffn_tail(cfg, ctx, p, x + a)[0]
    return _norm(cfg, x, params["final_norm"])


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
    x, rope, tbl = _tail_prologue(cfg, params, ctx, tokens, cache, slot,
                                  offset, hist_blocks)
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
    the table (``blocks.attn_spec_verify``), so with a dense MLP the
    logits at position j are what ``decode_step`` gives after consuming
    the window through j. An MoE layer routes the whole window at once,
    with the capacity of a C-token chunk (at C = 5, top 6 of 64 experts:
    one slot an expert), so a token can be dropped that decode, routing
    one token a step, keeps: there the verify logits need not equal
    decode's, as in the reference. ``hist_blocks`` bounds the table walk
    as in ``prefill_tail``.

    Returns (logits (n, C, V), cache) with ``length``/``position`` at
    ``start + n_tokens``; the engine re-clamps them to the accepted
    extent.
    """
    offset, chunk_len = start, n_tokens
    x, rope, tbl = _tail_prologue(cfg, params, ctx, tokens, cache, slot,
                                  offset, hist_blocks)
    x = _tail_stack(cfg, params, ctx, x, rope, cache, tbl, slot, offset,
                    chunk_len, B.attn_spec_verify)
    logits = head_logits(cfg, params, ctx, x)
    cache["position"][slot.long()] = (offset + chunk_len).to(torch.int32)
    return logits, cache


def init_cache(cfg: ModelConfig, ctx: QuantCtx, batch_size: int,
               cache_len: int, *, device, num_blocks: int = 0,
               page_size: int = 0, table_len: int = 0) -> Dict:
    """Blank serving cache with capacity ``cache_len`` per slot.

    Attention layers hold a dense K/V ring (a local-attention layer one
    of ``min(cache_len, cfg.local_window)`` rows, a global one under a
    ``cfg.sliding_window`` one of ``min(cache_len, cfg.sliding_window)``
    rows), RG-LRU layers their
    quantized h (``state_q``, ``s_state``) and the conv's bf16 history
    (``conv_buf``), mLSTM layers their quantized matrix state
    (``state_q``, ``s_state``), sLSTM layers their quantized h
    (``state_q``, ``s_state``) and f32 ``c``.

    ``num_blocks`` > 0 switches to the paged layout: one global pool of
    ``num_blocks`` x ``page_size``-token quantized blocks per layer (plus
    the sink block), held as layer-stacked leaves under ``"pool"`` with
    per-layer views under ``"layers"``, and a top-level ``block_tbl``
    (batch_size, table_len) int32 mapping each slot's logical block i to
    a pool block, initialised to the ``num_blocks`` sentinel. It needs a
    full-attention decoder without cross-attention.

    An encoder-decoder's attention layers also hold a ``"cross"`` cache
    of ``cfg.encoder_seq`` rows, which the prefill fills.
    """
    _check_supported(cfg)
    if num_blocks and (cfg.is_encdec or cfg.sliding_window or any(
            k != BLOCK_ATTN for k in cfg.block_pattern)):
        raise ValueError(
            "paged KV cache requires a full-attention decoder (no sliding "
            f"window, no recurrence, no cross-attention); {cfg.name!r} has "
            f"block pattern {cfg.block_pattern}")
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

    def layer_cache(kind):
        if kind in ATTENTION_BLOCKS:
            c = B.init_attn_cache(cfg, batch_size, cache_len, device=device,
                                  window=_window(cfg, kind), dtype=qdt)
            if cfg.is_encdec:
                c["cross"] = B.init_attn_cache(cfg, batch_size,
                                               cfg.encoder_seq,
                                               device=device, dtype=qdt)
            return c
        init = {BLOCK_RGLRU: R.init_rglru_cache,
                BLOCK_MLSTM: R.init_mlstm_cache,
                BLOCK_SLSTM: R.init_slstm_cache}[kind]
        return init(cfg, batch_size, device=device, dtype=qdt)

    return {"layers": [layer_cache(kind) for kind in cfg.layer_kinds()],
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
    def clone(c):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in c.items()}

    return {"layers": [clone(c) for c in cache["layers"]],
            "position": cache["position"].clone()}
