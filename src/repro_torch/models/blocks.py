"""Transformer blocks of the dense GQA decoder: attention with a quantized
KV cache and the SwiGLU MLP, with SiLQ quantization sites (paper Fig. 2):

* every linear: input A-bits (``s_in``), weight W-bits per-out-channel (``s_w``)
* query into QK^T: 16-bit (``s_q``)
* K/V written to cache: C-bits (``s_k``/``s_v``)

Caches are updated in place: the engine owns one cache per layer for its
whole life, and a decode step writes its new K/V row into it.

Two cache layouts: the dense ring (``init_attn_cache``, one stripe of
``cache_len`` rows per slot) and the paged pool (``init_paged_attn_cache``,
blocks of ``page_size`` tokens shared by every slot through a block table).
A paged layer's pool leaves are views of layer-stacked tensors with one
block more than the pool holds: the last block is the write sink for
sentinel destinations (``kernels/kvq_attn/ref.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qat import (QuantCtx, cache_quantize, init_linear,
                                  qlinear, quantize_act, subcol)
from repro_torch.core.quantizer import quantize_to_int
from repro_torch.kernels.kvq_attn.ref import gather_paged_kv, pool_blocks
from repro_torch.models.common import (apply_rope, blockwise_attention,
                                       decode_attention_intcache,
                                       head_rms_norm, rope_tables)

POOL_KEYS = ("k_q", "v_q", "s_k", "s_v")     # pool-shaped paged leaves
_NEG = -1e30


def _decode_attn(ctx: QuantCtx, q, k_q, v_q, s_k, s_v, lengths) -> torch.Tensor:
    """Decode attention over the int cache for a full slot batch.

    CUDA tensors go through the hand-written flash-decode kernel (int8
    rows dequantized on chip, one block per slot and KV head); CPU
    tensors, and every tensor under ``kernel_backend="ref"``, through the
    plain path. Both take the same batched (B, ...) operands.
    """
    if q.is_cuda and ctx.kernel_backend != "ref":
        from repro_torch.kernels.kvq_attn.ops import kvq_decode_attn
        return kvq_decode_attn(q, k_q, v_q, s_k, s_v, lengths)
    return decode_attention_intcache(q, k_q, v_q, s_k, s_v, lengths)


def _decode_attn_paged(ctx: QuantCtx, q, k_pool, v_pool, s_k, s_v,
                       block_tbl, lengths) -> torch.Tensor:
    """Decode attention through a block table over the global pool.

    CUDA tensors go through the hand-written paged kernel, which walks
    each slot's table itself; CPU tensors, and every tensor under
    ``kernel_backend="ref"``, gather the slot's blocks into a contiguous
    view and take the dense plain path, so dense and paged decode agree
    bitwise there, as in the reference.
    """
    if q.is_cuda and ctx.kernel_backend != "ref":
        from repro_torch.kernels.kvq_attn.ops import kvq_paged_decode_attn
        return kvq_paged_decode_attn(q, k_pool, v_pool, s_k, s_v,
                                     block_tbl, lengths)
    return decode_attention_intcache(
        q, gather_paged_kv(k_pool, block_tbl),
        gather_paged_kv(v_pool, block_tbl), gather_paged_kv(s_k, block_tbl),
        gather_paged_kv(s_v, block_tbl), lengths)


def _spec_verify_attn(ctx: QuantCtx, q, k_pool, v_pool, s_k, s_v,
                      block_tbl, lengths) -> torch.Tensor:
    """The verify-wave's attention: q (n, C, H, D), query c of row i over
    the first ``lengths[i, c]`` pool tokens of its table.

    CUDA tensors go through the hand-written kernel, one launch for all C
    queries, each query bitwise equal to the paged decode kernel at its
    length. CPU tensors, and every tensor under ``kernel_backend="ref"``,
    run :func:`_decode_attn_paged`'s plain path once per query, so the
    verified logits equal sequential decode steps there too.
    """
    if q.is_cuda and ctx.kernel_backend != "ref":
        from repro_torch.kernels.kvq_attn.ops import kvq_spec_verify_attn
        return kvq_spec_verify_attn(q, k_pool, v_pool, s_k, s_v, block_tbl,
                                    lengths)
    return torch.stack(
        [_decode_attn_paged(ctx, q[:, c], k_pool, v_pool, s_k, s_v,
                            block_tbl, lengths[:, c].contiguous())
         for c in range(q.shape[1])], dim=1)


# ==========================================================================
# Dense MLP (SwiGLU)
# ==========================================================================

def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             dtype=torch.bfloat16) -> Dict:
    if cfg.mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported")
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": init_linear(gen, d, f, dtype=dtype),
            "wu": init_linear(gen, d, f, dtype=dtype),
            "wd": init_linear(gen, f, d, dtype=dtype)}


def mlp_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
            col: Optional[Dict] = None) -> torch.Tensor:
    g = qlinear(ctx, x, p["wg"], subcol(col, "wg"))
    u = qlinear(ctx, x, p["wu"], subcol(col, "wu"))
    h = F.silu(g.float()).to(x.dtype) * u
    return qlinear(ctx, h, p["wd"], subcol(col, "wd"))


# ==========================================================================
# Attention block with quantized KV cache
# ==========================================================================

def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype=torch.bfloat16) -> Dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dev = gen.device
    one = lambda: torch.tensor(1.0, dtype=torch.float32, device=dev)  # noqa: E731
    p = {"wq": init_linear(gen, d, qd, bias=cfg.qkv_bias, dtype=dtype),
         "wk": init_linear(gen, d, kvd, bias=cfg.qkv_bias, dtype=dtype),
         "wv": init_linear(gen, d, kvd, bias=cfg.qkv_bias, dtype=dtype),
         "wo": init_linear(gen, qd, d, dtype=dtype),
         "s_q": one(), "s_k": one(), "s_v": one()}
    if cfg.qk_norm:
        hd = cfg.resolved_head_dim
        p["q_norm"] = {"w": torch.ones((hd,), dtype=dtype, device=dev)}
        p["k_norm"] = {"w": torch.ones((hd,), dtype=dtype, device=dev)}
    return p


def _qkv(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor, rope,
         col: Optional[Dict] = None):
    hd = cfg.resolved_head_dim
    B, S = x.shape[0], x.shape[1]
    q = qlinear(ctx, x, p["wq"], subcol(col, "wq")).reshape(
        B, S, cfg.n_heads, hd)
    k = qlinear(ctx, x, p["wk"], subcol(col, "wk")).reshape(
        B, S, cfg.n_kv_heads, hd)
    v = qlinear(ctx, x, p["wv"], subcol(col, "wv")).reshape(
        B, S, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = head_rms_norm(q, p["q_norm"]["w"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"]["w"], cfg.norm_eps)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    # paper sites: query INT16, cache C-bits
    q = quantize_act(ctx, q, p, "s_q", col)
    k = quantize_act(ctx, k, p, "s_k", col)
    v = quantize_act(ctx, v, p, "s_v", col)
    return q, k, v


def attn_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
             rope, col: Optional[Dict] = None, *,
             window: int = 0) -> torch.Tensor:
    """Causal self-attention, training / teacher / calibration path.

    The rule for the attention itself is written here once: a forward
    that needs no gradient (the teacher in each QAT step, calibration,
    evaluation: ``torch.is_grad_enabled()`` is False) runs the
    flash-attention kernel for CUDA tensors (``kernel_backend="ref"``: its
    plain version) and its plain version for CPU tensors; a forward under
    autograd (the student, the teacher's pretraining) runs
    :func:`blockwise_attention`, which autograd differentiates, as XLA
    differentiates the same function in the reference.
    """
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, ctx, p, x, rope, col)
    if torch.is_grad_enabled():
        out = blockwise_attention(q, k, v, causal=True, window=window,
                                  q_chunk=1024, kv_chunk=1024)
    else:
        from repro_torch.kernels.flash_attn.ops import flash_attn_fwd
        out = flash_attn_fwd(q, k, v, causal=True, window=window,
                             plain=ctx.kernel_backend == "ref")
    return qlinear(ctx, out.reshape(B, S, cfg.q_dim), p["wo"],
                   subcol(col, "wo"))


def quantize_kv_for_cache(ctx: QuantCtx, p: Dict, k: torch.Tensor,
                          v: torch.Tensor):
    """(B,S,Hkv,D) bf16 -> cache layout (B,Hkv,S,D) + (B,Hkv,S) scales.

    Dynamic policy: per-token absmax int scales. Static policy: the learned
    LSQ scale broadcast per token. C16/off: bf16 storage, unit scales.
    """
    bits = ctx.policy.cache_bits
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if ctx.off or bits >= 16 or ctx.policy.act_dynamic:
        k_q, s_k = cache_quantize(ctx, kt, axis=-1)
        v_q, s_v = cache_quantize(ctx, vt, axis=-1)
        return k_q, v_q, s_k[..., 0], s_v[..., 0]
    s_k = p["s_k"].float().expand(kt.shape[:-1])
    s_v = p["s_v"].float().expand(vt.shape[:-1])
    return (quantize_to_int(kt, s_k[..., None], bits),
            quantize_to_int(vt, s_v[..., None], bits), s_k, s_v)


def _ring_gather(val: torch.Tensor, lengths: torch.Tensor,
                 Sc: int) -> torch.Tensor:
    """Dense ring cache of ``Sc`` rows from prefill K/V ``val``
    (B, Hkv, S, ...): the token at absolute position j lives at ring row
    j % Sc, each row keeps its last min(length, Sc) real tokens, and the
    rest stays zero. Written as a gather (row c reads the one kept token
    j with j % Sc == c), so no out-of-range scatter is needed."""
    B = val.shape[0]
    c = torch.arange(Sc, device=val.device)[None]                  # (1, Sc)
    lo = torch.clamp_min(lengths[:, None] - Sc, 0)                 # (B, 1)
    j = lo + torch.remainder(c - lo, Sc)                           # (B, Sc)
    valid = j < lengths[:, None]
    j = torch.minimum(j, torch.tensor(val.shape[2] - 1, device=val.device))
    idx = j.reshape(B, 1, Sc, *([1] * (val.ndim - 3)))
    idx = idx.expand(B, val.shape[1], Sc, *val.shape[3:])
    out = torch.gather(val, 2, idx)
    keep = valid.reshape(B, 1, Sc, *([1] * (val.ndim - 3)))
    return torch.where(keep, out, torch.zeros_like(out))


def attn_prefill(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
                 rope, *, cache_len: int = 0,
                 lengths: Optional[torch.Tensor] = None,
                 page_size: int = 0):
    """Causal attention over the prompt that also emits the quantized
    dense cache for serving.

    ``lengths`` (B,) marks the valid (right-padded) prefix of each row:
    pad-position K/V are dropped from the cache and ``cache["length"]``
    holds the true per-row length, so one padded prefill call admits
    prompts of different lengths (causality keeps real-token outputs
    independent of the padding).

    ``page_size`` > 0 emits the cache in *block shape* (B, nb, Hkv,
    page_size, D) instead: the paged engine scatters those blocks into
    the global pool through the rows' block ids. The attention is the
    same either way.
    """
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, ctx, p, x, rope)
    out = blockwise_attention(q, k, v, causal=True, q_chunk=1024,
                              kv_chunk=1024)
    y = qlinear(ctx, out.reshape(B, S, cfg.q_dim), p["wo"])
    k_q, v_q, s_k, s_v = quantize_kv_for_cache(ctx, p, k, v)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if page_size:
        cache = _paginate_kv(k_q, v_q, s_k, s_v, page_size)
        cache["length"] = lengths.to(torch.int32, copy=True)
        return y, cache
    Sc = cache_len or S
    cache = {"k_q": _ring_gather(k_q, lengths, Sc),
             "v_q": _ring_gather(v_q, lengths, Sc),
             "s_k": _ring_gather(s_k, lengths, Sc),
             "s_v": _ring_gather(s_v, lengths, Sc),
             # a copy per layer: decode advances each layer's in place
             "length": lengths.to(torch.int32, copy=True)}
    return y, cache


def _paginate_kv(k_q, v_q, s_k, s_v, page_size: int) -> Dict:
    """Cache-layout K/V (B, Hkv, S, D) + scales (B, Hkv, S) -> block shape
    (B, nb, Hkv, page_size, D) / (B, nb, Hkv, page_size); the trailing
    partial block is zero-padded (masked by ``length`` at read and
    overwritten in place by decode)."""
    B, Hkv, S = k_q.shape[0], k_q.shape[1], k_q.shape[2]
    nb = -(-S // page_size)
    pad = nb * page_size - S

    def blk(x):
        widths = [0, 0] * (x.ndim - 3) + [0, pad]     # F.pad: last dim first
        xp = F.pad(x, widths) if pad else x
        xp = xp.reshape((B, Hkv, nb, page_size) + tuple(x.shape[3:]))
        return xp.movedim(2, 1)                      # (B, nb, Hkv, bs, ...)

    return {"k_q": blk(k_q), "v_q": blk(v_q),
            "s_k": blk(s_k), "s_v": blk(s_v)}


def _blank_attn_cache(B: int, cfg: ModelConfig, S: int, qdtype,
                      device) -> Dict:
    hd = cfg.resolved_head_dim
    kw = {"device": device}
    return {
        "k_q": torch.zeros((B, cfg.n_kv_heads, S, hd), dtype=qdtype, **kw),
        "v_q": torch.zeros((B, cfg.n_kv_heads, S, hd), dtype=qdtype, **kw),
        "s_k": torch.zeros((B, cfg.n_kv_heads, S), dtype=torch.float32, **kw),
        "s_v": torch.zeros((B, cfg.n_kv_heads, S), dtype=torch.float32, **kw),
        "length": torch.zeros((B,), dtype=torch.int32, **kw),
    }


def init_attn_cache(cfg: ModelConfig, B: int, S: int, *, device,
                    dtype=torch.int8) -> Dict:
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window ring caches are not ported")
    return _blank_attn_cache(B, cfg, S, dtype, device)


def init_paged_attn_cache(cfg: ModelConfig, B: int, num_blocks: int,
                          page_size: int, *, layers: int, device,
                          dtype=torch.int8):
    """Global block pools of ``layers`` attention layers: ``num_blocks``
    blocks of ``page_size`` tokens, shared by every slot through the block
    table, plus the sink block. Each leaf is one layer-stacked tensor
    (layers, num_blocks + 1, Hkv, page_size[, D]), so one copy launch per
    leaf clones a block in every layer.

    Returns (pool, per-layer caches): the stacked leaves, and one dict per
    layer holding views of them and the layer's per-slot ``length``.
    """
    hd = cfg.resolved_head_dim
    shape = (layers, num_blocks + 1, cfg.n_kv_heads, page_size)
    kw = {"device": device}
    pool = {"k_q": torch.zeros(shape + (hd,), dtype=dtype, **kw),
            "v_q": torch.zeros(shape + (hd,), dtype=dtype, **kw),
            "s_k": torch.zeros(shape, dtype=torch.float32, **kw),
            "s_v": torch.zeros(shape, dtype=torch.float32, **kw)}
    return pool, paged_layer_views(pool, B)


def paged_layer_views(pool: Dict, B: int,
                      lengths: Optional[list] = None) -> list:
    """Per-layer cache dicts over the stacked pool leaves: views of each
    leaf's layer row, and a per-slot ``length`` (zeros, or ``lengths``)."""
    n = next(iter(pool.values())).shape[0]
    dev = next(iter(pool.values())).device
    return [{**{k: pool[k][i] for k in POOL_KEYS},
             "length": (torch.zeros((B,), dtype=torch.int32, device=dev)
                        if lengths is None else lengths[i])}
            for i in range(n)]


def attn_decode(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x1: torch.Tensor,
                cache: Dict, positions: torch.Tensor,
                block_tbl: Optional[torch.Tensor] = None, rope=None):
    """One-token decode step. x1: (B, 1, d). Returns (y1, cache).

    Dense layout: writes the new K/V row of every slot into ``cache`` in
    place (ring row ``length % Sc``), advances ``cache["length"]`` and
    attends over the first min(length, Sc) rows.

    ``block_tbl`` (B, T) switches to the paged layout: the commit goes
    through the slot's table into the pool, and a slot whose entry is the
    sentinel (a parked slot) writes into the sink block, which nothing
    reads. Attention walks the table.

    ``rope``: the step's (cos, sin) tables at ``positions``, computed once
    per step by the caller; made here when not given.
    """
    B = x1.shape[0]
    hd = cfg.resolved_head_dim
    if rope is None and cfg.rope_theta:
        rope = rope_tables(positions[:, None], hd, cfg.rope_theta)
    q, k, v = _qkv(cfg, ctx, p, x1, rope)
    k_q1, v_q1, s_k1, s_v1 = quantize_kv_for_cache(ctx, p, k, v)
    if block_tbl is not None:
        bs = cache["k_q"].shape[2]
        T = block_tbl.shape[1]
        pos = cache["length"].long()                 # tokens written so far
        blk = torch.gather(block_tbl.long(), 1,
                           torch.clamp_max(pos // bs, T - 1)[:, None])[:, 0]
        blk = torch.clamp(blk, 0, pool_blocks(cache["k_q"]))
        off = pos % bs
        cache["k_q"][blk, :, off] = k_q1[:, :, 0]
        cache["v_q"][blk, :, off] = v_q1[:, :, 0]
        cache["s_k"][blk, :, off] = s_k1[:, :, 0]
        cache["s_v"][blk, :, off] = s_v1[:, :, 0]
        cache["length"] += 1
        out = _decode_attn_paged(ctx, q[:, 0], cache["k_q"], cache["v_q"],
                                 cache["s_k"], cache["s_v"], block_tbl,
                                 cache["length"])
        y = qlinear(ctx, out.reshape(B, cfg.q_dim), p["wo"])
        return y[:, None], cache
    Sc = cache["k_q"].shape[2]
    slot = torch.remainder(cache["length"], Sc).long()
    bidx = torch.arange(B, device=x1.device)
    cache["k_q"][bidx, :, slot] = k_q1[:, :, 0]
    cache["v_q"][bidx, :, slot] = v_q1[:, :, 0]
    cache["s_k"][bidx, :, slot] = s_k1[:, :, 0]
    cache["s_v"][bidx, :, slot] = s_v1[:, :, 0]
    cache["length"] += 1
    out = _decode_attn(ctx, q[:, 0], cache["k_q"], cache["v_q"],
                       cache["s_k"], cache["s_v"],
                       torch.clamp_max(cache["length"], Sc))
    y = qlinear(ctx, out.reshape(B, cfg.q_dim), p["wo"])
    return y[:, None], cache


def attn_chunk_prefill(cfg: ModelConfig, ctx: QuantCtx, p: Dict,
                       x: torch.Tensor, rope, cache: Dict,
                       tbl: torch.Tensor, slot: torch.Tensor,
                       offset: torch.Tensor, chunk_len: torch.Tensor,
                       hist_rows: Optional[list] = None):
    """One window of an incremental (chunked or prefix-hit tail) prefill
    for a batch of slots with per-row offsets, on the paged pool.

    x (n, C, d): row i is a window of one slot's prompt whose first token
    sits at absolute position ``offset[i]``; its first ``chunk_len[i]``
    positions are real, the rest padding. Every row is a real slot
    (``slot`` holds valid slot ids). Queries attend to the ``offset[i]``
    tokens already in the pool (gathered through ``tbl[i]`` and
    dequantized by ``gather_dequant_paged_kv``, as decode reads them)
    plus the window itself (causal, exact bf16 K/V); that softmax over
    ``Lh + C`` keys is plain torch, as the reference leaves it to XLA.
    The window's K/V are then quantized and committed through the table
    in place (``commit_chunk_kv``), and ``length[slot]`` moves to
    ``offset + chunk_len``. The engine has grown each table to cover the
    window and resolved copy-on-write for shared blocks in the write range
    before the call, so the commit lands only in blocks the row owns.

    ``hist_rows`` (host ints, one per row) is each row's own history
    extent in blocks, the one the row would get in a wave of its own. On
    CUDA it makes each row's result independent of what else rides the
    wave; elsewhere, and without it, the wave is computed in one batch
    over ``tbl``'s width, as in the reference.
    """
    from repro_torch.kernels.kvq_attn.ops import (commit_chunk_kv,
                                                  gather_dequant_paged_kv)
    n, C, _ = x.shape
    q, k, v = _qkv(cfg, ctx, p, x, rope)
    bs = cache["k_q"].shape[2]
    kh = gather_dequant_paged_kv(cache["k_q"], cache["s_k"], tbl)
    vh = gather_dequant_paged_kv(cache["v_q"], cache["s_v"], tbl)
    if x.is_cuda and hist_rows is not None:
        # one row at a time over its own history extent: cuBLAS picks a
        # batched GEMM's kernel from the batch count and the key length,
        # so a row computed inside a wave (whose extent the deepest row
        # sets) could differ in the last bits from the same row alone
        out = torch.cat([_window_attention(
            cfg, q[i:i + 1], k[i:i + 1], v[i:i + 1],
            kh[i:i + 1, :, :hist_rows[i] * bs],
            vh[i:i + 1, :, :hist_rows[i] * bs], offset[i:i + 1],
            chunk_len[i:i + 1]) for i in range(n)])
    else:
        out = _window_attention(cfg, q, k, v, kh, vh, offset, chunk_len)
    y = qlinear(ctx, out.reshape(n, C, cfg.q_dim).to(x.dtype), p["wo"])
    k_q1, v_q1, s_k1, s_v1 = quantize_kv_for_cache(ctx, p, k, v)
    commit_chunk_kv(cache, k_q1, v_q1, s_k1, s_v1, tbl, offset, chunk_len)
    cache["length"][slot.long()] = (offset + chunk_len).to(torch.int32)
    return y, cache


def _window_attention(cfg: ModelConfig, q, k, v, kh, vh, offset,
                      chunk_len) -> torch.Tensor:
    """Softmax attention of a batch of windows q/k/v (n, C, H|Hkv, D) over
    their dequantized history kh/vh (n, Hkv, Lh, D) plus the window
    itself. History key j is valid iff j < offset (allocated but unwritten
    positions hold stale data); window key j is causal and masked past
    chunk_len. Returns (n, C, H, D) f32."""
    C = q.shape[1]
    Lh = kh.shape[2]
    dev = q.device
    kall = torch.cat([kh.transpose(1, 2), k.float()], dim=1)
    vall = torch.cat([vh.transpose(1, 2), v.float()], dim=1)
    group = cfg.n_heads // cfg.n_kv_heads
    if group > 1:
        kall = torch.repeat_interleave(kall, group, dim=2)
        vall = torch.repeat_interleave(vall, group, dim=2)
    scale = cfg.resolved_head_dim ** -0.5
    scores = torch.einsum("bqhd,bkhd->bqhk", q.float() * scale, kall)
    kj = torch.arange(Lh + C, device=dev)
    qi = torch.arange(C, device=dev)
    hist = kj < Lh
    kpos = torch.where(hist, kj, kj - Lh)[None, None, :]
    mask = torch.where(hist[None, None, :],
                       kpos < offset.long()[:, None, None],
                       (kpos <= qi[None, :, None])
                       & (kpos < chunk_len.long()[:, None, None]))
    mask4 = mask[:, :, None, :]
    scores = torch.where(mask4, scores, torch.full_like(scores, _NEG))
    pr = torch.softmax(scores, dim=-1)
    pr = torch.where(mask4, pr, torch.zeros_like(pr))
    return torch.einsum("bqhk,bkhd->bqhd", pr, vall)


def attn_spec_verify(cfg: ModelConfig, ctx: QuantCtx, p: Dict,
                     x: torch.Tensor, rope, cache: Dict, tbl: torch.Tensor,
                     slot: torch.Tensor, offset: torch.Tensor,
                     chunk_len: torch.Tensor):
    """One attention layer of the speculative verify-wave.

    The batched-window contract of :func:`attn_chunk_prefill`: x (n, C, d)
    holds one slot's window ``[last_token, draft_1..draft_k]`` per row,
    committed through the table at per-row offsets (``commit_chunk_kv``).
    The numerics are decode's, not prefill's: the window's K/V are
    quantized and committed to the pool first, and every window position
    then reads the pool back through the table, as the ``k + 1``
    sequential decode steps it replaces would. Position j attends to
    ``offset + j + 1`` tokens; positions at or past ``chunk_len`` commit
    into the sink and their outputs are discarded by the engine. The
    caller rolls the rejected suffix back (device counters and
    ``BlockAllocator.trim``) and has grown the table and resolved
    copy-on-write for ``[offset, offset + chunk_len)`` before the call.

    Returns (y (n, C, d), cache) with ``length[slot]`` at
    ``offset + chunk_len``.
    """
    from repro_torch.kernels.kvq_attn.ops import commit_chunk_kv
    n, C, _ = x.shape
    q, k, v = _qkv(cfg, ctx, p, x, rope)
    k_q1, v_q1, s_k1, s_v1 = quantize_kv_for_cache(ctx, p, k, v)
    commit_chunk_kv(cache, k_q1, v_q1, s_k1, s_v1, tbl, offset, chunk_len)
    cache["length"][slot.long()] = (offset + chunk_len).to(torch.int32)
    # per-query extent: the history plus the window through the query
    lens = (offset[:, None] + 1
            + torch.arange(C, device=x.device)[None]).to(torch.int32)
    out = _spec_verify_attn(ctx, q, cache["k_q"], cache["v_q"],
                            cache["s_k"], cache["s_v"], tbl, lens)
    y = qlinear(ctx, out.reshape(n, C, cfg.q_dim).to(x.dtype), p["wo"])
    return y, cache
