"""Transformer blocks of the dense GQA decoder: attention with a quantized
KV cache and the SwiGLU MLP, with SiLQ quantization sites (paper Fig. 2):

* every linear: input A-bits (``s_in``), weight W-bits per-out-channel (``s_w``)
* query into QK^T: 16-bit (``s_q``)
* K/V written to cache: C-bits (``s_k``/``s_v``)

Caches are updated in place: the engine owns one cache per layer for its
whole life, and a decode step writes its new K/V row into it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qat import (QuantCtx, cache_quantize, init_linear,
                                  qlinear, quantize_act)
from repro_torch.core.quantizer import quantize_to_int
from repro_torch.models.common import (apply_rope, blockwise_attention,
                                       decode_attention_intcache,
                                       head_rms_norm, rope_tables)


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


def mlp_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict,
            x: torch.Tensor) -> torch.Tensor:
    g = qlinear(ctx, x, p["wg"])
    u = qlinear(ctx, x, p["wu"])
    h = F.silu(g.float()).to(x.dtype) * u
    return qlinear(ctx, h, p["wd"])


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


def _qkv(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor, rope):
    hd = cfg.resolved_head_dim
    B, S = x.shape[0], x.shape[1]
    q = qlinear(ctx, x, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = qlinear(ctx, x, p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = qlinear(ctx, x, p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = head_rms_norm(q, p["q_norm"]["w"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"]["w"], cfg.norm_eps)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    # paper sites: query INT16, cache C-bits
    q = quantize_act(ctx, q, p, "s_q")
    k = quantize_act(ctx, k, p, "s_k")
    v = quantize_act(ctx, v, p, "s_v")
    return q, k, v


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
                 lengths: Optional[torch.Tensor] = None):
    """Causal attention over the prompt that also emits the quantized
    dense cache for serving.

    ``lengths`` (B,) marks the valid (right-padded) prefix of each row:
    pad-position K/V are dropped from the cache and ``cache["length"]``
    holds the true per-row length, so one padded prefill call admits
    prompts of different lengths (causality keeps real-token outputs
    independent of the padding).
    """
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, ctx, p, x, rope)
    out = blockwise_attention(q, k, v, causal=True, q_chunk=1024,
                              kv_chunk=1024)
    y = qlinear(ctx, out.reshape(B, S, cfg.q_dim), p["wo"])
    k_q, v_q, s_k, s_v = quantize_kv_for_cache(ctx, p, k, v)
    Sc = cache_len or S
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    cache = {"k_q": _ring_gather(k_q, lengths, Sc),
             "v_q": _ring_gather(v_q, lengths, Sc),
             "s_k": _ring_gather(s_k, lengths, Sc),
             "s_v": _ring_gather(s_v, lengths, Sc),
             # a copy per layer: decode advances each layer's in place
             "length": lengths.to(torch.int32, copy=True)}
    return y, cache


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


def attn_decode(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x1: torch.Tensor,
                cache: Dict, positions: torch.Tensor):
    """One-token decode step on the dense ring cache. x1: (B, 1, d).

    Writes the new K/V row of every slot into ``cache`` in place (ring row
    ``length % Sc``), advances ``cache["length"]`` and attends over the
    first min(length, Sc) rows. Returns (y1, cache).
    """
    B = x1.shape[0]
    hd = cfg.resolved_head_dim
    rope = None
    if cfg.rope_theta:
        rope = rope_tables(positions[:, None], hd, cfg.rope_theta)
    q, k, v = _qkv(cfg, ctx, p, x1, rope)
    k_q1, v_q1, s_k1, s_v1 = quantize_kv_for_cache(ctx, p, k, v)
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
