"""Plain PyTorch version of quantized-KV-cache decode attention.

One new query token per sequence attends over an integer-quantized cache.

Shapes:
    q:   (B, H, D)      bf16/fp32
    k_q: (B, Hkv, S, D) int8
    v_q: (B, Hkv, S, D) int8
    s_k, s_v: (B, Hkv, S) fp32 per-token cache scales
    lengths: (B,) int32 valid prefix of the cache
Returns (B, H, D) in q.dtype.
"""
from __future__ import annotations

import torch


def kvq_decode_attn_ref(q, k_q, v_q, s_k, s_v, lengths):
    B, H, D = q.shape
    Hkv, S = k_q.shape[1], k_q.shape[2]
    group = H // Hkv
    qf = q.float().reshape(B, Hkv, group, D)
    k = k_q.float() * s_k[..., None].float()
    v = v_q.float() * s_v[..., None].float()
    scores = torch.einsum("bngd,bnsd->bngs", qf, k) / torch.sqrt(
        torch.tensor(float(D), dtype=torch.float32))
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    p = p * mask
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-20)
    out = torch.einsum("bngs,bnsd->bngd", p, v)
    return out.reshape(B, H, D).to(q.dtype)
