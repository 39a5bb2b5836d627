"""Plain PyTorch version of the flash-attention forward kernel.

Dense causal / sliding-window GQA attention with the kernel's numerics: q
pre-scaled by ``D**-0.5`` in f32, f32 scores, masked scores at -1e30 and
their probabilities at 0, the unnormalised probabilities rounded to bf16
for P.V with f32 sums, and ``acc / max(l, 1e-20)``. The op sequence is
that of ``models.common.blockwise_attention`` with one query chunk and one
key chunk, so for sequences within one chunk (1024) the two agree
bitwise on the CPU.
"""
from __future__ import annotations

import torch

_NEG = -1e30


def flash_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,D); k/v (B,Skv,Hkv,D) -> (B,S,H,D) in q.dtype."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    dev = q.device
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    qs = q.float() * D ** -0.5
    s_ = torch.einsum("bqhd,bkhd->bqhk", qs, k.float())
    qpos = torch.arange(S, device=dev)
    kpos = torch.arange(Skv, device=dev)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    mask4 = mask[None, :, None, :]
    s_ = torch.where(mask4, s_, torch.full_like(s_, _NEG))
    m = torch.amax(s_, dim=-1)
    p = torch.exp(s_ - m[..., None])
    p = torch.where(mask4, p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bqhk,bkhd->bqhd", p.to(torch.bfloat16).float(),
                       v.to(torch.bfloat16).float())
    return (acc / torch.clamp_min(l[..., None], 1e-20)).to(q.dtype)
