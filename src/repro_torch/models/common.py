"""Shared model components: norms, rotary embeddings, chunked attention.

Prefill attention is blockwise (online softmax over key chunks), so a long
prompt never materializes an S x S score matrix. The softmax output is not
quantized (paper §3.2: it is encapsulated by the attention kernel).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_NEG = -1e30


# --------------------------------------------------------------------------
# Norms (never quantized, per the paper)
# --------------------------------------------------------------------------

_NORM_SPLIT = 16         # first-stage partial sums per row (CUDA path)


def _mean_sq(xf: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last dim, keepdim, f32.

    On the CPU one ``torch.mean``: its per-row order is fixed, and it
    matches the reference's op by op. torch's CUDA reduction picks its
    block shape, and so each row's summation order, from the number of
    rows (a verify-wave runs every norm at M = slots * (k + 1) rows, a
    decode step at M = slots), which moves the last bit of the variance.
    There the row is summed in two stages whose shapes do not depend on
    M: ``_NORM_SPLIT`` partial sums per row over a (rows * split, d /
    split) view, then the partials, so a row's result is the same in any
    batch.
    """
    d = xf.shape[-1]
    if not xf.is_cuda or d % _NORM_SPLIT:
        return torch.mean(xf * xf, dim=-1, keepdim=True)
    sq = (xf * xf).reshape(-1, d // _NORM_SPLIT)
    part = sq.sum(dim=-1).reshape(-1, _NORM_SPLIT)
    return (part.sum(dim=-1) / d).reshape(*xf.shape[:-1], 1)


def rms_norm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = _mean_sq(xf)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["w"].float()).to(x.dtype)


def init_norm(d: int, device, dtype=torch.bfloat16) -> Dict:
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


def head_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """qk_norm: RMS over head_dim (x: (..., H, D))."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """The (head_dim/2,) f32 rotary frequencies ``theta ** (-i / half)``,
    as an f64 power of the f32 exponents rounded to f32: bitwise equal to
    XLA's f32 power, where torch's f32 ``pow`` misses a few."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float64, device=device),
                     exps.double()).float()


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin tables (..., S, head_dim/2).

    The angles are f32 products as in the reference. Their ``cos`` and
    ``sin`` are taken in f64 and rounded to f32, which lands nearer XLA's
    f32 ``cos``/``sin`` than torch's f32 ones; the entries that still
    differ are counted in ``tests/test_torch_models.py``.
    """
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = (positions.float()[..., None] * freqs).double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Blockwise (flash-style) attention for prefill
# --------------------------------------------------------------------------

def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_chunk: int = 1024, kv_chunk: int = 1024,
                        q_offset: int = 0,
                        p_dtype=torch.bfloat16) -> torch.Tensor:
    """Online-softmax attention, O(S * chunk) memory.

    q: (B, S, H, D); k/v: (B, Skv, Hkv, D) — GQA by head repeat (query
    head h reads KV head h // group). ``window`` > 0 restricts attention
    to the last ``window`` positions. ``q_offset`` shifts query positions.
    Scores and the running max / denominator / accumulator are f32; the
    probabilities meet V in ``p_dtype`` (bf16), as in the reference.
    """
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, Skv)
    nq, nk = -(-S // q_chunk), -(-Skv // kv_chunk)
    scale = D ** -0.5
    dev = q.device
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    outs = []
    for qi in range(nq):
        q_i = q[:, qi * q_chunk:(qi + 1) * q_chunk].float() * scale
        qc = q_i.shape[1]
        qpos = q_offset + qi * q_chunk + torch.arange(qc, device=dev)
        m = torch.full((B, qc, H), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, qc, H), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, qc, H, D), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_j = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            v_j = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            kpos = ki * kv_chunk + torch.arange(k_j.shape[1], device=dev)
            s_ = torch.einsum("bqhd,bkhd->bqhk", q_i, k_j.float())
            mask = torch.ones((qc, k_j.shape[1]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window:
                mask &= qpos[:, None] - kpos[None, :] < window
            mask4 = mask[None, :, None, :]
            s_ = torch.where(mask4, s_, torch.full_like(s_, _NEG))
            m_new = torch.maximum(m, torch.amax(s_, dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            p = torch.where(mask4, p, torch.zeros_like(p))
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            # p and v round to p_dtype; their products and sums stay f32
            pv = torch.einsum("bqhk,bkhd->bqhd", p.to(p_dtype).float(),
                              v_j.to(p_dtype).float())
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-20))
    return torch.cat(outs, dim=1).to(q.dtype)


# --------------------------------------------------------------------------
# Decode attention over an integer-quantized cache (plain path)
# --------------------------------------------------------------------------

def decode_attention_intcache(q: torch.Tensor, k_q: torch.Tensor,
                              v_q: torch.Tensor, s_k: torch.Tensor,
                              s_v: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Single-token attention against an int8 cache; the per-token scales
    fold into the score and probability tensors (the reference's op
    order), so no dequantized K/V copy is formed.

    q (B,H,D); k_q/v_q (B,Hkv,S,D) int8; s_k/s_v (B,Hkv,S); lengths (B,).
    """
    B, H, D = q.shape
    Hkv, S = k_q.shape[1], k_q.shape[2]
    group = H // Hkv
    qf = q.float().reshape(B, Hkv, group, D) * (D ** -0.5)
    scores = torch.einsum("bngd,bnsd->bngs", qf, k_q.float())
    scores = scores * s_k[:, :, None, :].float()
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    ps = p * s_v[:, :, None, :].float()
    out = torch.einsum("bngs,bnsd->bngd", ps, v_q.float())
    return out.reshape(B, H, D).to(q.dtype)
