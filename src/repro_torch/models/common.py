"""Shared model components: norms, the GELU, rotary embeddings (standard
and M-RoPE), chunked attention.

Prefill attention is blockwise (online softmax over key chunks), so a long
prompt never materializes an S x S score matrix. The softmax output is not
quantized (paper §3.2: it is encapsulated by the attention kernel).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

_NEG = -1e30


# --------------------------------------------------------------------------
# Norms (never quantized, per the paper)
# --------------------------------------------------------------------------

_NORM_SPLIT = 16         # first-stage partial sums per row (CUDA path)
_XLA_WINDOW = 32         # XLA:CPU's tree-reduction window


def _xla_cpu_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in XLA:CPU's order, f32, bitwise.

    XLA's CPU compiler rewrites a reduction over more than 32 elements
    into a reduce-window of size and stride 32 followed by a reduction of
    the window sums, recursively: the row is zero-padded to a multiple of
    32 (``pad // 2`` zeros in front, the rest behind), each window is
    summed element by element in order from 0, and the window sums are
    reduced the same way. Here the same adds in the same order, one
    elementwise add per window position.
    """
    n = x.shape[-1]
    while n > _XLA_WINDOW:
        pad = -n % _XLA_WINDOW
        if pad:
            x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, _XLA_WINDOW)
        n = x.shape[-2]
        s = x[..., 0]
        for i in range(1, _XLA_WINDOW):
            s = s + x[..., i]
        x = s
    s = x[..., 0]
    for i in range(1, n):
        s = s + x[..., i]
    return s


def _row_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim, keepdim, f32.

    On the CPU the row is summed in XLA:CPU's order
    (:func:`_xla_cpu_row_sum`), so a norm's mean and variance are bitwise
    the reference's run op by op at every width (``torch.mean`` sums with
    4 accumulators of 8 lanes, which disagrees with it on about half of
    random rows). torch's CUDA reduction picks its block shape, and so
    each row's summation order, from the number of rows (a verify-wave
    runs every norm at M = slots * (k + 1) rows, a decode step at M =
    slots), which moves the last bit of the sum. There the row is summed
    in two stages whose shapes do not depend on M: ``_NORM_SPLIT``
    partial sums per row over a (rows * split, d / split) view, then the
    partials, so a row's result is the same in any batch.
    """
    d = v.shape[-1]
    if not v.is_cuda:
        return (_xla_cpu_row_sum(v) / d)[..., None]
    if d % _NORM_SPLIT:
        return torch.mean(v, dim=-1, keepdim=True)
    part = v.reshape(-1, d // _NORM_SPLIT).sum(dim=-1)
    return (part.reshape(-1, _NORM_SPLIT).sum(dim=-1) / d).reshape(
        *v.shape[:-1], 1)


def _mean_sq(xf: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last dim, keepdim, f32
    (:func:`_row_mean`'s order)."""
    return _row_mean(xf * xf)


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    """f32 1/sqrt(v). On the CPU the correctly rounded value (an f64
    rsqrt rounded to f32): XLA:CPU lowers ``rsqrt`` to the x86 estimate
    refined by a Newton step, whose bits are the processor's, so no
    portable op sequence reproduces it; it lies within one ulp of the
    correctly rounded value and equals it on 86% of random inputs, where
    ``torch.rsqrt`` (a rounded 1/sqrt) equals it on 64%."""
    if v.is_cuda:
        return torch.rsqrt(v)
    return torch.rsqrt(v.double()).float()


def rms_norm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = _mean_sq(xf)
    y = xf * _rsqrt(var + eps)
    return (y * p["w"].float()).to(x.dtype)


def layer_norm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in the reference's op order: the mean, then ``jnp.var``
    (the mean again, the centred values squared, their mean), then
    ``(x - mean) * rsqrt(var + eps) * w + b``. Both means sum as
    :func:`_row_mean` does (bitwise on the CPU); the rsqrt is
    :func:`_rsqrt`'s (within one ulp of XLA:CPU's)."""
    xf = x.float()
    mu = _row_mean(xf)
    c = xf - mu
    var = _row_mean(c * c)
    y = c * _rsqrt(var + eps)
    return (y * p["w"].float() + p["b"].float()).to(x.dtype)


def norm(x: torch.Tensor, p: Dict, kind: str, eps: float) -> torch.Tensor:
    """``kind`` "rms" (:func:`rms_norm`) or "ln" (:func:`layer_norm`)."""
    return rms_norm(x, p, eps) if kind == "rms" else layer_norm(x, p, eps)


def init_norm(d: int, device, dtype=torch.bfloat16, kind: str = "rms") -> Dict:
    p = {"w": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        p["b"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def head_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """qk_norm: RMS over head_dim (x: (..., H, D)), the variance summed as
    :func:`rms_norm`'s."""
    xf = x.float()
    var = _mean_sq(xf)
    return (xf * _rsqrt(var + eps) * w.float()).to(x.dtype)


# --------------------------------------------------------------------------
# GELU (the tanh approximation, ``jax.nn.gelu``'s default) and the f32
# transcendentals of XLA:CPU it needs on the CPU. XLA:CPU evaluates tanh
# (and exp, log, log1p: ``recurrent.py``) with its own polynomials (Eigen's
# and Cephes'), FMA contracted; torch's CPU functions round up to a few
# ulps apart. So CPU tensors take the polynomials (an FMA is the f64
# product and sum rounded to f32: the product is exact in f64), and CUDA
# tensors torch's own functions.
# --------------------------------------------------------------------------

def _c(*vals):
    """Constants rounded to f32, as the reference's f32 code holds them."""
    out = tuple(float(torch.tensor(v, dtype=torch.float32)) for v in vals)
    return out if len(out) > 1 else out[0]


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once (b, c: f32 tensors or f32 constants)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


_TANH_NUM = _c(-2.76076847742355e-16, 2.00018790482477e-13,
               -8.60467152213735e-11, 5.12229709037114e-08,
               1.48572235717979e-05, 6.37261928875436e-04,
               4.89352455891786e-03)
_TANH_DEN = _c(1.19825839466702e-06, 1.18534705686654e-04,
               2.26843463243900e-03, 4.89352518554385e-03)
_TANH_CLAMP, _TANH_SMALL = _c(7.99881172180175781, 0.0004)


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 tanh; on the CPU XLA:CPU's rational approximation."""
    if x.is_cuda:
        return torch.tanh(x)
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    num = torch.full_like(x2, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        num = _fma(x2, num, c)
    num = xc * num
    den = torch.full_like(x2, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        den = _fma(x2, den, c)
    return torch.where(torch.abs(x) < _TANH_SMALL, x, num / den)


_SQRT_2_OVER_PI = float(torch.tensor((2 / torch.pi) ** 0.5,
                                     dtype=torch.float32))


def _gelu(x: torch.Tensor, tanh: Callable = torch.tanh) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation) in its op order, f32; pass
    ``tanh=_tanh`` for XLA:CPU's tanh on the CPU. (``F.gelu(approximate=
    "tanh")`` is not bitwise with it.)"""
    x3 = x * (x * x)
    cdf = 0.5 * (1.0 + tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x3)))
    return x * cdf


# --------------------------------------------------------------------------
# Rotary position embeddings (standard and M-RoPE)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """The (head_dim/2,) f32 rotary frequencies ``theta ** (-i / half)``,
    as an f64 power of the f32 exponents rounded to f32: bitwise equal to
    XLA's f32 power, where torch's f32 ``pow`` misses a few."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float64, device=device),
                     exps.double()).float()


# The f32 sin/cos that XLA:CPU computes (the reference's tables) are
# glibc's sinf/cosf (ARM's optimized-routines algorithm): the argument
# reduced by pi/2 in f64 (Payne-Hanek on the bits of 2/pi from 120 up),
# then a short f64 polynomial, rounded to f32. They are not the correctly
# rounded values (0.56 ulp at worst), so an f64 cos rounded to f32 misses
# some. Here the same f64 and 64-bit integer arithmetic, op by op.
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")     # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p+0")          # pi/2
_PI63 = float.fromhex("0x1.921fb54442d18p-62")        # pi/2 * 2^-62
_COS = tuple(map(float.fromhex, (
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")))
_SIN = tuple(map(float.fromhex, (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13")))
# 2/pi's bits in 32-bit windows stepping by 8 bits
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
             0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
             0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
             0x95993c43, 0x993c4390, 0x3c439041)
_TOP_PIO4, _TOP_TINY, _TOP_120 = 0x3f4, 0x398, 0x42f   # |y|'s top 12 bits


def _poly(x: torch.Tensor, x2: torch.Tensor, cos: torch.Tensor,
          neg: torch.Tensor) -> torch.Tensor:
    """sin (``cos`` False) or cos polynomial of the reduced f64 argument;
    ``neg`` flips the cos coefficients (quadrants 2 and 3)."""
    x3 = x * x2
    sin_v = (x + x3 * _SIN[0]) + (x3 * x2) * (_SIN[1] + x2 * _SIN[2])
    sg = torch.where(neg, -1.0, 1.0).double()
    x4 = x2 * x2
    c = (sg * _COS[0] + x2 * (sg * _COS[1])) + x4 * (sg * _COS[2])
    cos_v = c + (x4 * x2) * (sg * _COS[3] + x2 * (sg * _COS[4]))
    return torch.where(cos, cos_v, sin_v)


def sincosf(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin(y), cos(y)) of an f32 tensor, bitwise as glibc's sinf/cosf
    (and so XLA:CPU's ``jnp.sin``/``jnp.cos``) for finite y."""
    x = y.double()
    bits = y.view(torch.int32).long() & 0xFFFFFFFF
    top = (bits >> 20) & 0x7FF
    # |y| < 120: n = round(y * 2/pi) via a 2^24-scaled truncation
    n_f = (torch.trunc(x * _HPI_INV).long() + 0x800000) >> 24
    x_f = x - n_f.double() * _HPI
    # |y| >= 120: the mantissa times 96 bits of 2/pi, in 64-bit integers
    # (int64 wraps as glibc's uint64_t does; only the bit pattern counts)
    tbl = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    idx = (bits >> 26) & 15
    m = ((bits & 0xFFFFFF) | 0x800000) << ((bits >> 23) & 7)
    res0 = (m * tbl[idx]) & 0xFFFFFFFF
    res2 = m * tbl[idx + 8]
    res0 = ((res2 >> 32) | (res0 << 32)) + m * tbl[idx + 4]
    n_l = ((res0 + (1 << 61)) >> 62) & 3
    x_l = (res0 - (n_l << 62)).double() * _PI63
    fast = top < _TOP_120
    n = torch.where(fast, n_f, n_l)
    q = torch.where(fast, n_f, n_l + (bits >> 31)) & 3   # sign quadrant
    xr = torch.where(fast, x_f, x_l)
    xs = xr * torch.where((q == 1) | (q == 2), -1.0, 1.0).double()
    x2 = xr * xr
    odd, neg = (n & 1) == 1, (q & 2) == 2
    sin_v = _poly(xs, x2, odd, neg)
    cos_v = _poly(xs, x2, ~odd, neg)
    small = top < _TOP_PIO4
    fals = torch.zeros_like(odd)
    sin_v = torch.where(small, _poly(x, x * x, fals, fals), sin_v)
    cos_v = torch.where(small, _poly(x, x * x, ~fals, fals), cos_v)
    tiny = top < _TOP_TINY
    return (torch.where(tiny, x, sin_v).float(),
            torch.where(tiny, torch.ones_like(x), cos_v).float())


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin tables (..., S, head_dim/2).

    The angles are f32 products as in the reference, and their cos and
    sin are glibc's f32 values (:func:`sincosf`), bitwise equal to the
    reference's tables.
    """
    freqs = rope_freqs(head_dim, theta, positions.device)
    sin, cos = sincosf(positions.float()[..., None] * freqs)
    return cos, sin


def mrope_tables(positions3: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal rotary (Qwen2-VL): three position streams (t, h, w)
    own interleaved thirds of the frequency spectrum, frequency i taking
    stream i % 3, as the reference splits them (not Qwen2-VL's published
    contiguous sections).

    positions3 (3, B, S) -> cos/sin (B, S, head_dim/2). The angles are
    the f32 products of :func:`rope_tables` and their sin and cos
    :func:`sincosf`'s, bitwise the reference's tables.
    """
    half = head_dim // 2
    freqs = rope_freqs(head_dim, theta, positions3.device)
    ang_all = positions3.float()[..., None] * freqs          # (3, B, S, half)
    sect = torch.arange(half, device=positions3.device) % 3
    ang = torch.gather(ang_all.movedim(0, -1), -1,
                       sect.view(1, 1, half, 1).expand(
                           *ang_all.shape[1:], 1))[..., 0]
    sin, cos = sincosf(ang)
    return cos, sin


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
