"""Recurrent blocks of the xLSTM family: mLSTM (matrix memory, chunked
parallel form) and sLSTM (scalar memory, sequential scan).

SiLQ sites as in the reference: every projection / gate linear carries
A-bit input and W4 per-channel weight quantizers, the recurrences run in
f32, and the recurrent state stored for serving is the cache analogue,
quantized to C bits (``state_q`` + scale). mLSTM also quantizes its
query, key and value (``s_q``/``s_k``/``s_v``) and both blocks their
hidden state (``s_state``).

The mLSTM input gate is a sigmoid, as the reference documents (its chunked
algebra is exact for the gates used). sLSTM routes its recurrence in one
place, :func:`slstm_fwd`: a forward with quantization off and no gradient
(the QAT teacher, evaluation) runs the ``slstm_scan`` kernel in its
``carry="gx"`` mode, every other forward the per-step cell. Both compute
the reference's cell: h carried in gx's dtype, ``h . r_h`` rounded to it
and added to gx in it, the gates and c in f32.

Serving caches are updated in place by the decode functions, as the
attention caches are.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qat import (QuantCtx, cache_quantize, init_linear,
                                  qlinear, quantize_act, quantize_weight_p,
                                  subcol)
from repro_torch.core.quantizer import dequantize_int

MLSTM_CHUNK = 256


def _scalar(dev) -> torch.Tensor:
    return torch.tensor(1.0, dtype=torch.float32, device=dev)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``'s op sequence: -logaddexp(-x, 0)."""
    nx = -x
    return -(torch.clamp_min(nx, 0.0)
             + torch.log1p(torch.exp(-torch.abs(nx))))


_SQRT_2_OVER_PI = float(torch.tensor((2 / torch.pi) ** 0.5,
                                     dtype=torch.float32))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation) in its op order, f32."""
    x3 = x * (x * x)
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x3)))
    return x * cdf


_SCAN_BASE = 16          # XLA:CPU's block length for cumulative sums


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over dim 1, each prefix added in order in x's
    dtype (``torch.cumsum`` accumulates f32 in f64 on the CPU)."""
    out = [x[:, 0]]
    for i in range(1, x.shape[1]):
        out.append(out[-1] + x[:, i])
    return torch.stack(out, dim=1)


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(x, axis=1)`` in XLA:CPU's order, bitwise.

    XLA rewrites a cumulative sum over more than 16 elements into blocks
    of 16 (the axis zero-padded at the end): each block's prefix sums in
    order, plus the exclusive cumulative sum of the block totals (the same
    scheme again when there are more than 16 blocks).
    """
    n = x.shape[1]
    if n <= _SCAN_BASE:
        return _seq_cumsum(x)
    nb = -(-n // _SCAN_BASE)
    xp = F.pad(x.movedim(1, -1), (0, nb * _SCAN_BASE - n)).movedim(-1, 1)
    blocks = xp.reshape(x.shape[0], nb, _SCAN_BASE, *x.shape[2:])
    pre = _seq_cumsum(blocks.movedim(2, 1).reshape(
        x.shape[0], _SCAN_BASE, -1)).reshape(
        x.shape[0], _SCAN_BASE, nb, *x.shape[2:]).movedim(1, 2)
    tot = pre[:, :, -1]                                 # (B, nb, ...)
    excl = torch.cat([torch.zeros_like(tot[:, :1]),
                      _xla_cumsum(tot[:, :-1])], dim=1) if nb > 1 else \
        torch.zeros_like(tot)
    out = pre + excl[:, :, None]
    return out.reshape(x.shape[0], nb * _SCAN_BASE, *x.shape[2:])[:, :n]


# ==========================================================================
# mLSTM block (xLSTM matrix memory, chunked parallel form)
# ==========================================================================

def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    m = int(cfg.mlstm_proj_factor * cfg.d_model)
    return m, m // cfg.n_heads


def init_mlstm(cfg: ModelConfig, gen: torch.Generator,
               dtype=torch.bfloat16) -> Dict:
    d = cfg.d_model
    m, _ = _mlstm_dims(cfg)
    dev = gen.device
    return {
        "w_up": init_linear(gen, d, 2 * m, dtype=dtype),
        "w_q": init_linear(gen, m, m, dtype=dtype),
        "w_k": init_linear(gen, m, m, dtype=dtype),
        "w_v": init_linear(gen, m, m, dtype=dtype),
        "w_gates": init_linear(gen, m, 2 * cfg.n_heads, bias=True,
                               dtype=dtype),
        "w_down": init_linear(gen, m, d, dtype=dtype),
        "s_q": _scalar(dev), "s_k": _scalar(dev), "s_v": _scalar(dev),
        "s_state": _scalar(dev),
    }


def _mlstm_qkv(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
               col: Optional[Dict]):
    m, dh = _mlstm_dims(cfg)
    H = cfg.n_heads
    B, S, _ = x.shape
    up = qlinear(ctx, x, p["w_up"], subcol(col, "w_up"))
    u, z = up[..., :m], up[..., m:]
    q = qlinear(ctx, u, p["w_q"], subcol(col, "w_q")).reshape(B, S, H, dh)
    k = qlinear(ctx, u, p["w_k"], subcol(col, "w_k")).reshape(B, S, H, dh)
    v = qlinear(ctx, u, p["w_v"], subcol(col, "w_v")).reshape(B, S, H, dh)
    q = quantize_act(ctx, q, p, "s_q", col)
    k = quantize_act(ctx, k, p, "s_k", col)
    v = quantize_act(ctx, v, p, "s_v", col)
    gates = qlinear(ctx, u, p["w_gates"], subcol(col, "w_gates")).float()
    ig = torch.sigmoid(gates[..., :H])                   # (B,S,H)
    lf = _log_sigmoid(gates[..., H:])                    # log forget gate
    return q, k, v, z, ig, lf, dh


def _with_normalizer(v: torch.Tensor) -> torch.Tensor:
    """Append the normalizer ones-column to a value tensor (f32)."""
    vf = v.float()
    return torch.cat([vf, torch.ones_like(vf[..., :1])], dim=-1)


def _mlstm_out(cfg: ModelConfig, ctx: QuantCtx, p: Dict, out: torch.Tensor,
               z: torch.Tensor, dtype, col: Optional[Dict]) -> torch.Tensor:
    """(B, S, H, dh+1) numerators and normalizers -> the block's output."""
    B, S = out.shape[:2]
    m, dh = _mlstm_dims(cfg)
    num, den = out[..., :dh], out[..., dh]
    h = num / torch.clamp_min(torch.abs(den), 1.0)[..., None]
    h = h.reshape(B, S, m).to(dtype)
    h = quantize_act(ctx, h, p, "s_state", col)
    y = h * F.silu(z.float()).to(dtype)
    return qlinear(ctx, y, p["w_down"], subcol(col, "w_down"))


def mlstm_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
              col: Optional[Dict] = None, *, return_state: bool = False):
    """Chunked linear recurrence: C_t = f_t C_{t-1} + i_t k_t v_t^T,
    h_t = (q_t C_t) / max(|q_t n_t|, 1) with the normalizer n carried as an
    extra value column. Chunks of ``MLSTM_CHUNK`` steps run in parallel
    form; the state passes from chunk to chunk."""
    B, S, _ = x.shape
    q, k, v, z, ig, lf, dh = _mlstm_qkv(cfg, ctx, p, x, col)
    H = cfg.n_heads
    L = min(MLSTM_CHUNK, S)
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(t):
        # pad the time axis (log f with 0: f = 1, harmless), split in chunks
        if pad:
            t = F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
        return t.reshape(B, nc, L, *t.shape[2:]).unbind(1)

    scale = dh ** -0.5
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    state = torch.zeros((B, H, dh, dh + 1), dtype=torch.float32,
                        device=x.device)
    outs = []
    for qi, ki, vi, ii, lfi in zip(chunks(q), chunks(k), chunks(v),
                                   chunks(ig), chunks(lf)):
        cum = _xla_cumsum(lfi)                   # inclusive cumsum of log f
        # intra-chunk: decay(t, tau) = exp(cum_t - cum_tau) for tau <= t
        qf = qi.float() * scale
        kf = ki.float()
        scores = torch.einsum("bthd,bshd->bhts", qf, kf)
        decay = cum[:, :, None] - cum[:, None, :, :]     # (B,t,s,H)
        # mask BEFORE exp: the upper triangle's decay is positive and can
        # overflow, and inf * 0 would poison the gradient with NaN
        decay = torch.where(tri[None, :, :, None], decay,
                            torch.full_like(decay, float("-inf")))
        dmask = torch.exp(decay)
        w_ts = (scores * dmask.permute(0, 3, 1, 2)
                * ii.permute(0, 2, 1)[:, :, None, :].float())
        vn = _with_normalizer(vi)
        intra = torch.einsum("bhts,bshe->bthe", w_ts, vn)
        # inter-chunk: q_t exp(cum_t) @ state
        qdec = qf * torch.exp(cum)[..., None]
        inter = torch.einsum("bthd,bhde->bthe", qdec, state)
        outs.append(intra + inter)                         # (B,L,H,dh+1)
        # state update
        tot = cum[:, -1]                                   # (B,H)
        kdec = kf * (torch.exp(tot[:, None] - cum) * ii.float())[..., None]
        kv = torch.einsum("bshd,bshe->bhde", kdec, vn)
        state = state * torch.exp(tot)[..., None, None] + kv
    out = torch.stack(outs, dim=1).reshape(B, nc * L, H, dh + 1)[:, :S]
    y = _mlstm_out(cfg, ctx, p, out, z, x.dtype, col)
    if return_state:
        return y, state
    return y


def init_mlstm_cache(cfg: ModelConfig, B: int, *, device,
                     dtype=torch.int8) -> Dict:
    _, dh = _mlstm_dims(cfg)
    H = cfg.n_heads
    return {"state_q": torch.zeros((B, H, dh, dh + 1), dtype=dtype,
                                   device=device),
            "s_state": torch.zeros((B, H, 1, 1), dtype=torch.float32,
                                   device=device)}


def _mlstm_cache(ctx: QuantCtx, state: torch.Tensor) -> Dict:
    """The f32 state (B, H, dh, dh+1) quantized per head for the cache."""
    B, H = state.shape[:2]
    sq, ss = cache_quantize(ctx, state.reshape(B, H, -1).to(torch.bfloat16))
    return {"state_q": sq.reshape(state.shape), "s_state": ss[..., None]}


def mlstm_prefill(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
                  col: Optional[Dict] = None):
    y, state = mlstm_fwd(cfg, ctx, p, x, col, return_state=True)
    return y, _mlstm_cache(ctx, state)


def mlstm_decode(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x1: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, d) against the quantized state; the cache is
    updated in place and returned."""
    B = x1.shape[0]
    q, k, v, z, ig, lf, dh = _mlstm_qkv(cfg, ctx, p, x1, None)
    state = dequantize_int(cache["state_q"], cache["s_state"], torch.float32)
    f = torch.exp(lf[:, 0]).float()                       # (B,H)
    i = ig[:, 0].float()
    kv = torch.einsum("bhd,bhe->bhde", k[:, 0].float() * i[..., None],
                      _with_normalizer(v[:, 0]))
    state = state * f[..., None, None] + kv
    qf = q[:, 0].float() * dh ** -0.5
    out = torch.einsum("bhd,bhde->bhe", qf, state)[:, None]
    y = _mlstm_out(cfg, ctx, p, out, z, x1.dtype, None)
    for key, val in _mlstm_cache(ctx, state).items():
        cache[key].copy_(val)
    return y, cache


# ==========================================================================
# sLSTM block (scalar memory, sequential scan)
# ==========================================================================

def init_slstm(cfg: ModelConfig, gen: torch.Generator,
               dtype=torch.bfloat16) -> Dict:
    d = cfg.d_model
    s_in = int(cfg.slstm_proj_factor * d)
    return {
        "w_x": init_linear(gen, d, 4 * d, bias=True, dtype=dtype),
        "r_h": init_linear(gen, d, 4 * d, dtype=dtype),
        "w_up": init_linear(gen, d, s_in, dtype=dtype),
        "w_down": init_linear(gen, s_in, d, dtype=dtype),
        "s_state": _scalar(gen.device),
    }


def _recurrent_linear(ctx: QuantCtx, p: Dict) -> Callable:
    """``h -> qlinear(ctx, h, p)`` for the cell's h @ r_h, with the weight
    fake-quantized once for the whole scan instead of once per step: the
    same values (the weight and its scale do not change within a
    forward), one fake-quant launch and one backward instead of T. The
    input's per-step quantization stays in the loop; the packed w4a8
    layout takes the linear as it is."""
    if ctx.weights_layout == "w4a8" and ctx.mode != "calib" and not ctx.off:
        return lambda h: qlinear(ctx, h, p)
    wq = quantize_weight_p(ctx, p)
    return lambda h: torch.matmul(quantize_act(ctx, h, p, "s_in"), wq)


def _slstm_cell(gx_t: torch.Tensor, h_prev: torch.Tensor,
                c_prev: torch.Tensor, rh: Callable):
    """One sLSTM step. gx_t: precomputed W_x x_t (B,4d); ``h`` is carried
    in gx's dtype, ``c`` in f32."""
    g = (gx_t + rh(h_prev)).float()
    i, f, zz, o = torch.split(g, g.shape[-1] // 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(zz)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h.to(gx_t.dtype), c


def slstm_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
              col: Optional[Dict] = None, *, return_state: bool = False):
    """sLSTM over the sequence (B, S, d).

    The route of the recurrence is stated here once. A forward with
    quantization off and no gradient (``ctx.off`` and
    ``torch.is_grad_enabled()`` False: the QAT teacher, evaluation) runs
    the ``slstm_scan`` kernel for CUDA tensors (its plain version under
    ``kernel_backend="ref"`` and for CPU tensors) with ``carry="gx"``:
    the reference's cell (``src/repro/models/recurrent.py:_slstm_cell``),
    h carried in gx's dtype (bf16), ``h . r_h`` summed in f32 and rounded
    to it, added to gx in it, the gates and c in f32; ``hT`` in gx's
    dtype. Every other forward runs the per-step cell below, the same
    cell with the linear quantized (h requantized every step): the
    student under autograd (the kernel has no backward; the reference
    has none either), calibration, serving.
    """
    B, S, d = x.shape
    gx = qlinear(ctx, x, p["w_x"], subcol(col, "w_x"))     # (B,S,4d)
    h0 = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    c0 = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    if ctx.off and not torch.is_grad_enabled():
        from repro_torch.kernels.slstm_scan.ops import slstm_scan
        h, hT, cT = slstm_scan(gx, p["r_h"]["w"], h0, c0, carry="gx",
                               plain=ctx.kernel_backend == "ref")
    else:
        rh = _recurrent_linear(ctx, p["r_h"])
        hT, cT = h0.to(gx.dtype), c0
        hs = []
        for t in range(S):
            hT, cT = _slstm_cell(gx[:, t], hT, cT, rh)
            hs.append(hT)
        h = torch.stack(hs, dim=1)                         # (B,S,d)
    h = quantize_act(ctx, h, p, "s_state", col)
    u = qlinear(ctx, h, p["w_up"], subcol(col, "w_up"))
    u = _gelu(u.float()).to(x.dtype)
    y = qlinear(ctx, u, p["w_down"], subcol(col, "w_down"))
    if return_state:
        return y, (hT, cT)
    return y


def init_slstm_cache(cfg: ModelConfig, B: int, *, device,
                     dtype=torch.int8) -> Dict:
    d = cfg.d_model
    return {"state_q": torch.zeros((B, d), dtype=dtype, device=device),
            "s_state": torch.zeros((B, 1), dtype=torch.float32,
                                   device=device),
            "c": torch.zeros((B, d), dtype=torch.float32, device=device)}


def slstm_prefill(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
                  col: Optional[Dict] = None):
    y, (hT, cT) = slstm_fwd(cfg, ctx, p, x, col, return_state=True)
    hq, hs = cache_quantize(ctx, hT.to(torch.bfloat16))
    return y, {"state_q": hq, "s_state": hs, "c": cT.float()}


def slstm_decode(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x1: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, d) against the quantized state; the cache is
    updated in place and returned."""
    gx = qlinear(ctx, x1, p["w_x"])[:, 0]
    h_prev = dequantize_int(cache["state_q"], cache["s_state"], x1.dtype)
    h, c = _slstm_cell(gx, h_prev, cache["c"],
                       lambda hh: qlinear(ctx, hh, p["r_h"]))
    hq2 = quantize_act(ctx, h[:, None], p, "s_state")
    u = qlinear(ctx, hq2, p["w_up"])
    u = _gelu(u.float()).to(x1.dtype)
    y = qlinear(ctx, u, p["w_down"])
    hq, hs = cache_quantize(ctx, h.to(torch.bfloat16))
    cache["state_q"].copy_(hq)
    cache["s_state"].copy_(hs)
    cache["c"].copy_(c)
    return y, cache
