"""Recurrent blocks: the RG-LRU (RecurrentGemma / Griffin), and the xLSTM
family's mLSTM (matrix memory, chunked parallel form) and sLSTM (scalar
memory, sequential scan).

The RG-LRU is a diagonal linear recurrence. As in the reference it runs
as an associative scan (:func:`associative_scan`, the recursion of
``jax.lax.associative_scan``): log-depth elementwise ops, with the same
combination tree and so the same f32 sums. It has no kernel in either
package.

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

Tensor-parallel serving (``ctx.tp``; the engine hands these functions
this rank's slice of the weights, ``runtime.sharding.shard_params``, and
a config of this rank's widths). Every result is bitwise tp=1's slice:

* RG-LRU: ``w_in``, ``w_gate``, the conv and ``lam`` hold this rank's
  channels of the width (``lru_width / tp``), so the conv output, the
  recurrence and its state are the rank's channels. ``w_ig`` and ``w_rg``
  take the whole width: the rank's bf16 conv output is all-gathered in
  rank order (exact), and their column-parallel slices give the rank's
  gates. The state's per-row scale (the cache's and ``s_state``'s
  dynamic one) takes the whole row's amax (an all-reduced MAX), and
  ``w_out`` is row-parallel.
* mLSTM: a rank holds ``n_heads / tp`` heads. ``w_up`` keeps the ``u``
  half whole and this rank's heads of the ``z`` half; ``w_q`` / ``w_k``
  / ``w_v`` are cut by heads and ``w_gates`` to the rank's heads of its
  input and forget gates, so the per-head recurrence and its state are
  local; ``s_state`` takes the whole row's amax and ``w_down`` is
  row-parallel.
* sLSTM: the recurrence (``w_x``, ``r_h``, the cell, its state) is whole
  on every rank, as a whole attention is: no collective inside the
  sequential loop. ``w_up`` is column- and ``w_down`` row-parallel.
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
from repro_torch.models.common import _c, _fma, _gelu, _tanh

MLSTM_CHUNK = 256


def _scalar(dev) -> torch.Tensor:
    return torch.tensor(1.0, dtype=torch.float32, device=dev)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``'s op sequence: -logaddexp(-x, 0)."""
    nx = -x
    return -(torch.clamp_min(nx, 0.0)
             + torch.log1p(torch.exp(-torch.abs(nx))))


# --------------------------------------------------------------------------
# The reference's f32 transcendentals on the CPU (tanh, and the GELU that
# uses it, are in ``models/common.py``). XLA:CPU evaluates exp, tanh, log
# and log1p with its own polynomials (Eigen's and Cephes'), FMA
# contracted, and its sqrt is correctly rounded; torch's CPU functions
# round up to a few ulps apart, and in
# the RG-LRU's gates such an ulp reaches a bf16 output now and then and is
# carried down the recurrence. So CPU tensors take the polynomials below
# (an FMA is the f64 product and sum rounded to f32: the product is exact
# in f64), and CUDA tensors torch's own functions. Measured against
# XLA:CPU on 1.2e5 random f32 inputs: exp, tanh, logistic and log1p's
# small branch bitwise; log (log1p's branch above sqrt(2) - 1) 3.5e-4 of
# values one ulp apart.
# --------------------------------------------------------------------------

_EXP_P = _c(1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
            4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_EXP_K = _c(88.3762626647949, 88.3762626647950, 1.44269504088896341,
            0.693359375, 2.12194440e-4)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp; on the CPU XLA:CPU's (Cephes' polynomial)."""
    if x.is_cuda:
        return torch.exp(x)
    lo, hi, log2e, c1, c2 = _EXP_K
    x = torch.clamp(x, -lo, hi)
    fx = torch.floor(_fma(x, log2e, 0.5))
    r = _fma(fx, -c1, x)
    r = _fma(fx, c2, r)
    z = r * r
    y = _fma(torch.full_like(r, _EXP_P[0]), r, _EXP_P[1])
    for c in _EXP_P[2:]:
        y = _fma(y, r, c)
    y = _fma(y, z, r) + 1.0
    return (y.double() * torch.exp2(fx.double())).float()


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (XLA's logistic: 1 / (1 + exp(-x)))."""
    if x.is_cuda:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + _exp(-x))


_LOG_P = _c(7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
            -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
            2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_K = _c(0.707106781186547524, 2.12194440e-4, 0.693359375)


def _log(x: torch.Tensor) -> torch.Tensor:
    """f32 log of positive normal x, Eigen's Cephes polynomial."""
    m, e = torch.frexp(x)
    e = e.float()
    sqrt_half, q1, q2 = _LOG_K
    small = m < sqrt_half
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    y = _fma(torch.full_like(m, _LOG_P[0]), m, _LOG_P[1])
    y1 = _fma(torch.full_like(m, _LOG_P[3]), m, _LOG_P[4])
    y2 = _fma(torch.full_like(m, _LOG_P[6]), m, _LOG_P[7])
    y = _fma(y, m, _LOG_P[2])
    y1 = _fma(y1, m, _LOG_P[5])
    y2 = _fma(y2, m, _LOG_P[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2) * x3
    y = _fma(e, -q1, y)
    r = _fma(x2, -0.5, m) + y
    return _fma(e, q2, r)


_LOG1P_NUM = _c(4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                6.5787325942061044846969e0, 2.9911919328553073277375e1,
                6.0949667980987787057556e1, 5.7112963590585538103336e1,
                2.0039553499201281259648e1)
_LOG1P_DEN = _c(1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
                2.2176239823732856465394e2, 3.0909872225312059774938e2,
                2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = _c(0.41421356237309504880)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """f32 log1p; on the CPU XLA's: a Cephes rational function below
    sqrt(2) - 1, log(1 + x) above."""
    if x.is_cuda:
        return torch.log1p(x)
    num = torch.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma(num, x, c)
    den = torch.zeros_like(x)
    for c in _LOG1P_DEN:
        den = _fma(den, x, c)
    x2 = x * x
    small = (x * x2) * (num / den)
    small = x + _fma(x2, -0.5, small)
    large = _log(x + 1.0)
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, large)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt, as XLA:CPU's (torch's CPU f32 sqrt
    is not, on 0.2% of the RG-LRU's 1 - a^2)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s op sequence: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + _log1p(_exp(-torch.abs(x)))


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
# RG-LRU block (Griffin / RecurrentGemma temporal-mixing block)
# ==========================================================================

def _every(x: torch.Tensor, dim: int, start: int, stop=None,
           step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim`` (len(a) is len(b) or one
    more)."""
    nb = b.shape[dim]
    pairs = torch.stack([_every(a, dim, 0, nb), b], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if a.shape[dim] > nb:
        out = torch.cat([out, _every(a, dim, nb)], dim=dim)
    return out


def associative_scan(combine: Callable, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` under the
    associative ``combine``, in ``jax.lax.associative_scan``'s recursion:
    combine the pairs [0:-1:2] and [1::2], scan that by recursion (the
    odd results), combine them with [2::2] (the even ones), put element 0
    in front and interleave. Every output is the same tree of
    ``combine`` calls as the reference's, so elementwise f32 ops give the
    same bits."""
    elems = tuple(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine(tuple(_every(e, dim, 0, -1, 2) for e in elems),
                      tuple(_every(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(combine, reduced, dim)
    rest = tuple(_every(e, dim, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = combine(tuple(_every(o, dim, 0, -1) for o in odd), rest)
    else:
        even = combine(odd, rest)
    even = tuple(torch.cat([_every(e, dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _lru_combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def init_rglru(cfg: ModelConfig, gen: torch.Generator,
               dtype=torch.bfloat16) -> Dict:
    d, w = cfg.d_model, cfg.resolved_lru_width
    dev = gen.device
    # Lambda so that a = exp(-8 softplus(L) r) spreads over (0.9, 0.999)
    lam = torch.rand((w,), generator=gen, dtype=torch.float32,
                     device=dev) * 0.09 + 0.01
    conv_w = torch.randn((cfg.conv1d_width, w), generator=gen,
                         dtype=torch.float32, device=dev) * 0.1
    return {
        "w_in": init_linear(gen, d, w, dtype=dtype),
        "w_gate": init_linear(gen, d, w, dtype=dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_ig": init_linear(gen, w, w, dtype=dtype),     # input gate
        "w_rg": init_linear(gen, w, w, dtype=dtype),     # recurrence gate
        "lam": lam,
        "w_out": init_linear(gen, w, d, dtype=dtype),
        "s_state": _scalar(dev),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of width K. x (B,S,W); buf (B,K-1,W) the
    history (zeros when None). Summed in f32 tap by tap, as the
    reference does."""
    K = w.shape[0]
    if buf is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([buf.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = b.float()
    for j in range(K):
        y = y + w[j].float() * xp[:, j:j + S].float()
    return y.to(x.dtype)


def _whole_width(ctx: QuantCtx, u: torch.Tensor) -> torch.Tensor:
    """u (B, S, W / tp), this rank's channels, as the whole (B, S, W):
    the ranks' slices gathered in rank order (the bf16 values move
    exactly). Off a mesh, u itself."""
    if ctx.tp is None or ctx.tp.size == 1:
        return u
    return ctx.tp.all_gather_last(u)


def _rglru_coeffs(cfg: ModelConfig, ctx: QuantCtx, p: Dict, u: torch.Tensor,
                  col: Optional[Dict]):
    """The gates of the recurrence from the conv output u (B,S,W): the
    decay a and the gated input, both f32. On a tensor-parallel mesh u
    and the results are this rank's channels; the gates' linears read
    the whole width."""
    uw = _whole_width(ctx, u)
    i = _sigmoid(qlinear(ctx, uw, p["w_ig"], subcol(col, "w_ig")).float())
    r = _sigmoid(qlinear(ctx, uw, p["w_rg"], subcol(col, "w_rg")).float())
    log_a = -8.0 * _softplus(p["lam"]) * r                 # (B,S,W)
    a = _exp(log_a)
    gated = _sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i * u.float()
    return a, gated


def _rglru_scan(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
                col: Optional[Dict]):
    """(gate, pre-conv u, h): the block up to its recurrence's f32 h."""
    gate = _gelu(qlinear(ctx, x, p["w_gate"], subcol(col, "w_gate")).float(),
                 _tanh)
    u = qlinear(ctx, x, p["w_in"], subcol(col, "w_in"))
    uc = _causal_conv1d(u, p["conv_w"], p["conv_b"])
    a, gated = _rglru_coeffs(cfg, ctx, p, uc, col)
    _, h = associative_scan(_lru_combine, (a, gated), dim=1)
    return gate, u, h


def _rglru_out(ctx: QuantCtx, p: Dict, h: torch.Tensor, gate: torch.Tensor,
               dtype, col: Optional[Dict]) -> torch.Tensor:
    hq = quantize_act(ctx, h.to(dtype), p, "s_state", col, sharded=True)
    y = (hq.float() * gate).to(dtype)
    return qlinear(ctx, y, p["w_out"], subcol(col, "w_out"), row=True)


def rglru_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
              col: Optional[Dict] = None) -> torch.Tensor:
    """Training / teacher / calibration path: the associative scan over
    the diagonal recurrence h_t = a_t h_{t-1} + gated_t."""
    gate, _, h = _rglru_scan(cfg, ctx, p, x, col)
    return _rglru_out(ctx, p, h, gate, x.dtype, col)


def init_rglru_cache(cfg: ModelConfig, B: int, *, device,
                     dtype=torch.int8) -> Dict:
    w = cfg.resolved_lru_width
    return {"state_q": torch.zeros((B, w), dtype=dtype, device=device),
            "s_state": torch.zeros((B, 1), dtype=torch.float32,
                                   device=device),
            "conv_buf": torch.zeros((B, cfg.conv1d_width - 1, w),
                                    dtype=torch.bfloat16, device=device)}


def rglru_prefill(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
                  col: Optional[Dict] = None):
    """The parallel scan over the prompt, and the serving cache: the last
    h quantized (``state_q``, ``s_state``) and the conv's history, the
    last K - 1 pre-conv inputs."""
    gate, u, h = _rglru_scan(cfg, ctx, p, x, col)
    y = _rglru_out(ctx, p, h, gate, x.dtype, col)
    state_q, s_state = cache_quantize(ctx, h[:, -1].to(torch.bfloat16),
                                      sharded=True)
    K = cfg.conv1d_width
    return y, {"state_q": state_q, "s_state": s_state,
               "conv_buf": u[:, -(K - 1):].to(torch.bfloat16)}


def rglru_decode(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x1: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1, d) against the quantized state; the cache is
    updated in place and returned."""
    gate = _gelu(qlinear(ctx, x1, p["w_gate"]).float(), _tanh)
    u = qlinear(ctx, x1, p["w_in"])                       # (B,1,W)
    uc = _causal_conv1d(u, p["conv_w"], p["conv_b"], buf=cache["conv_buf"])
    a, gated = _rglru_coeffs(cfg, ctx, p, uc, None)       # (B,1,W)
    h_prev = dequantize_int(cache["state_q"], cache["s_state"],
                            torch.float32)                # (B,W)
    h = a[:, 0] * h_prev + gated[:, 0]
    state_q, s_state = cache_quantize(ctx, h.to(torch.bfloat16),
                                      sharded=True)
    y = (h[:, None] * gate).to(x1.dtype)
    y = qlinear(ctx, y, p["w_out"], row=True)
    new_buf = torch.cat([cache["conv_buf"][:, 1:], u.to(torch.bfloat16)],
                        dim=1)
    cache["state_q"].copy_(state_q)
    cache["s_state"].copy_(s_state)
    cache["conv_buf"].copy_(new_buf)
    return y, cache


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
    # [u | z]; on a tensor-parallel mesh u whole and z this rank's heads
    # (m, from the rank's config, is then z's width)
    u, z = up[..., :-m], up[..., -m:]
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
    h = quantize_act(ctx, h, p, "s_state", col, sharded=True)
    y = h * F.silu(z.float()).to(dtype)
    return qlinear(ctx, y, p["w_down"], subcol(col, "w_down"), row=True)


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
    y = qlinear(ctx, u, p["w_down"], subcol(col, "w_down"), row=True)
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
    y = qlinear(ctx, u, p["w_down"], row=True)
    hq, hs = cache_quantize(ctx, h.to(torch.bfloat16))
    cache["state_q"].copy_(hq)
    cache["s_state"].copy_(hs)
    cache["c"].copy_(c)
    return y, cache
