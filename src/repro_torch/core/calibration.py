"""Step-size calibration: percentile (activations) and convex-MSE (weights).

Paper §3.1:

* activations — step size set to the value at the 99.91 / 99.99 / 99.995
  percentile of |x| for 4- / 8- / 16-bit, over 5 calibration batches.
* weights — convex approximation of quantization MSE (Eq. 2)::

      eps_hat(s) = sum_i max(s^2/12, H(|w_i| - s*b) * (|w_i| - s*b)^2)

  with ``b = 2^{p-1} - 0.5``, minimized by ternary search.
* LSQ-paper initialization (``2<|w|>/sqrt(b_u)``) kept for the ablation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantizer import qbounds

# paper-specified |x| percentiles per activation precision
ACT_PERCENTILE = {4: 99.91, 8: 99.99, 16: 99.995}


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x.reshape(-1), q)`` (method ``linear``) for any size.

    ``torch.quantile`` refuses inputs above 2^24 elements, and a
    full-width calibration batch comes close (8 x 128 x 11008 at d_ff).
    This is the reference's arithmetic, exact at any size: the position
    ``q * (n - 1)`` in f32 (n rounded to f32, as jax does), its floor and
    ceiling clamped to the range, the two order statistics found by
    ``torch.topk`` (an exact selection; the percentiles here lie in the
    top 0.1%), and ``lo * (1 - w) + hi * w`` in f32. A NaN anywhere
    gives NaN.
    """
    flat = x.reshape(-1).float()
    n = flat.numel()
    nf = np.float32(n)
    pos = np.float32(q) * (nf - np.float32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - low)
    lw = np.float32(np.float32(1.0) - hw)
    lo_i = int(min(max(low, 0), nf - 1))
    hi_i = int(min(max(high, 0), nf - 1))
    top = torch.topk(flat, n - lo_i, largest=True, sorted=True).values
    lo_v, hi_v = top[-1], top[n - 1 - hi_i]
    out = lo_v * float(lw) + hi_v * float(hw)
    return torch.where(torch.isnan(flat).any(),
                       torch.full_like(out, float("nan")), out)


def act_percentile_stat(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-batch percentile statistic for an activation site (f32 0-d)."""
    q = ACT_PERCENTILE[bits] / 100.0
    return quantile_linear(torch.abs(x.float()), q)


def act_max_stat(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Max-|x| statistic (the paper's ablation baseline)."""
    del bits
    return torch.amax(torch.abs(x.float()))


def act_scale_from_stat(stat: torch.Tensor, bits: int) -> torch.Tensor:
    """Step size from a calibrated |x| landmark: s = landmark / b_u."""
    _, qp = qbounds(bits)
    return torch.clamp_min(stat / qp, 1e-9)


# --------------------------------------------------------------------------
# Convex-MSE weight calibration (paper Eq. 2)
# --------------------------------------------------------------------------

def mse_objective(absw: torch.Tensor, s: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """Eq. 2 evaluated per channel.

    ``absw``: (..., n) |w| grouped so the last axis shares one step size.
    ``s``: (...,) candidate step sizes. Returns (...,) objective values.
    """
    b = 2.0 ** (bits - 1) - 0.5
    s_ = s[..., None]
    over = torch.clamp_min(absw - s_ * b, 0.0)
    return torch.sum(torch.maximum(s_ * s_ / 12.0, over * over), dim=-1)


def mse_weight_scale(w: torch.Tensor, bits: int, channel_last: bool = True,
                     iters: int = 64) -> torch.Tensor:
    """Minimize Eq. 2 per output channel by ternary search (convex in s).

    ``w``: (..., d_in, d_out) -> scales shaped (..., 1, d_out). The optimum
    lies in (0, max|w|/b], and ternary search on that bracket converges
    geometrically (ratio (2/3)^iters).
    """
    wf = torch.abs(w.float())
    if channel_last and w.dim() >= 2:
        absw = wf.movedim(-2, -1)                   # (..., d_out, d_in)
    else:
        absw = wf.reshape(-1)[None, :]              # single group
    b = 2.0 ** (bits - 1) - 0.5
    hi = torch.clamp_min(torch.amax(absw, dim=-1) / b, 1e-8)
    lo = torch.full_like(hi, 1e-9)
    for _ in range(iters):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        f1 = mse_objective(absw, m1, bits)
        f2 = mse_objective(absw, m2, bits)
        lo = torch.where(f1 > f2, m1, lo)
        hi = torch.where(f1 > f2, hi, m2)
    s = (lo + hi) / 2.0                             # (..., d_out)
    if channel_last and w.dim() >= 2:
        return s[..., None, :]                      # (..., 1, d_out)
    return s.reshape(())


def lsq_weight_scale(w: torch.Tensor, bits: int,
                     channel_last: bool = True) -> torch.Tensor:
    """LSQ-paper initialization: s = 2 * mean|w| / sqrt(b_u) (ablation)."""
    _, qp = qbounds(bits)
    wf = torch.abs(w.float())
    if channel_last and w.dim() >= 2:
        mean = torch.mean(wf, dim=-2, keepdim=True)  # (..., 1, d_out)
    else:
        mean = torch.mean(wf)
    return torch.clamp_min(2.0 * mean / float(np.sqrt(np.float32(qp))),
                           1e-9)


def weight_scale(w: torch.Tensor, bits: int,
                 method: str = "mse") -> torch.Tensor:
    if method == "mse":
        return mse_weight_scale(w, bits)
    if method == "lsq":
        return lsq_weight_scale(w, bits)
    raise ValueError(f"unknown weight calibration method {method!r}")

