"""Plain PyTorch versions of the LSQ fake-quant kernels.

The same math as ``csrc/fake_quant.cu`` and the reference's
``kernels/quant/ref.py``, in f32 and cast back to the input's type. ``s``
broadcasts against ``x``: a 0-d or one-element scale per tensor, ``(1, C)``
per column (a weight's output channel), ``(R, 1)`` per row (the tied
head's ``embed.w``, quantized per vocab entry), ``(E, 1, C)`` per column of
each slice of an ``(E, R, C)`` x (an MoE expert bank's output channels).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quantizer import _EPS, _reduce_to_shape, qbounds


def fake_quant_fwd_ref(x: torch.Tensor, s: torch.Tensor,
                       bits: int) -> torch.Tensor:
    qn, qp = qbounds(bits)
    sf = torch.clamp_min(s.float(), _EPS)
    q = torch.round(torch.clamp(x.float() / sf, qn, qp))
    return (q * sf).to(x.dtype)


def fake_quant_bwd_ref(x: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                       bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dx, ds): ds summed to ``s.shape`` in f32, WITHOUT the LSQ
    ``1/sqrt(n*qp)`` gradient scale (the caller applies it)."""
    qn, qp = qbounds(bits)
    sf = torch.clamp_min(s.float(), _EPS)
    gf = g.float()
    v = x.float() / sf
    within = (v >= qn) & (v <= qp)
    dx = torch.where(within, gf, torch.zeros_like(gf)).to(x.dtype)
    dq_ds = torch.where(within, torch.round(v) - v, torch.clamp(v, qn, qp))
    return dx, _reduce_to_shape(gf * dq_ds, tuple(s.shape))
