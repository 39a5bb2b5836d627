"""SiLQ quantizers, serving half: fake-quant forwards and integer codes.

Paper Eq. 1, ``x_hat = round(clip(x / s, b_l, b_u)) * s``, with symmetric
signed integers ``b_l = -2^{p-1}``, ``b_u = 2^{p-1} - 1``. All quantization
math runs in fp32 and rounds half to even (``torch.round``, as the
reference's ``jnp.round``); results are cast back to the input dtype.

Serving runs forward only, so the straight-through and LSQ gradients of
the training path are not part of this module.
"""
from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-9


def qbounds(bits: int) -> Tuple[int, int]:
    """Lower/upper integer bounds for symmetric signed quantization."""
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def lsq_fake_quant(x: torch.Tensor, s: torch.Tensor, bits: int) -> torch.Tensor:
    """Quant-dequant with a learned step size (forward of the LSQ site)."""
    qn, qp = qbounds(bits)
    sf = torch.clamp_min(s.float(), _EPS)
    q = torch.round(torch.clamp(x.float() / sf, qn, qp))
    return (q * sf).to(x.dtype)


def dynamic_fake_quant(x: torch.Tensor, bits: int, axis: int = -1) -> torch.Tensor:
    """Token-wise dynamic symmetric quantization (absmax over ``axis``)."""
    qn, qp = qbounds(bits)
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    s = torch.clamp_min(absmax / qp, _EPS)
    v = torch.clamp(xf / s, qn, qp)
    return (torch.round(v) * s).to(x.dtype)


def quantize_to_int(x: torch.Tensor, s: torch.Tensor, bits: int,
                    dtype=torch.int8) -> torch.Tensor:
    """Real integer quantization: ``round(clip(x/s))`` as ints (no dequant)."""
    qn, qp = qbounds(bits)
    v = x.float() / torch.clamp_min(s.float(), _EPS)
    return torch.round(torch.clamp(v, qn, qp)).to(dtype)


def dynamic_quantize_to_int(x: torch.Tensor, bits: int, axis: int = -1,
                            dtype=torch.int8):
    """Per-token integer quantization; returns (q, scale)."""
    qn, qp = qbounds(bits)
    xf = x.float()
    s = torch.clamp_min(torch.amax(torch.abs(xf), dim=axis, keepdim=True) / qp,
                        _EPS)
    q = torch.round(torch.clamp(xf / s, qn, qp)).to(dtype)
    return q, s


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, range [-8,7]) two-per-byte on the last
    axis. Layout: low nibble = even index, high nibble = odd index."""
    if q.shape[-1] % 2:
        raise ValueError("int4 packing needs an even last dim")
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    lo, hi = u[..., 0::2], u[..., 1::2]
    return lo | (hi << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; returns int8 values in [-8, 7]."""
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)
