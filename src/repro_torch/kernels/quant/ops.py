"""Wrappers for the LSQ fake-quant kernels and the autograd function
around them: the port's ``lsq_fake_quant``.

``fake_quant_fwd`` and ``fake_quant_bwd`` launch ``csrc/fake_quant.cu``
for CUDA tensors and run the plain versions (``ref.py``) for CPU tensors.
Each checks its inputs, raises on what the kernel does not take (a
non-contiguous operand included: nothing is copied behind the caller's
back) and counts its launches in ``.launches``.

The scale's layout picks the kernel's mode: one element (per tensor),
``(..., C)`` matching x's last axis (per column), or ``(R, 1)`` against a
2-D x (per row: the tied head quantizes ``embed.w``, whose transpose the
head multiplies, once per vocab entry; see ``core.qat.quantize_weight_p``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.quantizer import qbounds
from repro_torch.kernels.checks import check_tensor
from repro_torch.kernels.quant.ref import (fake_quant_bwd_ref,
                                           fake_quant_fwd_ref)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fake_quant_fwd_launch": ((_P,) * 3 + (_L,) * 2 + (_I,) * 3 + (_P,), _I),
    "fake_quant_bwd_launch": ((_P,) * 6 + (_L,) * 2 + (_I,) * 3
                              + (ctypes.c_float, _L, _P), _I),
    "fake_quant_bwd_workspace": ((_L, _L, _I), _L),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    from repro_torch.kernels.build import load
    fn = getattr(load("fake_quant"), name)
    args, res = _ARGTYPES[name]
    fn.argtypes = list(args)
    fn.restype = res
    return fn


def scale_mode(x: torch.Tensor, s: torch.Tensor) -> int:
    """0: one scale; 1: one per column (x's last axis); 2: one per row of
    a 2-D x. Anything else raises."""
    if s.numel() == 1:
        return 0
    C = x.shape[-1] if x.dim() else 1
    if s.numel() == C and s.shape[-1] == C:
        return 1
    if x.dim() == 2 and s.numel() == x.shape[0] and s.shape[-1] == 1:
        return 2
    raise ValueError(f"scale of shape {tuple(s.shape)} is neither per "
                     f"tensor, per column nor per row of x {tuple(x.shape)}")


def grad_scale(x: torch.Tensor, s: torch.Tensor, bits: int) -> float:
    """LSQ step-size gradient scale ``1/sqrt(f32(n * qp))`` in f32, with
    n the elements per scale (the reference's ``_lsq_bwd``)."""
    _, qp = qbounds(bits)
    n = max(x.numel() // max(s.numel(), 1), 1)
    return float(np.float32(1.0) / np.sqrt(np.float32(n * qp)))


def _check(x, s, dev):
    if x.dtype not in _DTYPES:
        raise TypeError(f"the fake-quant kernels take bf16 or f32, got "
                        f"{x.dtype}")
    check_tensor("x", x, x.dtype, x.shape, dev)
    check_tensor("s", s, torch.float32, s.shape, dev)
    C = x.shape[-1] if x.dim() else 1
    return x.numel() // C, C


def _cuda_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {t.device}")


def fake_quant_fwd(x: torch.Tensor, s: torch.Tensor, bits: int,
                   plain: bool = False) -> torch.Tensor:
    """``round(clip(x / s, qn, qp)) * s`` in f32, cast to x's type.

    CPU tensors, and every tensor when ``plain``, run the plain version.
    CUDA tensors launch the kernel, which takes a contiguous bf16 or f32
    x and a contiguous f32 s; anything else raises.
    """
    if x.device.type == "cpu" or plain:
        return fake_quant_fwd_ref(x, s, bits)
    _cuda_only("fake_quant_fwd", x)
    mode = scale_mode(x, s)
    R, C = _check(x, s, x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn("fake_quant_fwd_launch")(
        x.data_ptr(), s.data_ptr(), out.data_ptr(), R, C, mode,
        _DTYPES[x.dtype], bits, stream)
    if err:
        raise RuntimeError(f"fake_quant_fwd kernel launch failed: CUDA error "
                           f"{err}")
    fake_quant_fwd.launches += 1
    return out


fake_quant_fwd.launches = 0


def fake_quant_bwd(x: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                   bits: int, plain: bool = False):
    """Returns (dx, ds): the straight-through ``dx`` and the LSQ step-size
    gradient, summed to ``s.shape`` and scaled by :func:`grad_scale`.

    CPU tensors, and every tensor when ``plain``, run the plain version.
    CUDA tensors launch the kernel (two deterministic passes, no atomics);
    g must have x's shape, type and layout.
    """
    gs = grad_scale(x, s, bits)
    if x.device.type == "cpu" or plain:
        dx, ds = fake_quant_bwd_ref(x, s, g, bits)
        return dx, (ds * gs).to(s.dtype)
    _cuda_only("fake_quant_bwd", x)
    mode = scale_mode(x, s)
    dev = x.device
    R, C = _check(x, s, dev)
    check_tensor("g", g, x.dtype, x.shape, dev)
    dx = torch.empty_like(x)
    ds = torch.empty(s.shape, dtype=torch.float32, device=dev)
    # the source sizes its own workspace, and checks the length it is given
    work = _fn("fake_quant_bwd_workspace")(R, C, mode)
    partial = torch.empty((max(work, 1),), dtype=torch.float32, device=dev)
    err = _fn("fake_quant_bwd_launch")(
        x.data_ptr(), s.data_ptr(), g.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), ds.data_ptr(), R, C, mode, _DTYPES[x.dtype],
        bits, gs, work, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fake_quant_bwd kernel launch failed: CUDA error "
                           f"{err}")
    fake_quant_bwd.launches += 1
    return dx, ds


fake_quant_bwd.launches = 0


class _LsqFakeQuant(torch.autograd.Function):
    """Quant-dequant with the straight-through gradient for x and the LSQ
    gradient for s (the reference's ``jax.custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, s, bits, plain):
        ctx.save_for_backward(x, s)
        ctx.bits, ctx.plain = bits, plain
        return fake_quant_fwd(x, s, bits, plain=plain)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        # autograd may hand a strided gradient (an attention einsum's view
        # of q/k/v); the kernel reads x's layout, so it is copied here, in
        # the open, and only then
        dx, ds = fake_quant_bwd(x, s, g.contiguous(), ctx.bits,
                                plain=ctx.plain)
        return dx, ds, None, None


def lsq_fake_quant(x: torch.Tensor, s: torch.Tensor, bits: int,
                   plain: bool = False) -> torch.Tensor:
    """LSQ fake quantization with its gradients; ``plain`` runs the plain
    versions on any device (what the kernels are held against)."""
    return _LsqFakeQuant.apply(x, s, bits, plain)
