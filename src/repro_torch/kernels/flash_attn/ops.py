"""Wrapper for the flash-attention forward kernel.

``flash_attn_fwd`` launches ``csrc/flash_attn_fwd.cu`` for CUDA tensors
and runs the plain version (``ref.py``) for CPU tensors. It checks its
inputs, raises on what the kernel does not take and counts its launches in
``.launches``. The model calls it for every attention forward that needs
no gradient (``models.blocks.attn_fwd``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.checks import check_aligned, check_tensor
from repro_torch.kernels.flash_attn.ref import flash_attn_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 4 + (_I,) * 11 + (ctypes.c_float, _P)
HEAD_DIMS = (16, 64, 128, 256)


@functools.lru_cache(maxsize=None)
def _fn():
    from repro_torch.kernels.build import load
    fn = load("flash_attn_fwd").flash_attn_fwd_launch
    fn.argtypes = list(_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   q_offset: int = 0, plain: bool = False) -> torch.Tensor:
    """q (B,S,H,D); k/v (B,Skv,Hkv,D) -> (B,S,H,D). ``q_offset``: query
    row r sits at key position ``q_offset + r`` for the causal and window
    masks (a rank's query rows under sequence-parallel attention).

    CPU tensors, and every tensor when ``plain``, run the plain version.
    CUDA tensors launch the kernel, which takes contiguous 16-byte aligned
    bf16 operands, H % Hkv == 0 and D of 16, 64, 128 or 256; anything
    else raises.
    """
    if q.device.type == "cpu" or plain:
        return flash_attn_ref(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd runs on cpu or cuda, got "
                         f"{q.device}")
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"the kernel needs H % Hkv == 0; got H={H}, "
                         f"Hkv={Hkv}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel needs D in {HEAD_DIMS}; got D={D}")
    check_tensor("q", q, torch.bfloat16, (B, S, H, D), dev)
    check_tensor("k", k, torch.bfloat16, (B, Skv, Hkv, D), dev)
    check_tensor("v", v, torch.bfloat16, (B, Skv, Hkv, D), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_aligned(name, t)
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, Skv, H, Hkv, D, S, Skv, int(causal), int(window),
                int(q_offset), D ** -0.5,
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_attn_fwd.launches += 1
    return out


flash_attn_fwd.launches = 0
