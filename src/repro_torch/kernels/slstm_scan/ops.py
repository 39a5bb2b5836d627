"""Wrapper for the sLSTM scan kernel.

``slstm_scan`` launches ``csrc/slstm_scan.cu`` for CUDA tensors and runs
the plain version (``ref.py``) for CPU tensors. It checks its inputs,
raises on what the kernel does not take and counts its calls in
``.launches`` (one per call; the kernel itself runs one launch per time
step on the current stream). The model calls it for every sLSTM forward
with quantization off and no gradient (``models.recurrent.slstm_fwd``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.checks import check_tensor
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 5 + (_I,) * 5 + (_P,)
DTYPES = (torch.bfloat16, torch.float32)
MAX_D = 6144                     # the kernel's shared-memory limit


@functools.lru_cache(maxsize=None)
def _fn():
    from repro_torch.kernels.build import load
    fn = load("slstm_scan").slstm_scan_launch
    fn.argtypes = list(_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def slstm_scan(gx: torch.Tensor, r_h: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, *, plain: bool = False):
    """gx (B,T,4d); r_h (d,4d); h0/c0 (B,d) -> (hs (B,T,d) in gx.dtype,
    hT (B,d) f32, cT (B,d) f32).

    CPU tensors, and every tensor when ``plain``, run the plain version.
    CUDA tensors launch the kernel, which takes contiguous bf16 or f32 gx
    and r_h and d <= 6144; anything else raises.
    """
    if gx.device.type == "cpu" or plain:
        return slstm_scan_ref(gx, r_h, h0, c0)
    if gx.device.type != "cuda":
        raise ValueError(f"slstm_scan runs on cpu or cuda, got {gx.device}")
    B, T, d4 = gx.shape
    d = d4 // 4
    dev = gx.device
    if d4 % 4 or d > MAX_D:
        raise ValueError(f"the kernel needs gx's last dim 4d with d <= "
                         f"{MAX_D}; got {d4}")
    if gx.dtype not in DTYPES or r_h.dtype not in DTYPES:
        raise TypeError(f"gx and r_h must be bf16 or f32, got {gx.dtype} "
                        f"and {r_h.dtype}")
    check_tensor("gx", gx, gx.dtype, (B, T, d4), dev)
    check_tensor("r_h", r_h, r_h.dtype, (d, d4), dev)
    if tuple(h0.shape) != (B, d) or tuple(c0.shape) != (B, d):
        raise ValueError(f"h0 and c0 must have shape {(B, d)}")
    hbuf = torch.empty((2, B, d), dtype=torch.float32, device=dev)
    hbuf[0].copy_(h0)
    c = c0.to(device=dev, dtype=torch.float32, copy=True).contiguous()
    hs = torch.empty((B, T, d), dtype=gx.dtype, device=dev)
    err = _fn()(gx.data_ptr(), r_h.data_ptr(), hbuf.data_ptr(),
                c.data_ptr(), hs.data_ptr(), B, T, d,
                int(gx.dtype == torch.bfloat16),
                int(r_h.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    slstm_scan.launches += 1
    return hs, hbuf[T % 2], c


slstm_scan.launches = 0
