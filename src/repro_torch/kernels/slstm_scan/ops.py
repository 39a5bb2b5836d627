"""Wrapper for the sLSTM scan kernel.

``slstm_scan`` launches ``csrc/slstm_scan.cu`` for CUDA tensors and runs
the plain version (``ref.py``) for CPU tensors. It checks its inputs,
raises on what the kernel does not take and counts its calls in
``.launches``. The kernel has two routes, picked by the launcher's rule
(``route_for`` asks it which): resident, one cooperative launch a call
with each CTA's slice of r_h in shared memory (xlstm-125m's d 768), and
step, one launch per time step (d up to ``MAX_D``); ``route=`` forces
one. A call allocates its state buffers and the resident route's grid
barrier counter (``BAR_INTS`` int32, zeroed on the stream), so it can be
captured in a CUDA graph and runs on any stream. ``carry`` picks the
function, on both routes and in the plain version: "f32" (h and the sums
in f32, the TPU kernel's) or "gx" (the reference model's cell: h carried
in gx's dtype, ``h . r_h`` and its add to gx rounded to it; see
``ref.py``). The model calls it with ``carry="gx"`` for every sLSTM
forward with quantization off and no gradient
(``models.recurrent.slstm_fwd``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.checks import check_tensor
from repro_torch.kernels.slstm_scan.ref import CARRIES, slstm_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 8 + (_P,)
_ROUTE_ARGTYPES = (_I,) * 4
DTYPES = (torch.bfloat16, torch.float32)
MAX_D = 6144                     # the step route's shared-memory limit
BAR_INTS = 1                     # the grid barrier's counter
ROUTES = {"auto": 0, "resident": 1, "step": 2}


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels.build import load
    lib = load("slstm_scan")
    lib.slstm_scan_launch.argtypes = list(_ARGTYPES)
    lib.slstm_scan_launch.restype = ctypes.c_int
    lib.slstm_scan_route.argtypes = list(_ROUTE_ARGTYPES)
    lib.slstm_scan_route.restype = ctypes.c_int
    return lib


def _fn():
    return _lib().slstm_scan_launch


def route_for(d: int, gx_dtype=torch.bfloat16,
              r_dtype=torch.bfloat16, carry: str = "f32") -> str:
    """The route the launcher takes for width ``d`` on the current CUDA
    device: "resident" or "step"."""
    r = _lib().slstm_scan_route(d, int(gx_dtype == torch.bfloat16),
                                int(r_dtype == torch.bfloat16),
                                int(carry == "gx"))
    if r < 0:
        raise RuntimeError(f"slstm_scan_route failed: CUDA error {-r}")
    return "resident" if r == 1 else "step"


def slstm_scan(gx: torch.Tensor, r_h: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, *, carry: str = "f32",
               plain: bool = False, route: str = "auto"):
    """gx (B,T,4d); r_h (d,4d); h0/c0 (B,d) -> (hs (B,T,d) in gx.dtype,
    hT (B,d), cT (B,d) f32); hT is f32 under ``carry="f32"`` and in
    gx.dtype under ``carry="gx"``.

    CPU tensors, and every tensor when ``plain``, run the plain version.
    CUDA tensors launch the kernel, which takes contiguous bf16 or f32 gx
    and r_h and d <= 6144; anything else raises. ``route`` is "auto" (the
    launcher's rule), "resident" (raises where it does not fit) or "step".
    """
    if route not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)}, got "
                         f"{route!r}")
    if carry not in CARRIES:
        raise ValueError(f"carry must be one of {CARRIES}, got {carry!r}")
    if gx.device.type == "cpu" or plain:
        return slstm_scan_ref(gx, r_h, h0, c0, carry)
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
    gx_carry = carry == "gx"
    hbuf = torch.empty((2, B, d), dtype=torch.float32, device=dev)
    hbuf[0].copy_(h0.to(gx.dtype) if gx_carry else h0)
    c = c0.to(device=dev, dtype=torch.float32, copy=True).contiguous()
    hs = torch.empty((B, T, d), dtype=gx.dtype, device=dev)
    bar = torch.zeros(BAR_INTS, dtype=torch.int32, device=dev)
    _launch(gx, r_h, hbuf, c, hs, bar, ROUTES[route], gx_carry)
    slstm_scan.launches += 1
    hT = hbuf[T % 2]
    return hs, hT.to(gx.dtype) if gx_carry else hT, c


def _launch(gx, r_h, hbuf, c, hs, bar, route: int,
            gx_carry: bool = False) -> None:
    """Check the barrier scratch and the route, then call the launcher."""
    if bar.dtype != torch.int32 or bar.numel() < BAR_INTS \
            or not bar.is_contiguous() or bar.device != gx.device:
        raise ValueError(f"the grid barrier needs {BAR_INTS} contiguous "
                         f"int32 on {gx.device}; got {bar.numel()} "
                         f"{bar.dtype} on {bar.device}")
    if route not in ROUTES.values():
        raise ValueError(f"route must be one of {sorted(ROUTES.values())}, "
                         f"got {route}")
    B, T, d4 = gx.shape
    err = _fn()(gx.data_ptr(), r_h.data_ptr(), hbuf.data_ptr(),
                c.data_ptr(), hs.data_ptr(), bar.data_ptr(), bar.numel(),
                B, T, d4 // 4, int(gx.dtype == torch.bfloat16),
                int(r_h.dtype == torch.bfloat16), int(gx_carry), route,
                torch.cuda.current_stream(gx.device).cuda_stream)
    if err:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")


slstm_scan.launches = 0
