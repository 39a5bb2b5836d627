"""Wrapper for the w4a8 matmul kernel: the deployed quantized linear.

``w4a8_matmul`` launches the CUDA kernel (``csrc/w4a8_matmul.cu``) for
CUDA tensors and runs the plain version (``ref.py``) for CPU tensors. The
kernel's C launcher picks its route by M (weight streaming below
``prefill_min_m()``, the int8 tensor cores from there); both give the
same bits. ``w4a8_matmul_route`` forces one route, for the checks and
timings that hold the two against each other.
``w4a8_linear(x, exported)`` takes bf16 activations, quantizes them per
token to int8 (token-dynamic A8d deployment) and runs the matmul.
``exported`` is the dict from ``repro_torch.core.qat.export_linear_w4``.

The row-parallel linear of tensor-parallel serving
(``w4a8_linear_row``) splits the kernel in two: ``w4a8_accumulate``
(the kernel's accumulator-out mode: int32 sums, no epilogue) over the
rank's K slice, an exact integer all-reduce of the sums, and
``w4a8_epilogue`` (a kernel of the same source) on the total. The
per-token amax is all-reduced (MAX) before the slice is quantized, so
its scale is the whole row's. The result is bitwise the tp=1 linear's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.quantizer import (dynamic_quantize_to_int,
                                        quantize_by_amax)
from repro_torch.kernels.checks import check_aligned, check_tensor
from repro_torch.kernels.w4a8.ref import (w4a8_accumulate_ref,
                                          w4a8_epilogue_ref, w4a8_matmul_ref)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ACC_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_EPI_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
# the launcher's route argument: by M (the serving path), or one forced
ROUTES = {"auto": 0, "decode": 1, "mma": 2}


@functools.lru_cache(maxsize=None)
def _lib_fn(name: str, argtypes: tuple):
    """A launcher of ``csrc/w4a8_matmul.cu`` with its ctypes signature."""
    from repro_torch.kernels.build import load
    fn = getattr(load("w4a8_matmul"), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def prefill_min_m() -> int:
    """The least M the kernel runs on the tensor cores (as its source
    states it; below it the decode route streams the weights)."""
    from repro_torch.kernels.build import load
    fn = load("w4a8_matmul").w4a8_matmul_prefill_min_m
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def w4a8_matmul(x_q: torch.Tensor, w_packed: torch.Tensor, s_x: torch.Tensor,
                s_w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x_q (M, K) int8, w_packed (N, K/2) uint8, s_x (M, 1) f32,
    s_w (N,) f32, bias (N,) or None -> (M, N) ``out_dtype``.

    CPU tensors run the plain version. CUDA tensors launch the kernel,
    which takes f32 scales and bias, bf16 output, K % 32 == 0 and K up to
    65536 (the launcher refuses more); anything else raises.
    """
    if x_q.device.type == "cpu":
        return w4a8_matmul_ref(x_q, w_packed, s_x, s_w, bias, out_dtype)
    return w4a8_matmul_route(x_q, w_packed, s_x, s_w, bias, out_dtype,
                             "auto")


def w4a8_matmul_route(x_q, w_packed, s_x, s_w, bias=None,
                      out_dtype=torch.bfloat16, route="auto"):
    """:func:`w4a8_matmul` on CUDA tensors through one route of the
    kernel: ``"auto"`` (by M, what :func:`w4a8_matmul` launches),
    ``"decode"`` or ``"mma"`` at any M. Counts in ``w4a8_matmul.launches``
    like every launch of the kernel."""
    if route not in ROUTES:
        raise ValueError(f"route is one of {sorted(ROUTES)}, got {route!r}")
    if x_q.device.type != "cuda":
        raise ValueError(f"w4a8_matmul runs on cpu or cuda, got {x_q.device}")
    M, K = x_q.shape
    N = w_packed.shape[0]
    dev = x_q.device
    if out_dtype != torch.bfloat16:
        raise TypeError("the w4a8 kernel writes bf16 output only")
    if K % 32:
        raise ValueError(f"the w4a8 kernel needs K % 32 == 0, got K={K}")
    check_tensor("x_q", x_q, torch.int8, (M, K), dev)
    check_tensor("w_packed", w_packed, torch.uint8, (N, K // 2), dev)
    check_tensor("s_x", s_x, torch.float32, (M, 1), dev)
    check_tensor("s_w", s_w, torch.float32, (N,), dev)
    if bias is not None:
        check_tensor("bias", bias, torch.float32, (N,), dev)
    check_aligned("x_q", x_q)
    check_aligned("w_packed", w_packed)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    err = _lib_fn("w4a8_matmul_launch", tuple(_ARGTYPES))(
        x_q.data_ptr(), w_packed.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), M, N, K,
        ROUTES[route], torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"w4a8_matmul kernel launch failed: CUDA error "
                           f"{err}")
    w4a8_matmul.launches += 1
    return out


w4a8_matmul.launches = 0


def _check_operands(x_q, w_packed):
    if x_q.device.type != "cuda":
        raise ValueError(f"the w4a8 kernels run on cuda, got {x_q.device}")
    M, K = x_q.shape
    N = w_packed.shape[0]
    if K % 32:
        raise ValueError(f"the w4a8 kernel needs K % 32 == 0, got K={K}")
    check_tensor("x_q", x_q, torch.int8, (M, K), x_q.device)
    check_tensor("w_packed", w_packed, torch.uint8, (N, K // 2), x_q.device)
    check_aligned("x_q", x_q)
    check_aligned("w_packed", w_packed)
    return M, N, K


def w4a8_accumulate(x_q: torch.Tensor, w_packed: torch.Tensor,
                    route: str = "auto") -> torch.Tensor:
    """x_q (M, K) int8, w_packed (N, K/2) uint8 -> the exact (M, N) int32
    sums ``x_q . w^T``. CPU tensors run the plain version
    (``w4a8_accumulate_ref``); CUDA tensors launch the kernel's
    accumulator-out mode by ``route`` (as :func:`w4a8_matmul_route`).
    Counts in ``w4a8_accumulate.launches``."""
    if x_q.device.type == "cpu":
        return w4a8_accumulate_ref(x_q, w_packed)
    if route not in ROUTES:
        raise ValueError(f"route is one of {sorted(ROUTES)}, got {route!r}")
    M, N, K = _check_operands(x_q, w_packed)
    acc = torch.empty((M, N), dtype=torch.int32, device=x_q.device)
    err = _lib_fn("w4a8_accumulate_launch", tuple(_ACC_ARGTYPES))(
        x_q.data_ptr(), w_packed.data_ptr(), acc.data_ptr(), M, N, K,
        ROUTES[route], torch.cuda.current_stream(x_q.device).cuda_stream)
    if err:
        raise RuntimeError(f"w4a8_accumulate kernel launch failed: CUDA "
                           f"error {err}")
    w4a8_accumulate.launches += 1
    return acc


w4a8_accumulate.launches = 0


def w4a8_epilogue(acc: torch.Tensor, s_x: torch.Tensor, s_w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """acc (M, N) int32, s_x (M, 1) f32, s_w (N,) f32, bias (N,) f32 or
    None -> ``bf16(((f32)acc * s_x) * s_w (+ b))``, the matmul's
    epilogue on its own. CPU tensors run the plain version; CUDA tensors
    launch the epilogue kernel (bf16 output only). Counts in
    ``w4a8_epilogue.launches``."""
    if acc.device.type == "cpu":
        return w4a8_epilogue_ref(acc, s_x, s_w, bias, out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"w4a8_epilogue runs on cpu or cuda, got "
                         f"{acc.device}")
    if out_dtype != torch.bfloat16:
        raise TypeError("the w4a8 epilogue writes bf16 output only")
    M, N = acc.shape
    dev = acc.device
    check_tensor("acc", acc, torch.int32, (M, N), dev)
    check_tensor("s_x", s_x, torch.float32, (M, 1), dev)
    check_tensor("s_w", s_w, torch.float32, (N,), dev)
    if bias is not None:
        check_tensor("bias", bias, torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    err = _lib_fn("w4a8_epilogue_launch", tuple(_EPI_ARGTYPES))(
        acc.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), M, N,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"w4a8_epilogue kernel launch failed: CUDA "
                           f"error {err}")
    w4a8_epilogue.launches += 1
    return out


w4a8_epilogue.launches = 0


def w4a8_linear(x: torch.Tensor, exported: dict, out_dtype=torch.bfloat16,
                plain: bool = False) -> torch.Tensor:
    """Deployed quantized linear over arbitrary leading dims.

    ``plain`` runs the plain version whatever the device (the card's
    reference run in ``chip_smoke.py``); otherwise :func:`w4a8_matmul`
    picks by device.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    x_q, s_x = dynamic_quantize_to_int(x2, 8, axis=-1)
    s_w = exported["s_w"].reshape(-1)
    b = exported.get("b")
    if plain:
        y = w4a8_matmul_ref(x_q, exported["wq"], s_x, s_w, b, out_dtype)
    else:
        y = w4a8_matmul(x_q, exported["wq"], s_x, s_w,
                        None if b is None else b.float(), out_dtype)
    return y.reshape(*lead, -1)


def w4a8_linear_row(x: torch.Tensor, exported: dict, comm,
                    out_dtype=torch.bfloat16,
                    plain: bool = False) -> torch.Tensor:
    """The row-parallel deployed linear of tensor-parallel serving: ``x``
    holds this rank's slice of the input features (the rank's heads or
    d_ff columns) and ``exported`` the rank's K slice of the packed
    weight (``s_w`` and ``b`` whole). In order: the per-token amax of
    the slice, ``all_reduce(MAX)`` of it (the whole row's scale), the
    slice quantized with it, the int32 accumulator over the slice,
    ``all_reduce(SUM)`` of the accumulators (exact), and the epilogue
    once on the total, the bias added once. Bitwise the tp=1
    :func:`w4a8_linear`: no scaled partial is ever summed.
    ``comm``: a ``runtime.collectives.TPComm``. ``plain`` runs the plain
    versions whatever the device."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    comm.all_reduce_max(amax)
    x_q, s_x = quantize_by_amax(xf, amax, 8)
    wq = exported["wq"]
    acc = (w4a8_accumulate_ref(x_q, wq) if plain
           else w4a8_accumulate(x_q, wq))
    comm.all_reduce_sum(acc)
    s_w = exported["s_w"].reshape(-1)
    b = exported.get("b")
    if plain:
        y = w4a8_epilogue_ref(acc, s_x, s_w, b, out_dtype)
    else:
        y = w4a8_epilogue(acc, s_x, s_w.float(),
                          None if b is None else b.float(), out_dtype)
    return y.reshape(*lead, -1)
