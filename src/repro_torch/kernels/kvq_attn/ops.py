"""Wrapper for the quantized-KV flash-decode kernel.

``kvq_decode_attn`` launches the CUDA kernel (``csrc/kvq_decode_attn.cu``)
for CUDA tensors and runs the plain version (``ref.py``) for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.kvq_attn.ref import kvq_decode_attn_ref
from repro_torch.kernels.checks import check_aligned, check_tensor

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])
MAX_GROUP = 8       # query heads per KV head the kernel holds on chip
HEAD_DIMS = (64, 128)


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels.build import load
    lib = load("kvq_decode_attn")
    fn = lib.kvq_decode_attn_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kvq_decode_attn(q, k_q, v_q, s_k, s_v, lengths) -> torch.Tensor:
    """Decode attention over an int8 cache.

    q (B,H,D); k_q/v_q (B,Hkv,S,D) int8; s_k/s_v (B,Hkv,S) fp32;
    lengths (B,) int32. CPU tensors run the plain version. CUDA tensors
    launch the kernel, which takes a bf16 q, H % Hkv == 0 with at most
    8 query heads per KV head, and D of 64 or 128; anything else raises.
    """
    if q.device.type == "cpu":
        return kvq_decode_attn_ref(q, k_q, v_q, s_k, s_v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"kvq_decode_attn runs on cpu or cuda, got {q.device}")
    B, H, D = q.shape
    Hkv, S = k_q.shape[1], k_q.shape[2]
    dev = q.device
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"the kernel needs H % Hkv == 0 and H // Hkv <= "
                         f"{MAX_GROUP}; got H={H}, Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel needs D in {HEAD_DIMS}; got D={D}")
    check_tensor("q", q, torch.bfloat16, (B, H, D), dev)
    check_tensor("k_q", k_q, torch.int8, (B, Hkv, S, D), dev)
    check_tensor("v_q", v_q, torch.int8, (B, Hkv, S, D), dev)
    check_tensor("s_k", s_k, torch.float32, (B, Hkv, S), dev)
    check_tensor("s_v", s_v, torch.float32, (B, Hkv, S), dev)
    check_tensor("lengths", lengths, torch.int32, (B,), dev)
    check_aligned("k_q", k_q)
    check_aligned("v_q", v_q)
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    err = _lib()(q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(),
                 s_k.data_ptr(), s_v.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), B, H, Hkv, S, D, D ** -0.5,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"kvq_decode_attn kernel launch failed: CUDA "
                           f"error {err}")
    kvq_decode_attn.launches += 1
    return out


kvq_decode_attn.launches = 0
