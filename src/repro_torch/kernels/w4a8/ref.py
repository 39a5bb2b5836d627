"""Plain PyTorch version of the w4a8 integer matmul kernel.

y = (x_q int8 @ w_q int4^T) * s_x * s_w (+ b)

``w_packed``: (N, K/2) uint8, two int4 per byte along K (see
``repro_torch.core.quantizer.pack_int4``). ``s_x``: (M, 1) per-token fp32.
``s_w``: (N,) per-output-channel fp32.

The integer accumulator is computed as fp32 matmuls of the integer
values: every int8 x int4 partial product and its running sum stays under
2^24 for K < 16512, so fp32 holds the exact integers whatever the
summation order (the caller keeps TF32 off on the card, PyTorch's
default for matmul). A longer K (qwen2-7b's and the qwen3 models' down
projections: 17408 to 25600) is summed in slices of ``K_SLICE``, each
exact in fp32, and the slices' int32 sums are added as integers (the
whole sum stays under 2^31 for K < 2^21). Scales multiply the completed accumulator in the
kernel's order, each product rounded on its own, so the result is bitwise
equal to the CUDA kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizer import unpack_int4


K_SLICE = 16384          # K * 127 * 8 < 2^24: an exact fp32 sum


def w4a8_accumulate_ref(x_q: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Exact (M, N) integer accumulator, as an int32 tensor."""
    K = x_q.shape[1]
    w_i8 = unpack_int4(w_packed)                         # (N, K)
    acc = None
    for k0 in range(0, K, K_SLICE):
        xs, ws = x_q[:, k0:k0 + K_SLICE], w_i8[:, k0:k0 + K_SLICE]
        part = torch.matmul(xs.float(), ws.float().T).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def w4a8_epilogue_ref(acc: torch.Tensor, s_x: torch.Tensor,
                      s_w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """``((f32)acc * s_x) * s_w (+ b)``, each step rounded alone, cast to
    ``out_dtype``: the kernel's epilogue (also applied on its own to an
    all-reduced accumulator by the row-parallel linear)."""
    y = acc.float() * s_x.float().reshape(-1, 1) * s_w.float().reshape(1, -1)
    if bias is not None:
        y = y + bias.float().reshape(1, -1)
    return y.to(out_dtype)


def w4a8_matmul_ref(x_q: torch.Tensor, w_packed: torch.Tensor,
                    s_x: torch.Tensor, s_w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    return w4a8_epilogue_ref(w4a8_accumulate_ref(x_q, w_packed), s_x, s_w,
                             bias, out_dtype)
