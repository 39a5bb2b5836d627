"""Plain PyTorch version of the sLSTM scan kernel: the sequential f32
recurrence

    g_t = f32(gx_t) + h_{t-1} @ f32(r_h),  gates (i, f, z, o) = split(g, 4)
    c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(z)
    h_t = sigmoid(o) * tanh(c_t)

with ``h`` and ``c`` kept in f32 throughout, ``hs`` written in
``gx.dtype`` and the final ``hT``/``cT`` in f32 (the counterpart of the
reference's ``kernels/slstm_scan/ref.py:slstm_scan_ref``).
"""
from __future__ import annotations

import torch


def slstm_scan_ref(gx: torch.Tensor, r_h: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor):
    """gx (B,T,4d); r_h (d,4d); h0/c0 (B,d) -> (hs (B,T,d), hT, cT)."""
    d = h0.shape[-1]
    rf = r_h.float()
    h, c = h0.float(), c0.float()
    hs = []
    for t in range(gx.shape[1]):
        g = gx[:, t].float() + h @ rf
        i, f, z, o = torch.split(g, d, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    if not hs:
        return gx.new_zeros(gx.shape[:2] + (d,)), h, c
    return torch.stack(hs, dim=1).to(gx.dtype), h, c
