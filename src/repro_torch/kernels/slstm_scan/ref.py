"""Plain PyTorch version of the sLSTM scan kernel, in two modes.

``carry="f32"`` is the sequential f32 recurrence of the TPU kernel

    g_t = f32(gx_t) + h_{t-1} @ f32(r_h),  gates (i, f, z, o) = split(g, 4)
    c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(z)
    h_t = sigmoid(o) * tanh(c_t)

with ``h`` and ``c`` kept in f32 throughout, ``hs`` written in
``gx.dtype`` and the final ``hT``/``cT`` in f32 (the counterpart of the
reference's ``kernels/slstm_scan/ref.py:slstm_scan_ref``).

``carry="gx"`` is the reference model's cell
(``models/recurrent.py:_slstm_cell``), which carries ``h`` in gx's dtype:

    rh  = rnd(h_{t-1} @ f32(r_h))        the f32 sums rounded once
    g_t = f32(rnd(f32(gx_t) + f32(rh)))  the add rounded to gx's dtype
    c_t, h_t as above in f32, then h_t = rnd(h_t)

where ``rnd`` rounds to gx's dtype; ``hs`` is the carried ``h`` and
``hT`` comes back in gx's dtype, ``cT`` in f32. With f32 gx every
``rnd`` is the identity and the two modes are the same function.
"""
from __future__ import annotations

import torch

CARRIES = ("f32", "gx")


def slstm_scan_ref(gx: torch.Tensor, r_h: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor, carry: str = "f32"):
    """gx (B,T,4d); r_h (d,4d); h0/c0 (B,d) -> (hs (B,T,d), hT, cT)."""
    if carry not in CARRIES:
        raise ValueError(f"carry must be one of {CARRIES}, got {carry!r}")
    d = h0.shape[-1]
    rf = r_h.float()
    h, c = h0.float(), c0.float()
    if carry == "gx":
        h = h.to(gx.dtype)
    hs = []
    for t in range(gx.shape[1]):
        if carry == "gx":
            rh = (h.float() @ rf).to(gx.dtype)
            g = (gx[:, t].float() + rh.float()).to(gx.dtype).float()
        else:
            g = gx[:, t].float() + h @ rf
        i, f, z, o = torch.split(g, d, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        if carry == "gx":
            h = h.to(gx.dtype)
        hs.append(h)
    if not hs:
        return gx.new_zeros(gx.shape[:2] + (d,)), h, c
    return torch.stack(hs, dim=1).to(gx.dtype), h, c
