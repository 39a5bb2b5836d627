"""Gradient compression for the cross-replica all-reduce: the reference's
``runtime/compression.py`` over a ``torch.distributed`` process group.

Each gradient leaf is quantized to int8 with one scale a leaf, shared by
every replica (the leaves' amaxes go in one MAX all-reduce of the stacked
scalars, which is bitwise a MAX per leaf), and exchanged as **int8
payloads** (``all_gather``); every rank then sums the payloads in f32 in
rank order (integers, exact in any order) and dequantizes. The f32
residual ``new_err`` is fed back into the next step's gradient, so the
quantization bias does not accumulate (error-feedback SGD).

Bytes a rank receives per leaf of N elements over R replicas:
    f32 ring all-reduce:   ~2 * 4N * (R - 1) / R
    int8 all-gather:       (R - 1) * N
(:func:`wire_bytes`).

The math is the reference's step for step: ``gf = f32(g) + e``, ``scale =
max(amax / 127, 1e-12)``, ``q = int8(clip(round(gf / scale), -127,
127))``, ``new_e = gf - f32(q) * scale``, ``g_sync = sum(f32(q_r)) *
scale / R`` cast to ``g``'s type: the **mean** over the replicas.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def init_error_feedback(grads: Any) -> Any:
    """Zero f32 residuals shaped like ``grads`` (None stays None)."""
    return tree_map(lambda g: None if g is None else torch.zeros(
        g.shape, dtype=torch.float32, device=g.device), grads)


def wire_bytes(numels: List[int], n: int, kind: str) -> int:
    """Bytes one rank receives to sync leaves of ``numels`` elements over
    ``n`` replicas: ``"f32"`` the ring all-reduce's ``2 * 4N (n-1)/n``,
    ``"int8"`` the payload all-gather's ``(n - 1) N`` plus the stacked
    amax MAX (4 bytes a leaf, through the same ring)."""
    if n <= 1:
        return 0
    total = sum(numels)
    if kind == "f32":
        return 2 * 4 * total * (n - 1) // n
    if kind == "int8":
        return (n - 1) * total + 2 * 4 * len(numels) * (n - 1) // n
    raise ValueError(f"kind is 'f32' or 'int8', got {kind!r}")


def compressed_psum(grads: Any, err: Any,
                    group=None) -> Tuple[Any, Any]:
    """int8-payload mean-all-reduce with error feedback over ``group``
    (None: the default group). ``grads`` and ``err`` are trees of the
    same structure (``err`` f32; a None gradient leaf is passed through
    with its residual). Returns (mean gradients, new residuals). Every
    rank gets the same bits: the scales come from one MAX, the payloads
    are gathered whole and summed in rank order."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    gl, el = tree_leaves(grads), tree_leaves(err)
    live = [i for i, g in enumerate(gl) if g is not None]
    out: List[Optional[torch.Tensor]] = list(gl)
    new_err: List[Optional[torch.Tensor]] = list(el)
    if live:
        # gf is formed twice (the same f32 sum), so one leaf's f32 copy is
        # alive at a time rather than every leaf's
        amax = torch.stack([torch.max(torch.abs(gl[i].float() + el[i]))
                            for i in live])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        for j, i in enumerate(live):
            gf = gl[i].float() + el[i]
            scale = torch.clamp_min(amax[j] / 127.0, 1e-12)
            q = torch.clamp(torch.round(gf / scale), -127, 127).to(
                torch.int8)
            new_err[i] = gf - q.float() * scale
            del gf
            parts = [torch.empty_like(q) for _ in range(n)]
            dist.all_gather(parts, q, group=group)
            acc = parts[0].float()
            for p in parts[1:]:
                acc += p.float()
            out[i] = (acc * scale / n).to(gl[i].dtype)
    it_g, it_e = iter(out), iter(new_err)
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_e), err))
