"""AdamW with SiLQ parameter groups (paper Appendix B).

beta1=0.9, beta2=0.95, eps=1e-10; weight decay 0.1 on matrix weights only
— never on quantizer step sizes, norms or biases; activation-quantizer
scales (``s_in``/``s_q``/``s_k``/``s_v``/``s_state``) get a 50x learning
rate (paper §3.1 / Table 4 ``Act Lrx``). Moments are f32 whatever the
parameter's type.

Where the reference returns new trees, the update here runs in place
under ``torch.no_grad()``: each parameter and moment tensor is written
over, so a step holds no second copy of the parameters (3.09 B of them at
qwen2.5-3b). Gradients come as a tree mirroring the params; a ``None``
leaf (a scale that no op read, e.g. ``s_in`` under dynamic activations)
counts as zeros, as the reference's zero cotangent does: its moments
decay and its step count advances with the rest.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.qat import act_scale_mask, scale_mask
from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d
    m: Any
    v: Any


def clip_by_global_norm(grads, max_norm: float, sharded=None, comm=None):
    """Scale the gradient tree in place so its global L2 norm is at most
    ``max_norm``; returns (grads, norm). ``None`` leaves count as zeros.

    On a tensor-parallel rank ``sharded`` (bools in leaf order) marks the
    leaves that are this rank's shards: their squares are summed over the
    model ranks (``comm``, a ``TPComm``: one f32 all-reduce), and every
    other leaf, whole and the same on every rank, is counted once, so
    each rank scales by the same norm, the whole tree's."""
    leaves = tree_leaves(grads)
    gs = [g for g in leaves if g is not None]
    with torch.no_grad():
        if comm is None:
            sq = sum(torch.sum(torch.square(g.float())) for g in gs)
        else:
            parts = [[], []]
            for g, cut in zip(leaves, sharded):
                if g is not None:
                    parts[bool(cut)].append(torch.sum(torch.square(
                        g.float())))
            dev = gs[0].device
            cut_sq = torch.stack(parts[1]).sum() if parts[1] else \
                torch.zeros((), device=dev)
            cut_sq = comm.all_reduce_sum_f32(cut_sq.reshape(1))[0]
            sq = cut_sq + sum(parts[0])
        norm = torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))
        scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
        for g in gs:
            g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=tree_map(torch.clone, zeros))


def _decay_mask(params):
    """True where weight decay applies: >=2-D tensors that are not scales."""
    return tree_map(lambda p, is_s: p.dim() >= 2 and not is_s, params,
                    scale_mask(params))


def _f32(x: float) -> float:
    return float(np.float32(x))


def adamw_update(params, grads, state: AdamWState, *, lr,
                 beta1: float = 0.9, beta2: float = 0.95,
                 eps: float = 1e-10, weight_decay: float = 0.1,
                 act_scale_lr_mult: float = 50.0):
    """One AdamW step, in place; returns (params, state) for the
    reference's call shape. ``lr`` is a float or a 0-d tensor."""
    lr = float(lr)
    with torch.no_grad():
        step = state.step + 1
        n = int(step)
        # bias corrections in f32, as the reference's ``beta ** f32(step)``
        b1c = _f32(np.float32(1.0) - np.float32(beta1) ** np.float32(n))
        b2c = _f32(np.float32(1.0) - np.float32(beta2) ** np.float32(n))
        for p, g, m, v, dec, bst in zip(
                tree_leaves(params), tree_leaves(grads),
                tree_leaves(state.m), tree_leaves(state.v),
                tree_leaves(_decay_mask(params)),
                tree_leaves(act_scale_mask(params))):
            gf = torch.zeros_like(m) if g is None else g.float()
            m.mul_(beta1).add_((1 - beta1) * gf)
            v.mul_(beta2).add_((1 - beta2) * gf * gf)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            if dec:
                upd = upd + weight_decay * p.float()
            g_lr = _f32(lr * act_scale_lr_mult) if bst else lr
            p.copy_((p.float() - g_lr * upd).to(p.dtype))
        state.step.copy_(step)
    return params, state

