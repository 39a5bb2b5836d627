"""SmoothQuant PTQ baseline (Xiao et al., 2023), as compared in Table 1.

Per-channel smoothing factors migrate activation outliers into the weights
before round-to-nearest quantization::

    s_j = max|X_j|^alpha / max|W_j|^(1-alpha)        (SiLQ App. D: alpha=0.4)
    X' = X / s   - folded into the producing norm's scale
    W' = W * s   - folded into the consuming linear's rows

Folding sites follow the reference implementation: attention input norm
-> wq/wk/wv, MLP input norm -> wg/wu; for the xLSTM blocks the
(norm -> input projection) pairs. Per-channel activation maxima come from
calibration batches through the ``chan_max`` statistic. The fold runs
the reference's f32 operations in its order, so a fold from the same
maxima gives the same bits.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import (ATTENTION_BLOCKS, BLOCK_MLSTM,
                                      BLOCK_RGLRU, BLOCK_SLSTM, ModelConfig)
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.ptq.rtn import rtn_quantize
from repro_torch.core.qat import make_ctx
from repro_torch.data import to_device
from repro_torch.models import forward
from repro_torch.tree import tree_leaves, tree_map


def _get(tree, path: str):
    for k in path.split("/"):
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def collect_chan_maxima(cfg: ModelConfig, params: Dict,
                        calib_batches: List[Dict]) -> Dict:
    """Stats tree (``{"layers": [...], "head": ...}``) whose ``s_in``
    leaves are per-channel |x| maxima over ``calib_batches``.

    The calibration forward fake-quantizes weights with the scales the
    tree carries, as the reference's does (a teacher's placeholder
    all-ones ``s_w`` rounds its 4-bit body weights to zero there)."""
    ctx = make_ctx("A8s-C8-W4", mode="calib", act_calib_method="chan_max")
    dev = tree_leaves(params)[0].device
    agg = None
    with torch.no_grad():
        for b in calib_batches:
            batch = to_device({"tokens": b["tokens"]}, dev)
            stats = forward(cfg, params, ctx, batch,
                            collect_stats=True)[1]["qstats"]
            agg = stats if agg is None else tree_map(torch.maximum, agg,
                                                     stats)
    return agg


# (norm key, linear keys smoothing-folded against it) per block kind; an
# MoE block's ln2 has no pair (the reference folds nothing into its
# router or experts)
def _pairs_for(kind: str, blk: Dict):
    if kind in ATTENTION_BLOCKS:
        pairs = [("ln1", ["attn/wq", "attn/wk", "attn/wv"])]
        if "mlp" in blk:
            pairs.append(("ln2", ["mlp/wg", "mlp/wu"]))
        return pairs
    if kind == BLOCK_RGLRU:
        return [("ln1", ["rglru/w_in", "rglru/w_gate"]),
                ("ln2", ["mlp/wg", "mlp/wu"])]
    if kind == BLOCK_MLSTM:
        return [("ln1", ["cell/w_up"])]
    if kind == BLOCK_SLSTM:
        return [("ln1", ["cell/w_x"])]
    return []


def _fold_with(cfg: ModelConfig, params: Dict, alpha: float,
               stats: Optional[Dict]) -> Dict:
    """Fold smoothing factors from ``stats`` (per-channel maxima, as
    :func:`collect_chan_maxima` returns them; None: the norm weights'
    magnitudes stand in) into a new tree; tensors not folded are shared."""
    params = tree_map(lambda x: x, params)   # fresh containers
    out_dtype = params["embed"]["w"].dtype
    with torch.no_grad():
        for i, kind in enumerate(cfg.layer_kinds()):
            blk = params["layers"][i]
            blk_stats = stats["layers"][i] if stats else None
            for norm_key, lin_keys in _pairs_for(kind, blk):
                if norm_key not in blk:
                    continue
                lins = [(k, _get(blk, k)) for k in lin_keys]
                lins = [(k, l) for k, l in lins if l is not None]
                if not lins:
                    continue
                nw = blk[norm_key]["w"].float()                   # (d,)
                # activation per-channel maxima: measured, else norm proxy
                act_max = None
                if blk_stats is not None:
                    st = _get(blk_stats, lin_keys[0])
                    if isinstance(st, dict) and "s_in" in st:
                        act_max = st["s_in"].float()
                if act_max is None:
                    act_max = torch.abs(nw)
                act_max = torch.clamp_min(act_max, 1e-5)
                w_max = torch.clamp_min(torch.amax(torch.stack(
                    [torch.amax(torch.abs(l["w"].float()), dim=-1)
                     for _, l in lins]), dim=0), 1e-5)        # (d,)
                s = torch.clamp(act_max ** alpha / w_max ** (1.0 - alpha),
                                1e-3, 1e3)
                blk[norm_key]["w"] = (nw / s).to(out_dtype)
                for k, lin in lins:
                    lin["w"] = (lin["w"].float() * s[:, None]).to(
                        lin["w"].dtype)
    return params


def fold_smoothing(cfg: ModelConfig, params: Dict, alpha: float,
                   calib_batches: List[Dict]) -> Dict:
    """Returns a new params tree with smoothing folded in."""
    stats = (collect_chan_maxima(cfg, params, calib_batches)
             if calib_batches else None)
    return _fold_with(cfg, params, alpha, stats)


def smoothquant_quantize(cfg: ModelConfig, params: Dict,
                         policy: PrecisionPolicy,
                         calib_batches: List[Dict],
                         alpha: float = 0.4) -> Dict:
    """Full SmoothQuant pipeline: fold smoothing, then RTN quantize."""
    params = fold_smoothing(cfg, params, alpha, calib_batches)
    return rtn_quantize(cfg, params, policy, calib_batches)
