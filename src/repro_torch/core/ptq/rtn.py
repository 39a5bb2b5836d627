"""Round-to-nearest PTQ baseline: calibrate scales, no training.

The weakest baseline in the paper's comparison set: per-output-channel
weight scales (the same convex-MSE calibration as SiLQ, isolating the
value of *training* from the value of *calibration*), percentile
activation scales from calibration data, then freeze. Produces a params
tree directly usable by the quantized forward (the format of a QAT
checkpoint, minus the learning).

The calibration forward needs no gradient, so on CUDA its attention runs
the flash kernel and its weight sites the fake-quant kernel.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.qat import (calibrate_weight_scales, make_ctx,
                                  merge_act_scales)
from repro_torch.data import to_device
from repro_torch.models import forward
from repro_torch.tree import tree_leaves


def rtn_quantize(cfg: ModelConfig, params: Dict, policy: PrecisionPolicy,
                 calib_batches: List[Dict], *,
                 wgt_method: str = "mse",
                 act_method: str = "quantile") -> Dict:
    """A new tree with calibrated ``s_w`` (and, for a static policy,
    ``s_in``/``s_q``/``s_k``/``s_v`` from ``calib_batches``, host batches
    of ``tokens``); other tensors are shared with ``params``."""
    params = calibrate_weight_scales(params, policy, wgt_method)
    if policy.enabled and policy.acts_static and calib_batches:
        ctx = make_ctx(policy, mode="calib", act_calib_method=act_method)
        dev = tree_leaves(params)[0].device
        stats = []
        with torch.no_grad():
            for b in calib_batches:
                batch = to_device({"tokens": b["tokens"]}, dev)
                stats.append(forward(cfg, params, ctx, batch,
                                     collect_stats=True)[1]["qstats"])
        params = merge_act_scales(params, stats, policy)
    return params
