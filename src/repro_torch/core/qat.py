"""QAT integration: quantization context, site helpers, calibration flow
and the w4a8 deployment export.

Quantizer step sizes live inside the parameter dicts, under keys beginning
with ``s_`` next to the tensors they quantize::

    linear  = {"w": (d_in, d_out), ["b": (d_out,)],
               "s_w": (1, d_out),          # per-output-channel weight scale
               "s_in": ()}                 # per-tensor activation scale
    attn    = {... , "s_q": (), "s_k": (), "s_v": ()}   # query + cache sites

so the optimizer's parameter groups (no weight decay on scales; 50x LR on
*activation* scales, paper §3.1) and checkpointing are tree operations.

Modes:

* ``train`` — fake-quant active (LSQ for static scales, STE everywhere);
  also the forward the serving path runs under ``weights_layout="bf16"``
* ``calib`` — activation quantization observed, not applied: each site
  writes its |x| statistic into a collector dict mirroring the params
* ``off``   — no quantization (the fp16 teacher / baseline)
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch

from repro_torch.core import calibration as calib
from repro_torch.core.precision import PrecisionPolicy, parse_policy
from repro_torch.core.quantizer import (dynamic_fake_quant,
                                        dynamic_quantize_to_int, pack_int4,
                                        qbounds, quantize_to_int)
from repro_torch.kernels.quant.ops import lsq_fake_quant

# Param-dict keys holding quantizer step sizes
SCALE_KEYS = ("s_w", "s_in", "s_q", "s_k", "s_v", "s_state")
ACT_SCALE_KEYS = ("s_in", "s_q", "s_k", "s_v", "s_state")  # 50x LR boost set
_SITE_BITS = {
    "s_in": "act", "s_q": "query", "s_k": "cache", "s_v": "cache",
    "s_state": "cache", "s_w": "weight",
}
KERNEL_BACKENDS = ("auto", "ref")


@dataclass(frozen=True)
class QuantCtx:
    policy: PrecisionPolicy
    mode: str = "train"                  # train | calib | off
    act_calib_method: str = "quantile"   # quantile | max
    # Serving weight layout: "bf16" keeps fake-quant matmuls on bf16
    # params; "w4a8" routes every qlinear through the packed-int4 x int8
    # matmul (requires attach_w4a8_exports on the served tree — strict).
    weights_layout: str = "bf16"
    # "auto": CUDA tensors go through the hand-written kernels, CPU tensors
    # through their plain versions; "ref": the plain versions everywhere
    # (what chip_smoke.py holds the kernels' serving and training paths
    # against)
    kernel_backend: str = "auto"

    @property
    def off(self) -> bool:
        return self.mode == "off" or not self.policy.enabled

    def bits_for(self, site: str) -> int:
        kind = _SITE_BITS[site]
        p = self.policy
        return {"act": p.act_bits, "query": p.query_bits,
                "cache": p.cache_bits, "weight": p.weight_bits}[kind]

    def with_mode(self, mode: str) -> "QuantCtx":
        return replace(self, mode=mode)


def make_ctx(policy, mode: str = "train",
             act_calib_method: str = "quantile",
             weights_layout: str = "bf16",
             kernel_backend: str = "auto") -> QuantCtx:
    if isinstance(policy, str):
        policy = parse_policy(policy)
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"kernel_backend must be one of {KERNEL_BACKENDS}, "
                         f"got {kernel_backend!r}")
    return QuantCtx(policy=policy, mode=mode,
                    act_calib_method=act_calib_method,
                    weights_layout=weights_layout,
                    kernel_backend=kernel_backend)


# --------------------------------------------------------------------------
# Site helpers (called from model code)
# --------------------------------------------------------------------------

def subcol(col: Optional[Dict], key: str) -> Optional[Dict]:
    """Child collector dict mirroring the params structure (or None)."""
    if col is None:
        return None
    return col.setdefault(key, {})


def _stat(ctx: QuantCtx, x: torch.Tensor, bits: int) -> torch.Tensor:
    if ctx.act_calib_method == "max":
        return calib.act_max_stat(x, bits)
    if ctx.act_calib_method == "chan_max":
        # per-channel |x| maxima (SmoothQuant calibration)
        xf = torch.abs(x.float())
        return torch.amax(xf.reshape(-1, x.shape[-1]), dim=0)
    return calib.act_percentile_stat(x, bits)


def quantize_act(ctx: QuantCtx, x: torch.Tensor, p: Dict[str, Any], site: str,
                 col: Optional[Dict[str, Any]] = None,
                 bits: Optional[int] = None) -> torch.Tensor:
    """Quantize an activation-class site (``s_in``/``s_q``/``s_k``/``s_v``).

    ``p`` is the owning param dict (provides the learned scale in static
    mode); ``col`` is the calibration collector.
    """
    if ctx.off:
        return x
    bits = bits if bits is not None else ctx.bits_for(site)
    if bits >= 16 and site == "s_in":
        return x  # 16-bit body activations: disabled policy artifact
    if ctx.mode == "calib":
        if col is not None:
            col[site] = _stat(ctx, x, bits)
        return x
    if ctx.policy.act_dynamic:
        return dynamic_fake_quant(x, bits, axis=-1)
    return lsq_fake_quant(x, p[site], bits,
                          plain=ctx.kernel_backend == "ref")


def quantize_weight_p(ctx: QuantCtx, p: Dict[str, Any],
                      bits: Optional[int] = None,
                      key: str = "w") -> torch.Tensor:
    """Fake-quant a weight from its param dict (LSQ per-output-channel).

    The tied head's weight is ``embed.w.T``, a transposed view of the
    (vocab, d) table. It is quantized as the table itself, one scale per
    row (per vocab entry, the head's output channel), and the result is
    transposed back: no copy of the table is made, and the gradient
    reaches ``embed.w`` in its own layout.
    """
    w = p[key]
    if ctx.off:
        return w
    bits = bits if bits is not None else ctx.policy.weight_bits
    if bits >= 16:
        return w
    plain = ctx.kernel_backend == "ref"
    if w.dim() == 2 and not w.is_contiguous() and w.t().is_contiguous():
        return lsq_fake_quant(w.t(), p["s_w"].reshape(-1, 1), bits,
                              plain=plain).t()
    return lsq_fake_quant(w, p["s_w"], bits, plain=plain)


def qlinear(ctx: QuantCtx, x: torch.Tensor, p: Dict[str, Any],
            col: Optional[Dict[str, Any]] = None,
            act_bits: Optional[int] = None,
            weight_bits: Optional[int] = None) -> torch.Tensor:
    """Quantized linear: fake-quant input + weight, then matmul (+ bias).

    ``act_bits``/``weight_bits`` override the body policy for special sites
    (head: 8/8); ``col`` is the linear's calibration collector. Under
    ``weights_layout="w4a8"`` (outside calibration) the matmul instead
    consumes the packed int4 export attached next to this linear (see
    :func:`attach_w4a8_exports`) with per-token dynamic int8 activations.
    A missing export raises: a silent bf16 fallback would defeat the
    layout (weight-HBM streaming).
    """
    if ctx.weights_layout == "w4a8" and ctx.mode != "calib" and not ctx.off:
        exp = p.get("w4a8")
        if exp is None:
            raise ValueError(
                "weights_layout='w4a8' but this linear carries no packed "
                "export; run qat.attach_w4a8_exports(params, policy) on the "
                "served tree (keys present: %s)" % sorted(p.keys()))
        return w4a8_qlinear(ctx, x, exp)
    xq = quantize_act(ctx, x, p, "s_in", col, bits=act_bits)
    wq = quantize_weight_p(ctx, p, bits=weight_bits)
    y = torch.matmul(xq, wq)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def w4a8_qlinear(ctx: QuantCtx, x: torch.Tensor,
                 exp: Dict[str, Any]) -> torch.Tensor:
    """Packed-int4-weight x dynamic-int8-activation linear (serve hot path)."""
    from repro_torch.kernels.w4a8.ops import w4a8_linear
    return w4a8_linear(x, exp, out_dtype=x.dtype,
                       plain=ctx.kernel_backend == "ref")


def cache_dtype(ctx: QuantCtx):
    """Storage dtype for cache tensors under this policy."""
    if ctx.off or ctx.policy.cache_bits >= 16:
        return torch.bfloat16
    return torch.int8


def cache_quantize(ctx: QuantCtx, x: torch.Tensor, axis: int = -1):
    """Quantize a tensor for cache storage; returns (stored, scale).

    C16 / disabled policies store bf16 with unit scales (same cache
    structure either way, so serve code is policy-agnostic)."""
    if ctx.off or ctx.policy.cache_bits >= 16:
        s_shape = x.shape[:-1] + (1,) if axis in (-1, x.ndim - 1) else x.shape
        return x.to(torch.bfloat16), torch.ones(s_shape, dtype=torch.float32,
                                                device=x.device)
    return dynamic_quantize_to_int(x, ctx.policy.cache_bits, axis=axis)


# --------------------------------------------------------------------------
# Parameter-tree plumbing
# --------------------------------------------------------------------------

def is_scale_key(k) -> bool:
    return isinstance(k, str) and k.startswith("s_") and k in SCALE_KEYS


def scale_mask(params) -> Any:
    """Tree of bools: True on quantizer-scale leaves (no weight decay)."""
    return _mask_by_key(params, is_scale_key)


def act_scale_mask(params) -> Any:
    """True only on activation/cache/query scale leaves (50x LR boost)."""
    return _mask_by_key(params, lambda k: k in ACT_SCALE_KEYS)


def _all(tree, value):
    if isinstance(tree, dict):
        return {k: _all(v, value) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_all(v, value) for v in tree)
    return value


def _mask_by_key(tree, pred):
    if isinstance(tree, dict):
        return {k: (_all(v, True) if pred(k) else _mask_by_key(v, pred))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_mask_by_key(v, pred) for v in tree)
    return False


# --------------------------------------------------------------------------
# Calibration passes
# --------------------------------------------------------------------------

def calibrate_weight_scales(params, policy: PrecisionPolicy,
                            method: str = "mse"):
    """Recompute every ``s_w`` from its sibling ``w`` (Eq. 2 by default).

    Returns a new tree (tensors other than the new scales shared). The
    head is quantized at ``head_bits``; when embeddings are tied it has no
    ``w`` and its scale comes from the transposed embedding table.
    """
    if not policy.enabled:
        return params

    def walk(tree):
        if isinstance(tree, dict):
            out = dict(tree)
            if "w" in tree and "s_w" in tree:
                out["s_w"] = calib.weight_scale(tree["w"], policy.weight_bits,
                                                method=method)
            for k, v in tree.items():
                if isinstance(v, (dict, list, tuple)) and k != "w":
                    out[k] = walk(v)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    with torch.no_grad():
        out = walk(params)
        if isinstance(out, dict) and "head" in out and "s_w" in out["head"]:
            head = dict(out["head"])
            w_head = head["w"] if "w" in head else out["embed"]["w"].T
            head["s_w"] = calib.weight_scale(w_head, policy.head_bits,
                                             method=method)
            out["head"] = head
    return out


def _mean_stats(batches):
    first = batches[0]
    if isinstance(first, dict):
        return {k: _mean_stats([b[k] for b in batches]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_mean_stats([b[i] for b in batches])
                           for i in range(len(first)))
    total = first
    for b in batches[1:]:
        total = total + b
    return total / len(batches)


def merge_act_scales(params, stats_batches, policy: PrecisionPolicy):
    """Average per-batch calibration stats and write activation scales.

    ``stats_batches``: list of collector trees (same structure), each leaf
    a percentile landmark of |x|. Scale = landmark / b_u for the site's
    bits. Returns a new tree.
    """
    if not stats_batches:
        return params
    mean_stats = _mean_stats(stats_batches)

    def walk(p, s):
        if isinstance(p, dict):
            out = dict(p)
            for k, v in p.items():
                if isinstance(s, dict) and k in s:
                    if k in ACT_SCALE_KEYS:
                        out[k] = calib.act_scale_from_stat(
                            s[k].float(), _bits_of(policy, k)).to(v.dtype)
                    elif isinstance(v, (dict, list, tuple)):
                        out[k] = walk(v, s[k])
            return out
        if isinstance(p, (list, tuple)) and isinstance(s, (list, tuple)):
            return type(p)(walk(a, b) for a, b in zip(p, s))
        return p

    with torch.no_grad():
        return walk(params, mean_stats)


def _bits_of(policy: PrecisionPolicy, key: str) -> int:
    kind = _SITE_BITS[key]
    return {"act": policy.act_bits, "query": policy.query_bits,
            "cache": policy.cache_bits, "weight": policy.weight_bits}[kind]


# --------------------------------------------------------------------------
# Deployment export (real integers for the serving path / kernels)
# --------------------------------------------------------------------------

def export_linear_w4(p: Dict[str, Any], trained_bits: int = 4) -> Dict[str, Any]:
    """Pack one linear into the serve-path int4 layout.

    Returns ``{"wq": (d_out, d_in/2) uint8, "s_w": (1, d_out) f32,
    ["b"]}`` — what ``kernels.w4a8.ops.w4a8_linear`` consumes. Two scale
    fixups happen here:

    * a site trained at ``trained_bits > 4`` (the 8-bit head) is re-gridded
      onto the int4 lattice: ``s4 = s_trained * (q_max(trained) / 7)``
    * uncalibrated placeholder scales (all-ones) would quantize real
      weights to all-zeros, so exactly-1.0 channels fall back to
      per-channel absmax / 7
    """
    w = p["w"]
    if w.shape[-2] % 2:
        raise ValueError(f"int4 packing needs even d_in, got {w.shape[-2]}")
    raw = p["s_w"].float()
    qp_t = qbounds(trained_bits)[1]
    absmax = torch.amax(torch.abs(w.float()), dim=-2, keepdim=True)
    s4 = torch.where(raw == 1.0, torch.clamp_min(absmax / 7.0, 1e-9),
                     raw * (qp_t / 7.0))
    q = quantize_to_int(w, s4, 4)
    out = {"wq": pack_int4(q.transpose(-1, -2)).contiguous(), "s_w": s4}
    if "b" in p:
        out["b"] = p["b"]
    return out


def _is_linear(v) -> bool:
    return isinstance(v, dict) and "w" in v and "s_w" in v


def attach_w4a8_exports(params, policy: PrecisionPolicy):
    """Attach a packed ``"w4a8"`` export inside every served linear dict.

    Returns a new tree (input dicts untouched; tensors shared). Every dict
    with ``w``/``s_w`` siblings is a linear and packs at
    ``policy.weight_bits``' lattice (re-gridded to int4). The head packs at
    ``policy.head_bits``; when embeddings are tied it has no ``w`` and
    exports from the transposed embedding table.
    """
    if not policy.enabled:
        raise ValueError("w4a8 export needs a quantized policy "
                         f"(got {policy.name})")

    def walk(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if _is_linear(v):
                    nv = dict(v)
                    nv["w4a8"] = export_linear_w4(v, policy.weight_bits)
                    out[k] = nv
                elif isinstance(v, (dict, list, tuple)):
                    out[k] = walk(v)
                else:
                    out[k] = v
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    out = walk(params)
    if isinstance(out, dict) and "head" in out and "s_w" in out["head"]:
        head = dict(out["head"])
        hp = {"w": head["w"] if "w" in head else out["embed"]["w"].T,
              "s_w": head["s_w"]}
        if "b" in head:
            hp["b"] = head["b"]
        head["w4a8"] = export_linear_w4(hp, policy.head_bits)
        out["head"] = head
    return out


def drop_exported_weights(params):
    """Drop the bf16 ``w`` of every linear that carries a w4a8 export.

    The w4a8 forward never reads them, so a full-width server can free
    them once the exports exist (the tied embedding stays: the embedding
    lookup reads it). Returns a new tree; the input dicts are untouched.
    """
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()
                    if not (k == "w" and "w4a8" in tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree
    return walk(params)


def w4a8_weight_bytes(params) -> Dict[str, int]:
    """Weight-streaming accounting for an export-attached tree.

    ``packed``: bytes the w4a8 serve path reads per full forward (wq + s_w +
    b of every export); ``replaced``: bytes the bf16 layout would have
    streamed for the same matmuls (the tied head counts the embedding
    table).
    """
    packed = replaced = 0

    def walk(tree):
        nonlocal packed, replaced
        if isinstance(tree, dict):
            if "w4a8" in tree:
                for leaf in tree["w4a8"].values():
                    packed += leaf.numel() * leaf.element_size()
                if "w" in tree:
                    replaced += tree["w"].numel() * tree["w"].element_size()
                if "b" in tree:
                    replaced += tree["b"].numel() * tree["b"].element_size()
            for v in tree.values():
                if isinstance(v, (dict, list, tuple)):
                    walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)

    walk(params)
    if (isinstance(params, dict) and "head" in params
            and "w4a8" in params.get("head", {})
            and "w" not in params["head"] and "embed" in params):
        w = params["embed"]["w"]
        replaced += w.numel() * w.element_size()
    return {"packed": packed, "replaced": replaced}


# --------------------------------------------------------------------------
# Parameter init
# --------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, dtype=torch.bfloat16,
                scale: Optional[float] = None) -> Dict:
    """Random linear on ``gen``'s device, with placeholder quantizer scales
    (all-ones ``s_w``: the w4a8 export falls back to absmax / 7)."""
    dev = gen.device
    std = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=dev) * std
    p = {"w": w.to(dtype),
         "s_w": torch.ones((1, d_out), dtype=torch.float32, device=dev),
         "s_in": torch.tensor(1.0, dtype=torch.float32, device=dev)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p
