"""Model stack of the dense GQA decoder (the qwen2.5 family).

The reference scans stacked layers with ``lax.scan``; here each layer is
an entry of ``params["layers"]`` and the stack is a Python loop over them.

Entry points:
* ``init_params``  — random weights from a seed, made on the target device
* ``prefill``      — forward over the prompt + the quantized serving cache
* ``decode_step``  — one token against the quantized cache (in place)
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import BLOCK_ATTN, ModelConfig
from repro_torch.core.qat import QuantCtx, cache_dtype, qlinear
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.common import init_norm, rms_norm, rope_tables


def _check_supported(cfg: ModelConfig) -> None:
    if (any(k != BLOCK_ATTN for k in cfg.block_pattern) or cfg.sliding_window
            or cfg.norm_type != "rms" or cfg.mlp_type != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name!r}: the port serves dense full-attention RMS-norm "
            "SwiGLU decoders only")


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                dtype=torch.bfloat16) -> Dict:
    """Random parameters drawn from a ``torch.Generator`` on ``device``
    (``cuda`` unless told otherwise), so a full-width model never passes
    through host memory."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        dtype=torch.float32, device=dev) * 0.02
    params: Dict = {
        "embed": {"w": embed.to(dtype)},
        "final_norm": init_norm(cfg.d_model, dev, dtype),
        "layers": [{"ln1": init_norm(cfg.d_model, dev, dtype),
                    "attn": B.init_attention(cfg, gen, dtype),
                    "ln2": init_norm(cfg.d_model, dev, dtype),
                    "mlp": B.init_mlp(cfg, gen, dtype)}
                   for _ in range(cfg.n_layers)],
    }
    del embed
    if cfg.tie_embeddings:
        # the tied head still owns its quantizer scales (8-bit head site)
        params["head"] = {
            "s_w": torch.ones((1, cfg.vocab_size), dtype=torch.float32,
                              device=dev),
            "s_in": torch.tensor(1.0, dtype=torch.float32, device=dev)}
    else:
        from repro_torch.core.qat import init_linear
        params["head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                     dtype=dtype)
    return params


def head_logits(cfg: ModelConfig, params: Dict, ctx: QuantCtx,
                x: torch.Tensor) -> torch.Tensor:
    hb = ctx.policy.head_bits
    if cfg.tie_embeddings:
        p = {"w": params["embed"]["w"].T, "s_w": params["head"]["s_w"],
             "s_in": params["head"]["s_in"]}
        if "w4a8" in params["head"]:
            # packed export of embed.w.T (attach_w4a8_exports tied case)
            p["w4a8"] = params["head"]["w4a8"]
    else:
        p = params["head"]
    return qlinear(ctx, x, p, act_bits=hb, weight_bits=hb)


def _ffn_tail(cfg: ModelConfig, ctx: QuantCtx, p: Dict,
              x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + B.mlp_fwd(cfg, ctx, p["mlp"], h)


def prefill(cfg: ModelConfig, params: Dict, ctx: QuantCtx, batch: Dict,
            cache_budget: int = 0):
    """Forward pass that also emits the quantized serving cache.

    ``batch["tokens"]`` (B, S); ``batch["lengths"]`` (B,) optionally marks
    the valid prefix of right-padded rows: logits are taken at each row's
    last real token and the cache records true lengths. ``cache_budget``:
    cache capacity (>= prompt length). Returns (logits (B, 1, V),
    {"layers": [per-layer cache], "position": (B,)}).
    """
    _check_supported(cfg)
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    x = params["embed"]["w"][tokens]
    Bn, S = tokens.shape
    hd = cfg.resolved_head_dim
    rope = None
    if cfg.rope_theta:
        rope = rope_tables(torch.arange(S, device=x.device), hd,
                           cfg.rope_theta)
    caches = []
    for p in params["layers"]:
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, c = B.attn_prefill(cfg, ctx, p["attn"], h, rope,
                              cache_len=cache_budget or S, lengths=lengths)
        x = _ffn_tail(cfg, ctx, p, x + a)
        caches.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if lengths is None:
        x_last = x[:, -1:]
        position = torch.full((Bn,), S, dtype=torch.int32, device=x.device)
    else:
        idx = torch.clamp_min(lengths.long() - 1, 0)
        x_last = torch.gather(
            x, 1, idx[:, None, None].expand(Bn, 1, x.shape[-1]))
        position = lengths.to(torch.int32, copy=True)
    logits = head_logits(cfg, params, ctx, x_last)
    return logits, {"layers": caches, "position": position}


def decode_step(cfg: ModelConfig, params: Dict, ctx: QuantCtx,
                tokens1: torch.Tensor, cache: Dict):
    """One decode step. tokens1 (B, 1) -> (logits (B, 1, V), cache).

    The cache is updated in place (each layer's new K/V row, lengths and
    ``position``) and returned.
    """
    positions = cache["position"]
    x = params["embed"]["w"][tokens1]
    for p, c in zip(params["layers"], cache["layers"]):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = B.attn_decode(cfg, ctx, p["attn"], h, c, positions)
        x = _ffn_tail(cfg, ctx, p, x + a)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(cfg, params, ctx, x)
    cache["position"] += 1
    return logits, cache


def init_cache(cfg: ModelConfig, ctx: QuantCtx, batch_size: int,
               cache_len: int, *, device) -> Dict:
    """Blank dense serving cache with capacity ``cache_len`` per slot."""
    _check_supported(cfg)
    qdt = cache_dtype(ctx)
    return {"layers": [B.init_attn_cache(cfg, batch_size, cache_len,
                                         device=device, dtype=qdt)
                       for _ in range(cfg.n_layers)],
            "position": torch.zeros((batch_size,), dtype=torch.int32,
                                    device=device)}


def clone_cache(cache: Dict) -> Dict:
    """Deep copy of a serving cache (decode_step mutates its argument)."""
    return {"layers": [{k: v.clone() for k, v in c.items()}
                       for c in cache["layers"]],
            "position": cache["position"].clone()}
