"""Step functions of the QAT path: the train step (teacher forward, student
forward and backward, AdamW with LSQ scale updates) and the evaluation
loss.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.distill import next_token_loss, silq_loss
from repro_torch.core.precision import parse_policy
from repro_torch.core.qat import make_ctx
from repro_torch.models import forward
from repro_torch.optim import adamw_update, clip_by_global_norm, \
    cosine_schedule
from repro_torch.tree import tree_leaves, tree_map

MOE_AUX_COEF = 0.01     # weight of the MoE load-balance aux in the loss


def _text_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Drop a VLM's vision-prefix positions before the loss."""
    if cfg.family == "vlm" and cfg.vision_tokens:
        return logits[:, cfg.vision_tokens:]
    return logits


def grads_of(loss: torch.Tensor, params):
    """d loss / d params as a tree mirroring ``params``; ``None`` where no
    op read the leaf (the reference's zero cotangent; see
    ``optim/adamw.py``)."""
    leaves = tree_leaves(params)
    want = [p for p in leaves if p.requires_grad]
    got = iter(torch.autograd.grad(loss, want, allow_unused=True))
    grads = [next(got) if p.requires_grad else None for p in leaves]
    it = iter(grads)
    return tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    kernel_backend: str = "auto",
                    split_times: bool = False) -> Callable:
    """QAT train step, paper-faithful: teacher forward (unquantized, no
    grad), student forward with fake-quant, pure-KD loss (default), AdamW
    with LSQ scale updates (50x LR on activation scales), in place. An MoE
    config adds ``MOE_AUX_COEF`` times the load-balance aux to the loss; a
    VLM's loss skips its patch positions (``_text_logits``).

    ``kernel_backend="ref"`` runs the kernels' plain versions on any
    device. ``split_times`` synchronises the device between the three
    phases and returns their host ms under ``metrics["ms"]``. The step's
    loss and gradients alone are ``train_step.loss_and_grads(params,
    teacher_params, batch)``.
    """
    if tcfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={tcfg.grad_compression!r} belongs to the "
            "data-parallel path, which the port does not have yet")
    policy = parse_policy(tcfg.precision)
    ctx = make_ctx(policy, act_calib_method=tcfg.act_calib_method,
                   kernel_backend=kernel_backend)
    tctx = make_ctx("A16-C16-W16", mode="off", kernel_backend=kernel_backend)
    base_lr = tcfg.scaled_lr()
    remat = tcfg.remat != "none"

    def loss_and_grads(params, teacher_params, batch: Dict, mark=None):
        """The step's KD loss and its gradient tree, before clipping."""
        with torch.no_grad():
            t_logits = _text_logits(
                cfg, forward(cfg, teacher_params, tctx, batch)[0])
        if mark:
            mark()
        logits, aux = forward(cfg, params, ctx, batch, remat=remat)
        logits = _text_logits(cfg, logits)
        loss = silq_loss(logits, t_logits,
                         batch["labels"], kd_ratio=tcfg.kd_ratio,
                         kd_temperature=tcfg.kd_temperature,
                         mask=batch.get("loss_mask"))
        if cfg.is_moe:
            loss = loss + MOE_AUX_COEF * aux["moe_aux"]
        del logits, t_logits
        return loss.detach(), grads_of(loss, params)

    def train_step(params, teacher_params, opt_state, batch: Dict, step: int):
        marks = [time.perf_counter()]

        def mark():
            if split_times:
                if batch["tokens"].is_cuda:
                    torch.cuda.synchronize(batch["tokens"].device)
                marks.append(time.perf_counter())

        loss, grads = loss_and_grads(params, teacher_params, batch, mark)
        mark()
        if tcfg.grad_clip:
            clip_by_global_norm(grads, tcfg.grad_clip)
        lr = cosine_schedule(step, base_lr=base_lr,
                             total_steps=tcfg.total_steps,
                             warmup_steps=tcfg.warmup_steps,
                             min_lr_ratio=tcfg.min_lr_ratio)
        params, opt_state = adamw_update(
            params, grads, opt_state, lr=lr, beta1=tcfg.beta1,
            beta2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay,
            act_scale_lr_mult=tcfg.act_scale_lr_mult)
        mark()
        metrics = {"loss": loss, "lr": lr}
        if split_times:
            metrics["ms"] = {name: 1e3 * (b - a) for name, a, b in zip(
                ("teacher", "student", "optimizer"), marks, marks[1:])}
        return params, opt_state, metrics

    train_step.loss_and_grads = loss_and_grads
    return train_step


def make_eval_loss(cfg: ModelConfig, precision: str) -> Callable:
    """Next-token loss of the (fake-)quantized model, without a gradient
    (so its attention runs the flash kernel on CUDA)."""
    precision = precision or "A16-C16-W16"
    ctx = make_ctx(precision,
                   mode="train" if precision != "A16-C16-W16" else "off")

    def eval_loss(params, batch):
        with torch.no_grad():
            logits, _ = forward(cfg, params, ctx, batch)
            return next_token_loss(_text_logits(cfg, logits),
                                   batch["labels"],
                                   batch.get("loss_mask"))

    return eval_loss
