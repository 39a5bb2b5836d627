"""Step functions of the QAT path: the train step (teacher forward, student
forward and backward, on a data axis the gradient sync, AdamW with LSQ
scale updates) and the evaluation loss.
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
from repro_torch.runtime.compression import (compressed_psum,
                                             init_error_feedback, wire_bytes)
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


def data_comm(mesh):
    """The data axis's ``DPComm`` of ``mesh``, or None at data 1 (no
    mesh). Training at model > 1 raises: the reference's ``kv_rep`` /
    ``seq`` attention modes (``launch/steps.py:attn_shard_mode_for``) are
    not ported (ROADMAP Queue 1 item 2b)."""
    if mesh is None:
        return None
    if int(mesh.shape.get("model", 1)) != 1:
        raise NotImplementedError(
            f"training on a mesh {mesh.shape}: model > 1 is not ported "
            "(ROADMAP Queue 1 item 2b)")
    if int(mesh.shape.get("data", 1)) == 1:
        return None
    from repro_torch.runtime.collectives import DPComm
    return DPComm(mesh)


def global_denom(dp, batch: Dict, shape) -> torch.Tensor:
    """The global batch's loss denominator, summed over the data ranks:
    the mask count, or B·T of ``shape`` (the loss's (B, T)) unmasked;
    at least 1, as the local mean clamps it."""
    mask = batch.get("loss_mask")
    dev = batch["tokens"].device
    if mask is None:
        n = torch.tensor(float(shape[0] * shape[1]), dtype=torch.float32,
                         device=dev)
    else:
        n = torch.sum(mask.float())
    return torch.clamp_min(dp.all_reduce_sum(n), 1.0)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    kernel_backend: str = "auto",
                    split_times: bool = False, mesh=None) -> Callable:
    """QAT train step, paper-faithful: teacher forward (unquantized, no
    grad), student forward with fake-quant, pure-KD loss (default), AdamW
    with LSQ scale updates (50x LR on activation scales), in place. An MoE
    config adds ``MOE_AUX_COEF`` times the load-balance aux to the loss; a
    VLM's loss skips its patch positions (``_text_logits``).

    ``kernel_backend="ref"`` runs the kernels' plain versions on any
    device. ``split_times`` synchronises the device between the phases
    and returns their host ms under ``metrics["ms"]`` (teacher, student,
    sync, optimizer). The step's loss and gradients alone (synced on a
    data axis) are ``train_step.loss_and_grads(params, teacher_params,
    batch)``.

    ``mesh``: a ``launch.mesh.Mesh`` of ``data`` > 1 replicas (model 1),
    each rank called with its rows of the global batch
    (``runtime.sharding.shard_batch``). The step then computes the one-
    process step on the global batch, as the reference's step jitted
    over a data axis does: each rank's loss is its share of the global
    mean (global denominators, ``core.distill``), an MoE aux is the
    global batch's, and after the backward every gradient is summed over
    the ranks in f32 buckets (``DPComm.sync_grads``), so clipping, the
    LSQ scale updates and AdamW run on the same bits on every rank and
    the replicas stay bitwise equal. ``metrics["loss"]`` is the global
    loss. With ``tcfg.grad_compression="int8"`` the sync is
    ``runtime.compression.compressed_psum`` of the gradients times
    ``data`` (their mean is the global gradient), with an f32 error
    feedback per rank held by the step (``train_step.error_feedback``).
    That residual is rank-local and not in the replicated checkpoint:
    ``train_step.reset_error_feedback()`` zeroes it, which a restore
    does. Without a mesh (data 1) ``grad_compression`` is ignored, as the
    reference's step ignores it.
    """
    if tcfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression is 'none' or 'int8', got "
                         f"{tcfg.grad_compression!r}")
    dp = data_comm(mesh)
    compress = dp is not None and tcfg.grad_compression == "int8"
    policy = parse_policy(tcfg.precision)
    ctx = make_ctx(policy, act_calib_method=tcfg.act_calib_method,
                   kernel_backend=kernel_backend, dp=dp)
    tctx = make_ctx("A16-C16-W16", mode="off", kernel_backend=kernel_backend)
    base_lr = tcfg.scaled_lr()
    remat = tcfg.remat != "none"
    state = {"err": None}

    def local_loss_and_grads(params, teacher_params, batch: Dict,
                             mark=None):
        """This rank's loss (the global one on a data axis) and its own
        gradient tree, before any sync."""
        with torch.no_grad():
            t_logits = _text_logits(
                cfg, forward(cfg, teacher_params, tctx, batch)[0])
        if mark:
            mark()
        logits, aux = forward(cfg, params, ctx, batch, remat=remat)
        logits = _text_logits(cfg, logits)
        denom = (global_denom(dp, batch, logits.shape[:2])
                 if dp is not None else None)
        loss = silq_loss(logits, t_logits,
                         batch["labels"], kd_ratio=tcfg.kd_ratio,
                         kd_temperature=tcfg.kd_temperature,
                         mask=batch.get("loss_mask"), denom=denom)
        report = loss.detach()
        if dp is not None:
            report = dp.all_reduce_sum(report.clone())
        if cfg.is_moe:
            # on a data axis every rank holds the global aux: its
            # gradient reaches each rank's own tokens once
            loss = loss + MOE_AUX_COEF * aux["moe_aux"]
            report = report + MOE_AUX_COEF * aux["moe_aux"].detach()
        del logits, t_logits
        return report, grads_of(loss, params)

    def sync(grads):
        """The gradient tree summed (exact) or averaged (int8) over the
        data ranks: the global batch's gradient on every rank."""
        if dp is None:
            return grads
        leaves = tree_leaves(grads)
        if compress:
            if state["err"] is None:
                state["err"] = init_error_feedback(leaves)
            scaled = [None if g is None else g.float() * dp.size
                      for g in leaves]
            synced, state["err"] = compressed_psum(scaled, state["err"],
                                                   dp.group)
            del scaled
            synced = [None if g is None else s.to(g.dtype)
                      for s, g in zip(synced, leaves)]
            dp.wire["int8"] += wire_bytes(
                [g.numel() for g in leaves if g is not None], dp.size,
                "int8")
        else:
            synced = dp.sync_grads(leaves)
        it = iter(synced)
        return tree_map(lambda _: next(it), grads)

    def loss_and_grads(params, teacher_params, batch: Dict, mark=None):
        """The step's KD loss and its gradient tree (on a data axis: the
        global loss and the synced gradients), before clipping."""
        loss, grads = local_loss_and_grads(params, teacher_params, batch,
                                           mark)
        if mark:
            mark()
        return loss, sync(grads)

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
                ("teacher", "student", "sync", "optimizer"), marks,
                marks[1:])}
        return params, opt_state, metrics

    def reset_error_feedback():
        state["err"] = None

    train_step.loss_and_grads = loss_and_grads
    train_step.local_loss_and_grads = local_loss_and_grads
    train_step.sync = sync
    train_step.reset_error_feedback = reset_error_feedback
    train_step.error_feedback = lambda: state["err"]
    train_step.dp = dp
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
