"""Step functions of the QAT path: the train step (teacher forward, student
forward and backward, on a mesh the gradient syncs, AdamW with LSQ scale
updates) and the evaluation loss.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ATTENTION_BLOCKS, ModelConfig, \
    TrainConfig
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


def attn_shard_mode_for(cfg: ModelConfig, model_axis: int) -> str:
    """The attention's sharding for this arch on a model axis of
    ``model_axis`` ranks (the reference's rule): "" where the KV heads
    divide it (heads cut, no collective in the attention), "kv_rep"
    where only the query heads do (K/V replicated, q heads cut), "seq"
    otherwise (the query sequence cut)."""
    if model_axis <= 1 or cfg.n_kv_heads % model_axis == 0:
        return ""
    if cfg.n_heads % model_axis == 0:
        return "kv_rep"
    return "seq"


def data_comm(mesh):
    """The data axis's ``DPComm`` of ``mesh``, or None at data 1 (no
    mesh)."""
    if mesh is None or int(mesh.shape.get("data", 1)) == 1:
        return None
    from repro_torch.runtime.collectives import DPComm
    return DPComm(mesh)


def model_axis(mesh) -> int:
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def check_model_axis(cfg: ModelConfig, m: int, attn_mode: str,
                     seq_len: int = 0) -> None:
    """Refuse what training at model ``m`` > 1 does not run: the
    families whose sharded backward is not ported (each a ROADMAP Queue
    1 item) and widths ``m`` does not divide."""
    if m <= 1:
        return
    refused = (("an MoE", cfg.is_moe, "2b.5"),
               ("a recurrent arch", any(k not in ATTENTION_BLOCKS
                                        for k in cfg.block_pattern), "2b.6"),
               ("an encoder-decoder", cfg.is_encdec, "2b.7"),
               ("a VLM", cfg.family == "vlm", "2b.8"))
    for what, hit, item in refused:
        if hit:
            raise NotImplementedError(
                f"training {cfg.name!r} at model > 1: {what}'s sharded "
                f"backward is not ported (ROADMAP Queue 1 item {item}); "
                "the dense attention decoders train at model > 1")
    from repro_torch.runtime.sharding import TRAIN_MODES
    if attn_mode not in TRAIN_MODES:
        raise ValueError(f"attn_shard_mode is one of {TRAIN_MODES}, got "
                         f"{attn_mode!r}")
    need = [("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)]
    if attn_mode == "":
        need += [("n_kv_heads", cfg.n_kv_heads), ("n_heads", cfg.n_heads)]
    elif attn_mode == "kv_rep":
        need += [("n_heads", cfg.n_heads), ("kv_dim", cfg.kv_dim)]
    elif seq_len:
        need += [("seq_len", seq_len)]
    bad = [f"{k}={v}" for k, v in need if v % m]
    if bad:
        raise ValueError(f"training at model={m} in attention mode "
                         f"{attn_mode!r} needs {', '.join(bad)} divisible "
                         f"by {m}")


def model_comm(cfg: ModelConfig, mesh, attn_mode: str, seq_len: int = 0):
    """The model axis's ``TPComm`` of ``mesh``, or None at model 1;
    refuses what :func:`check_model_axis` refuses."""
    m = model_axis(mesh)
    if m == 1:
        return None
    check_model_axis(cfg, m, attn_mode, seq_len)
    from repro_torch.runtime.collectives import TPComm
    return TPComm(mesh)


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
                    split_times: bool = False, mesh=None,
                    attn_shard_mode: Optional[str] = None) -> Callable:
    """QAT train step, paper-faithful: teacher forward (unquantized, no
    grad), student forward with fake-quant, pure-KD loss (default), AdamW
    with LSQ scale updates (50x LR on activation scales), in place. An MoE
    config adds ``MOE_AUX_COEF`` times the load-balance aux to the loss; a
    VLM's loss skips its patch positions (``_text_logits``).

    ``kernel_backend="ref"`` runs the kernels' plain versions on any
    device. ``split_times`` synchronises the device between the phases
    and returns their host ms under ``metrics["ms"]`` (teacher, student,
    tp, sync, optimizer; ``tp`` the model axis's collectives, taken out
    of the teacher's and student's phases, and its gradient sum). The
    step's loss and gradients alone (synced on a mesh) are
    ``train_step.loss_and_grads(params, teacher_params, batch)``.

    ``mesh``: a ``launch.mesh.Mesh`` of ``data`` replicas of ``model``
    ranks, each rank called with its data replica's rows of the global
    batch (``runtime.sharding.shard_batch``) and, at model > 1, the
    student, teacher and optimizer state cut by
    ``runtime.sharding.shard_train_state`` in the attention mode
    ``attn_shard_mode`` (the reference's argument; by default
    :func:`attn_shard_mode_for`). The step then computes the one-process
    step on the global batch, as the reference's step jitted over the
    mesh does.

    On the data axis each rank's loss is its share of the global mean
    (global denominators, ``core.distill``), an MoE aux is the global
    batch's, and after the backward every gradient is summed over the
    data ranks in f32 buckets (``DPComm.sync_grads``), so clipping, the
    LSQ scale updates and AdamW run on the same bits on every rank and
    the replicas stay bitwise equal. ``metrics["loss"]`` is the global
    loss. With ``tcfg.grad_compression="int8"`` the sync is
    ``runtime.compression.compressed_psum`` of the gradients times
    ``data`` (their mean is the global gradient), with an f32 error
    feedback per rank held by the step (``train_step.error_feedback``).
    That residual is rank-local and not in the replicated checkpoint:
    ``train_step.reset_error_feedback()`` zeroes it, which a restore
    does. Without a data axis ``grad_compression`` is ignored, as the
    reference's step ignores it.

    On the model axis (``TPComm``, ``QuantCtx.attn_mode``) the model code
    runs the rank's part of every layer (``models.blocks``) and gathers
    the logits, so every model rank computes the whole loss; the global
    denominators stay the data axis's. After the backward the leaves a
    rank reads on its part only (``runtime.sharding.partial_grad``) are
    summed over the model ranks (``TPComm.sum_grads``), before the data
    sync; the clip's norm sums the shards' squares over the model ranks
    (``optim.clip_by_global_norm``). The replicated leaves then hold the
    same bits on every model rank. Refused at model > 1: the MoE,
    recurrent, encoder-decoder and VLM families (``check_model_axis``).
    """
    if tcfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression is 'none' or 'int8', got "
                         f"{tcfg.grad_compression!r}")
    m = model_axis(mesh)
    mode = (attn_shard_mode if attn_shard_mode is not None
            else attn_shard_mode_for(cfg, m))
    tp = model_comm(cfg, mesh, mode, tcfg.seq_len)
    dp = data_comm(mesh)
    compress = dp is not None and tcfg.grad_compression == "int8"
    policy = parse_policy(tcfg.precision)
    attn_mode = mode if tp is not None else None
    ctx = make_ctx(policy, act_calib_method=tcfg.act_calib_method,
                   kernel_backend=kernel_backend, dp=dp, tp=tp,
                   attn_mode=attn_mode)
    tctx = make_ctx("A16-C16-W16", mode="off", kernel_backend=kernel_backend,
                    tp=tp, attn_mode=attn_mode)
    base_lr = tcfg.scaled_lr()
    remat = tcfg.remat != "none"
    state = {"err": None, "partial": None}

    def local_loss_and_grads(params, teacher_params, batch: Dict,
                             mark=None):
        """This rank's loss (the global one on a mesh) and its own
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

    def partial_mask(grads):
        """Per leaf (in order): whether it is summed over the model
        ranks (``runtime.sharding.partial_grad``), memoised."""
        if state["partial"] is None:
            from repro_torch.bridge import flatten
            from repro_torch.runtime.sharding import partial_grad
            state["partial"] = [partial_grad(k, mode)
                                for k, _ in flatten(grads)]
        return state["partial"]

    def tp_sum(grads):
        """The partial leaves summed over the model ranks."""
        if tp is None:
            return grads
        leaves = tree_leaves(grads)
        mask = partial_mask(grads)
        summed = iter(tp.sum_grads([g for g, p in zip(leaves, mask) if p]))
        out = [next(summed) if p else g for g, p in zip(leaves, mask)]
        it = iter(out)
        return tree_map(lambda _: next(it), grads)

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
        """The step's KD loss and its gradient tree (on a mesh: the
        global loss and the gradients summed over the model ranks where
        partial, then synced over the data ranks), before clipping."""
        loss, grads = local_loss_and_grads(params, teacher_params, batch,
                                           mark)
        if mark:
            mark()
        grads = tp_sum(grads)
        if mark:
            mark()
        return loss, sync(grads)

    def sharded_mask(params):
        """Per leaf: whether this rank holds a shard of it (a cut dim)."""
        if state.get("cut") is None:
            from repro_torch.bridge import flatten
            from repro_torch.runtime.sharding import train_whole_leaf
            state["cut"] = [not train_whole_leaf(k, mode)
                            and _is_cut(cfg, mesh, k, v)
                            for k, v in flatten(params)]
        return state["cut"]

    def train_step(params, teacher_params, opt_state, batch: Dict, step: int):
        marks = [time.perf_counter()]
        tp_ms = []

        def mark():
            if split_times:
                if batch["tokens"].is_cuda:
                    torch.cuda.synchronize(batch["tokens"].device)
                marks.append(time.perf_counter())
                if tp is not None:
                    tp_ms.append(tp.ms)

        if tp is not None:
            tp.timed, tp.ms = split_times, 0.0
        loss, grads = loss_and_grads(params, teacher_params, batch, mark)
        mark()
        if tcfg.grad_clip:
            if tp is None:
                clip_by_global_norm(grads, tcfg.grad_clip)
            else:
                clip_by_global_norm(grads, tcfg.grad_clip,
                                    sharded=sharded_mask(params), comm=tp)
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
            # marks: start, teacher, student, model-axis sum, data sync,
            # optimizer; the model axis's collectives inside the teacher
            # and student phases move to "tp"
            d = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
            c = [0.0] * 5
            if tp is not None:
                c = [tp_ms[0], tp_ms[1] - tp_ms[0], tp_ms[2] - tp_ms[1],
                     0.0, 0.0]
                tp.timed = False
            metrics["ms"] = {"teacher": d[0] - c[0],
                             "student": d[1] - c[1],
                             "tp": c[0] + c[1] + d[2],
                             "sync": d[3], "optimizer": d[4]}
        return params, opt_state, metrics

    def reset_error_feedback():
        state["err"] = None

    train_step.loss_and_grads = loss_and_grads
    train_step.local_loss_and_grads = local_loss_and_grads
    train_step.sync = sync
    train_step.tp_sum = tp_sum
    train_step.sharded_mask = sharded_mask
    train_step.reset_error_feedback = reset_error_feedback
    train_step.error_feedback = lambda: state["err"]
    train_step.dp = dp
    train_step.tp = tp
    train_step.attn_mode = attn_mode
    return train_step


def _is_cut(cfg: ModelConfig, mesh, path: str, t: torch.Tensor) -> bool:
    """Whether a training rank's leaf ``t`` is its cut of the whole leaf:
    the rules put "model" on a dim of the whole leaf, whose size there is
    ``m`` times this rank's (the rules cut a dim only where ``m`` divides
    it, and :func:`check_model_axis` refuses widths it does not)."""
    from repro_torch.runtime.sharding import param_spec
    m = model_axis(mesh)
    for dim in range(t.dim()):
        whole = list(t.shape)
        whole[dim] *= m
        if param_spec(cfg, mesh, path, tuple(whole))[dim] == "model":
            return True
    return False


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
