"""End-to-end QAT training driver (SiLQ §3.1 flow).

Flow: (1) pretrain the fp16 teacher on the synthetic mixture, (2) clone it
as the student, (3) calibrate weight step sizes (convex-MSE, Eq. 2) and,
for static activation policies, activation step sizes (percentile over 5
batches), (4) train end to end with the pure-KD loss, LSQ scale learning
(50x LR on activation scales), cosine LR and AdamW, (5) checkpoint and
resume with heartbeats (``--simulate-failure-at`` exercises it). On a
mesh of ranks (``run_qat(mesh=...)``, started by ``launch.mesh.spawn``:
data replicas of model ranks) every step is the one-process step on the
global batch.

    python -m repro_torch.launch.train --device cpu --steps 2 \\
        --teacher-steps 2 --batch-size 2 --seq-len 32

runs the reduced config on the CPU; without ``--device`` it runs on
``cuda`` (``--full`` for the full-size config).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.distill import next_token_loss
from repro_torch.core.precision import parse_policy
from repro_torch.core.ptq.rtn import rtn_quantize
from repro_torch.core.qat import make_ctx
from repro_torch.data import (MixtureIterator, ShardedLoader,
                              SyntheticConfig, calibration_batches)
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (data_comm, global_denom, grads_of,
                                     make_train_step, model_axis)
from repro_torch.models import forward, init_params
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.runtime.fault import HeartbeatFile
from repro_torch.tree import tree_leaves, tree_map


def make_teacher_pretrain_step(cfg, lr: float = 1e-3, mesh=None):
    """Next-token training of the unquantized teacher (attention under
    autograd: ``blockwise_attention``). On a data axis (``mesh``) each
    rank's loss is its share of the global batch's mean and the
    gradients are summed over the ranks in f32 before clipping, as in
    the QAT step (``launch.steps.make_train_step``)."""
    ctx = make_ctx("A16-C16-W16", mode="off")
    dp = data_comm(mesh)

    def step_fn(params, opt_state, batch):
        logits, _ = forward(cfg, params, ctx, batch)
        denom = (global_denom(dp, batch, logits.shape[:2])
                 if dp is not None else None)
        loss = next_token_loss(logits, batch["labels"],
                               batch.get("loss_mask"), denom)
        del logits
        grads = grads_of(loss, params)
        loss = loss.detach()
        if dp is not None:
            loss = dp.all_reduce_sum(loss.clone())
            leaves = dp.sync_grads(tree_leaves(grads))
            it = iter(leaves)
            grads = tree_map(lambda _: next(it), grads)
        clip_by_global_norm(grads, 1.0)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr,
                                         weight_decay=0.0)
        return params, opt_state, loss

    return step_fn


def _trainable(params):
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def pretrain_teacher(cfg, data_cfg: SyntheticConfig, steps: int, seed: int,
                     device, mesh=None):
    """Give the synthetic-data teacher something to teach. Returns the
    teacher with ``requires_grad`` off."""
    params = _trainable(init_params(cfg, seed=seed, device=device))
    opt = adamw_init(params)
    step_fn = make_teacher_pretrain_step(cfg, mesh=mesh)
    it = ShardedLoader(MixtureIterator(data_cfg), mesh=mesh, device=device)
    loss = float("nan")
    for i in range(steps):
        params, opt, loss = step_fn(params, opt, next(it))
        if i % 50 == 0:
            print(f"  teacher step {i}: ntp-loss {float(loss):.4f}",
                  flush=True)
    print(f"  teacher final ntp-loss {float(loss):.4f}", flush=True)
    del opt
    for p in tree_leaves(params):
        p.requires_grad_(False)
    return params


def calibrate(cfg, params, tcfg: TrainConfig, data_cfg: SyntheticConfig):
    """Paper §3.1: weight scales via convex-MSE; activation scales via
    percentile over calibration batches (static policies only): the RTN
    baseline's calibration. Its forward needs no gradient, so its
    attention runs the flash kernel on CUDA."""
    policy = parse_policy(tcfg.precision)
    batches = (calibration_batches(data_cfg, tcfg.calib_batches)
               if policy.enabled and policy.acts_static else [])
    return rtn_quantize(cfg, params, policy, batches,
                        wgt_method=tcfg.wgt_calib_method,
                        act_method=tcfg.act_calib_method)


def run_qat(arch: str, tcfg: TrainConfig, *, reduced: bool = True,
            teacher_steps: int = 200, ckpt_dir: Optional[str] = None,
            resume: bool = False, log_every: int = 20,
            heartbeat_dir: Optional[str] = None, worker: int = 0,
            simulate_failure_at: int = -1, eval_every: int = 0,
            eval_fn=None, device=None, ckpt_every: int = 100,
            n_layers: Optional[int] = None, split_times: bool = False,
            on_start: Optional[Callable] = None,
            on_step: Optional[Callable] = None, mesh=None,
            attn_shard_mode: Optional[str] = None):
    """The whole flow; returns (teacher, student, eval history).

    ``device``: ``cuda`` unless told otherwise. ``ckpt_every``: steps
    between checkpoints (the reference's 100). ``n_layers`` cuts the depth
    and keeps every width. ``on_start(student, opt)`` is called once
    before the first step, ``on_step(step, metrics, student, opt)`` after
    every step (``split_times`` puts the phases' ms in ``metrics["ms"]``).

    ``mesh``: a ``launch.mesh.Mesh`` of data replicas of model ranks
    (one process a rank, started by ``launch.mesh.spawn``; ``device`` is
    then the mesh's). Every rank builds the same teacher from the seed,
    pretrains it (on the data axis: the model ranks of a replica repeat
    one another's work), calibrates on the full calibration batches as
    one process does and trains the student through the gradient syncs
    (``make_train_step(mesh=...)``), so the replicas start and stay
    bitwise equal. At model > 1 each rank then keeps its part of the
    student, the teacher and the optimizer state
    (``runtime.sharding.shard_train_state`` in ``attn_shard_mode``, by
    default the reference's ``attn_shard_mode_for``) and frees the whole
    trees. Each rank draws the same global batches and keeps its data
    replica's rows (``ShardedLoader``). Global rank 0 writes the
    checkpoints, which hold the whole state (at model > 1 gathered over
    the model ranks: ``runtime.sharding.gather_train_state``), and every
    rank restores them into its whole tree before it cuts its part: a
    checkpoint restores at any data and model size
    (``runtime.fault.ElasticPlan``'s shrink), and a restore zeroes the
    int8 sync's error feedback. Each rank beats its own heartbeat file
    (``worker`` is its global rank).
    """
    if mesh is not None:
        device = mesh.device
        worker = int(mesh.data_rank) * model_axis(mesh) + int(mesh.rank)
    dev = resolve_device(device)
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    data_cfg = SyntheticConfig(vocab_size=cfg.vocab_size,
                               seq_len=tcfg.seq_len,
                               batch_size=tcfg.batch_size,
                               dclm_ratio=tcfg.dclm_ratio, seed=tcfg.seed)
    step_fn = make_train_step(cfg, tcfg, split_times=split_times, mesh=mesh,
                              attn_shard_mode=attn_shard_mode)
    writer = mesh is None or (int(mesh.data_rank) == 0
                              and int(mesh.rank) == 0)
    tp = step_fn.tp

    print(f"[qat] teacher pretrain ({teacher_steps} steps)", flush=True)
    teacher = pretrain_teacher(cfg, data_cfg, teacher_steps, tcfg.seed, dev,
                               mesh=mesh)
    student = tree_map(lambda t: t.detach().clone(), teacher)
    print("[qat] calibrating step sizes", flush=True)
    student = _trainable(calibrate(cfg, student, tcfg, data_cfg))
    opt = adamw_init(student)
    it = MixtureIterator(data_cfg, start_step=1)
    start_step = 0

    ckpt = (Checkpointer(ckpt_dir, period=len(cfg.block_pattern))
            if ckpt_dir else None)
    if ckpt and resume and ckpt.latest_step() is not None:
        (student, opt), extra = ckpt.restore((student, opt))
        it.load_state_dict(extra["data"])
        start_step = extra["step"]
        step_fn.reset_error_feedback()
        print(f"[qat] resumed from step {start_step}", flush=True)
    dims = None
    if tp is not None:
        from repro_torch.runtime.sharding import (cut_dims, shard_params,
                                                  shard_train_state)
        mode = step_fn.attn_mode
        dims = cut_dims(student, cfg, mesh, mode)
        student, opt = shard_train_state(student, opt, cfg, mesh, mode)
        student = _trainable(student)
        teacher = shard_params(teacher, cfg, mesh, mode)
        if dev.type == "cuda":
            import torch
            torch.cuda.empty_cache()
    loader = ShardedLoader(it, mesh=mesh, device=dev)

    def whole_state():
        if tp is None:
            return student, opt
        from repro_torch.runtime.sharding import gather_train_state
        return gather_train_state(student, opt, dims, tp)

    hb = HeartbeatFile(heartbeat_dir, worker) if heartbeat_dir else None
    history = []
    if on_start is not None:
        on_start(student, opt)
    for step in range(start_step, tcfg.total_steps):
        t0 = time.perf_counter()
        batch = next(loader)
        student, opt, metrics = step_fn(student, teacher, opt, batch, step)
        dt = time.perf_counter() - t0
        if hb:
            hb.write(step, dt)
        if on_step is not None:
            on_step(step, metrics, student, opt)
        if step == simulate_failure_at:
            print(f"[qat] SIMULATED FAILURE at step {step}", flush=True)
            raise SystemExit(42)
        if step % log_every == 0 or step == tcfg.total_steps - 1:
            print(f"  step {step}: kd-loss {float(metrics['loss']):.4f} "
                  f"lr {metrics['lr']:.2e} ({dt:.2f}s)", flush=True)
        if eval_every and eval_fn and (step + 1) % eval_every == 0:
            history.append((step + 1, eval_fn(student)))
        if ckpt and (step + 1) % ckpt_every == 0 and (
                writer or (tp is not None and int(mesh.data_rank) == 0)):
            # at model > 1 data replica 0's model ranks gather together
            state = whole_state()
            if writer:
                ckpt.save_async(step + 1, state,
                                {"step": step + 1,
                                 "data": loader.state_dict()})
            del state
    if ckpt and writer:
        ckpt.wait()
    return teacher, student, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--precision", default="A8d-C8-W4")
    ap.add_argument("--teacher-steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (needs the GPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    tcfg = TrainConfig(precision=args.precision, total_steps=args.steps,
                       ref_steps=args.steps, batch_size=args.batch_size,
                       seq_len=args.seq_len)
    run_qat(args.arch, tcfg, reduced=not args.full,
            teacher_steps=args.teacher_steps, ckpt_dir=args.ckpt_dir,
            resume=args.resume, simulate_failure_at=args.simulate_failure_at,
            device=args.device)


if __name__ == "__main__":
    main()
