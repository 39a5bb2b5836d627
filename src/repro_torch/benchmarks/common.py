"""Shared benchmark harness (the port's copy of ``benchmarks/common.py``).

The paper tables are reproduced in *mechanism* on a model trained here:

* an fp16 "original model" (the teacher) is pretrained on the synthetic
  mixture until it has real structure to lose under quantization,
* quality is measured on held-out data as (a) next-token loss, (b) top-1
  agreement with the fp16 teacher (the stand-in for benchmark accuracy
  deltas: a quantized model that matches the original's predictions
  scores identically on any downstream task) and (c) KL(teacher||student).

Teachers are cached through the port's ``Checkpointer`` under
``artifacts/bench_torch/`` (``Bench.cache_dir``), so every table reuses the
same "original model", as the paper does. ``Bench`` carries a run's scale:
the reduced config by default, ``full=True`` the published widths.
Evaluation and the PTQ passes run without a gradient, so on CUDA their
attention runs the flash kernel and their weight sites the fake-quant
kernel.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.distill import next_token_loss
from repro_torch.core.precision import parse_policy
from repro_torch.core.qat import make_ctx
from repro_torch.data import (MixtureIterator, SyntheticConfig,
                              calibration_batches, to_device)
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import calibrate, pretrain_teacher
from repro_torch.models import forward, init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_map

ART = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..",
                                   "..", "artifacts", "bench_torch"))

BENCH_ARCH = "qwen2.5-3b"
SEQ_LEN = 64
BATCH = 8
TEACHER_STEPS = 400
EVAL_BATCHES = 8


@dataclass(frozen=True)
class Bench:
    """A benchmark run's scale and place.

    ``qat_steps`` (None: each table's own) and ``teacher_steps`` cut a
    run's steps; ``full`` takes the published config instead of the
    reduced one; ``device``: ``cuda`` unless told otherwise."""
    full: bool = False
    device: Optional[str] = None
    cache_dir: str = field(default=ART)
    teacher_steps: int = TEACHER_STEPS
    qat_steps: Optional[int] = None

    def steps(self, default: int) -> int:
        return default if self.qat_steps is None else self.qat_steps

    def teacher(self, arch: str = BENCH_ARCH):
        return get_teacher(arch, self.teacher_steps, full=self.full,
                           device=self.device, cache_dir=self.cache_dir)


def data_cfg(cfg, seed: int = 0, dclm_ratio: float = 0.25) -> SyntheticConfig:
    return SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                           batch_size=BATCH, dclm_ratio=dclm_ratio,
                           seed=seed)


def device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def sync_device(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def get_teacher(arch: str = BENCH_ARCH, steps: int = TEACHER_STEPS, *,
                full: bool = False, device=None, cache_dir: str = ART):
    """Pretrained fp16 'original model' (cached). Returns (cfg, params)."""
    cfg = get_config(arch) if full else get_reduced_config(arch)
    dev = resolve_device(device)
    ck = Checkpointer(os.path.join(cache_dir, f"teacher_{cfg.name}_{steps}"),
                      period=len(cfg.block_pattern))
    if ck.latest_step() is not None:
        params, _ = ck.restore(init_params(cfg, seed=0, device=dev))
        return cfg, params
    params = pretrain_teacher(cfg, data_cfg(cfg), steps, 0, dev)
    ck.save(steps, params, {})
    return cfg, params


def eval_quality(cfg, params, teacher, policy: str,
                 n_batches: int = EVAL_BATCHES,
                 kernel_backend: str = "auto") -> Dict[str, float]:
    """Held-out next-token loss, top-1 agreement with the fp16 teacher
    and KL(teacher || student). ``kernel_backend="ref"`` runs the
    kernels' plain versions on any device."""
    ctx = (make_ctx(policy, kernel_backend=kernel_backend)
           if policy != "A16-C16-W16" else
           make_ctx(policy, mode="off", kernel_backend=kernel_backend))
    tctx = make_ctx("A16-C16-W16", mode="off", kernel_backend=kernel_backend)
    dc = data_cfg(cfg, seed=777)          # held-out stream
    it = MixtureIterator(dc, start_step=50_000_000)
    dev = device_of(params)
    losses, agrees, kls = [], [], []
    with torch.no_grad():
        for _ in range(n_batches):
            b = to_device(next(it), dev)
            lg = forward(cfg, params, ctx, b)[0]
            tl = forward(cfg, teacher, tctx, b)[0]
            losses.append(float(next_token_loss(lg, b["labels"],
                                                b["loss_mask"])))
            m = b["loss_mask"] > 0
            same = torch.argmax(lg, -1) == torch.argmax(tl, -1)
            agrees.append(float(torch.sum(same & m) / torch.sum(m)))
            # KL(teacher || student): the KD objective on held-out data,
            # far more sensitive than top-1 agreement at small scale
            lp_s = torch.log_softmax(lg.float(), -1)
            del lg
            lp_t = torch.log_softmax(tl.float(), -1)
            del tl
            kl = torch.sum(torch.exp(lp_t) * (lp_t - lp_s), -1)
            del lp_s, lp_t
            kls.append(float(torch.sum(kl * m) / torch.sum(m)))
    return {"ntp_loss": float(np.mean(losses)),
            "teacher_agreement": float(np.mean(agrees)),
            "teacher_kl": float(np.mean(kls))}


def student_of(cfg, teacher, tcfg: TrainConfig, dc: SyntheticConfig):
    """A calibrated copy of the teacher with ``requires_grad`` on."""
    student = tree_map(lambda t: t.detach().clone(), teacher)
    student = calibrate(cfg, student, tcfg, dc)
    for p in tree_leaves(student):
        p.requires_grad_(True)
    return student


def run_silq(cfg, teacher, tcfg: TrainConfig, *, seed_data: int = 0,
             eval_every: int = 0) -> Tuple[Dict, list, float]:
    """Calibrate + QAT per the paper recipe. Returns (student, curve, s),
    ``s`` the steps' seconds (device synchronised)."""
    dc = data_cfg(cfg, seed=seed_data, dclm_ratio=tcfg.dclm_ratio)
    student = student_of(cfg, teacher, tcfg, dc)
    opt = adamw_init(student)
    step_fn = make_train_step(cfg, tcfg)
    it = MixtureIterator(dc, start_step=1)
    dev = device_of(teacher)
    sync_device(dev)
    t0 = time.perf_counter()
    curve = []
    for step in range(tcfg.total_steps):
        b = to_device(next(it), dev)
        student, opt, _ = step_fn(student, teacher, opt, b, step)
        if eval_every and (step + 1) % eval_every == 0:
            q = eval_quality(cfg, student, teacher, tcfg.precision,
                             n_batches=4)
            curve.append((step + 1, q["teacher_agreement"]))
    sync_device(dev)
    return student, curve, time.perf_counter() - t0


def ptq_baselines(cfg, teacher, policy_name: str) -> Dict[str, Dict]:
    from repro_torch.core.ptq.rtn import rtn_quantize
    from repro_torch.core.ptq.smoothquant import smoothquant_quantize
    pol = parse_policy(policy_name)
    cb = calibration_batches(data_cfg(cfg), 5)
    return {"RTN": rtn_quantize(cfg, teacher, pol, cb),
            "SmoothQuant": smoothquant_quantize(cfg, teacher, pol, cb,
                                                alpha=0.4)}


class Row:
    """CSV row helper for ``run.py`` (name,us_per_call,derived)."""

    def __init__(self):
        self.rows = []

    def add(self, name: str, seconds: float, derived: str):
        self.rows.append(f"{name},{seconds * 1e6:.0f},{derived}")

    def emit(self):
        for r in self.rows:
            print(r, flush=True)
