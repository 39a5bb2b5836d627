"""LR schedules: cosine-to-floor (paper: min = 10% of base, no warmup) and
the power-scheduler square-root rescaling rule for changed run lengths
(Shen et al., 2024 — paper Appendix B)."""
from __future__ import annotations

import math

import numpy as np


def cosine_schedule(step, *, base_lr: float, total_steps: int,
                    warmup_steps: int = 0,
                    min_lr_ratio: float = 0.1) -> float:
    """The reference's f32 arithmetic on the host; returns the f32 value
    as a float."""
    f = np.float32
    s = f(step)
    warm = (np.minimum(s / f(max(warmup_steps, 1)), f(1.0))
            if warmup_steps > 0 else f(1.0))
    prog = np.clip((s - f(warmup_steps))
                   / f(max(total_steps - warmup_steps, 1)), f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * prog))
    floor = f(min_lr_ratio)
    return float(f(base_lr) * warm * (floor + (f(1.0) - floor) * cos))


def sqrt_rescaled_lr(base_lr: float, ref_steps: int, total_steps: int) -> float:
    """lr(T) = lr(T_ref) * sqrt(T_ref / T): 4x longer run -> half the LR."""
    return base_lr * (ref_steps / total_steps) ** 0.5
