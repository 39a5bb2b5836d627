"""Configuration dataclasses (copies of the reference's ``ModelConfig``
and ``TrainConfig``).

Only the model fields the ported paths read are kept; architectures
beyond the dense GQA decoder arrive with later slices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

BLOCK_ATTN = "attn"            # global causal attention


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 -> no SWA
    block_pattern: Tuple[str, ...] = (BLOCK_ATTN,)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    norm_type: str = "rms"
    mlp_type: str = "swiglu"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """SiLQ training hyper-parameters (paper Appendix B)."""
    precision: str = "A8d-C8-W4"
    learning_rate: float = 5e-6
    ref_steps: int = 8_000          # LR sqrt-rescaling reference (power sched)
    total_steps: int = 8_000
    warmup_steps: int = 0
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-10
    batch_size: int = 128
    seq_len: int = 1024
    kd_ratio: float = 1.0           # 1.0 = pure knowledge distillation
    kd_temperature: float = 1.0
    dclm_ratio: float = 0.25        # DCLM share in instruct mixture
    act_scale_lr_mult: float = 50.0  # LSQ activation-scale LR boost
    grad_clip: float = 1.0          # global-norm gradient clipping (0 = off)
    act_calib_method: str = "quantile"   # quantile | max
    wgt_calib_method: str = "mse"        # mse | lsq
    calib_batches: int = 5
    calib_batch_size: int = 128
    grad_compression: str = "none"  # none | int8  (data-parallel, not ported)
    remat: str = "none"             # none | block  (activation checkpointing)
    seed: int = 0

    def scaled_lr(self) -> float:
        """Power-scheduler rule: lr ~ 1/sqrt(steps / ref_steps)."""
        return self.learning_rate * (self.ref_steps / self.total_steps) ** 0.5
