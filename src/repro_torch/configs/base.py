"""Model configuration dataclass (copy of the reference's ``ModelConfig``).

Only the fields the ported serving path reads are kept; architectures
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
