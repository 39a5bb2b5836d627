"""Configuration dataclasses (copies of the reference's ``ModelConfig``
and ``TrainConfig``).

Only the model fields the ported paths read are kept.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# Block kinds understood by models/model.py
BLOCK_ATTN = "attn"            # global causal attention
BLOCK_LOCAL_ATTN = "local_attn"  # sliding-window causal attention
BLOCK_RGLRU = "rglru"          # RecurrentGemma RG-LRU recurrent block
BLOCK_MLSTM = "mlstm"          # xLSTM matrix-memory block
BLOCK_SLSTM = "slstm"          # xLSTM scalar-memory block

ATTENTION_BLOCKS = (BLOCK_ATTN, BLOCK_LOCAL_ATTN)
RECURRENT_BLOCKS = (BLOCK_RGLRU, BLOCK_MLSTM, BLOCK_SLSTM)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
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
    local_window: int = 2048        # window for BLOCK_LOCAL_ATTN layers
    # repeating pattern of block kinds, tiled / truncated to n_layers
    block_pattern: Tuple[str, ...] = (BLOCK_ATTN,)
    # MoE: experts of an attention layer's SwiGLU, and the top-k routed to
    n_experts: int = 0
    n_experts_active: int = 0
    # encoder-decoder (whisper): a bidirectional encoder over precomputed
    # frame embeddings, cross-attention in every decoder layer
    encoder_layers: int = 0
    encoder_seq: int = 1500
    # VLM (qwen2-vl): multimodal rotary over a prefix of patch embeddings
    mrope: bool = False
    vision_tokens: int = 0
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    lru_width: int = 0              # RG-LRU width (0 -> d_model)
    conv1d_width: int = 4           # temporal conv width in RG-LRU block
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    norm_type: str = "rms"          # rms | ln (whisper)
    mlp_type: str = "swiglu"        # swiglu | gelu (whisper)
    max_position_embeddings: int = 0  # > 0: learned absolute positions

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind for every decoder layer (pattern tiled to n_layers)."""
        pat = self.block_pattern
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.n_layers])

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """True if decode memory is sub-linear in context (bounded cache)."""
        kinds = set(self.layer_kinds())
        if kinds & set(RECURRENT_BLOCKS):
            return True
        # pure attention: only if every attention layer is window-bounded
        return not (BLOCK_ATTN in kinds and self.sliding_window == 0)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_counts(self) -> dict:
        """Analytic parameter counts, total and active (an MoE layer's
        active count holds its ``n_experts_active`` experts and the
        router; an encoder-decoder's its encoder layers and each decoder
        layer's cross-attention, counted as the reference counts them),
        for the model-FLOPs share."""
        d = self.d_model
        qd, kvd = self.q_dim, self.kv_dim
        attn = d * qd + 2 * d * kvd + qd * d            # q, k, v, o
        if self.qkv_bias:
            attn += qd + 2 * kvd
        dense_mlp = 3 * d * self.d_ff                   # SwiGLU gate/up/down
        moe_mlp = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        active_moe_mlp = (self.n_experts_active * 3 * d * self.d_ff
                          + d * self.n_experts)
        lru = self.resolved_lru_width
        rglru_blk = (2 * d * lru + lru * d
                     + self.conv1d_width * lru + 2 * lru * lru)
        m_in = int(self.mlstm_proj_factor * d)
        mlstm_blk = 2 * d * m_in + m_in * d + 3 * m_in * m_in + 2 * m_in
        s_in = int(self.slstm_proj_factor * d)
        slstm_blk = 8 * d * d + 2 * d * s_in
        total = active = 0
        for kind in self.layer_kinds():
            if kind in ATTENTION_BLOCKS:
                t = attn + (moe_mlp if self.is_moe else dense_mlp)
                a = attn + (active_moe_mlp if self.is_moe else dense_mlp)
            elif kind == BLOCK_RGLRU:
                t = a = rglru_blk + dense_mlp
            elif kind == BLOCK_MLSTM:
                t = a = mlstm_blk + (dense_mlp if self.d_ff else 0)
            elif kind == BLOCK_SLSTM:
                t = a = slstm_blk + (dense_mlp if self.d_ff else 0)
            else:
                raise ValueError(kind)
            total += t
            active += a
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + dense_mlp)
            xattn = self.n_layers * (d * qd + 2 * d * kvd + qd * d)
            total += enc + xattn
            active += enc + xattn
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return {"total": total + emb + head, "active": active + emb + head,
                "body_total": total, "body_active": active}


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
