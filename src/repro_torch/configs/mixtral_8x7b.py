"""mixtral-8x7b — MoE decoder, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    n_experts=8,
    n_experts_active=2,
    sliding_window=4096,       # SWA bounds the decode cache (rings)
    rope_theta=1_000_000.0,
    block_pattern=(BLOCK_ATTN,),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="mixtral-8x7b-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
                          vocab_size=256, n_experts=4, n_experts_active=2,
                          sliding_window=32)
