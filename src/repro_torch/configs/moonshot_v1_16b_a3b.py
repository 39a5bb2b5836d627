"""moonshot-v1-16b-a3b — MoE decoder, 64 experts top-6, per-expert d_ff=1408.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    n_experts=64,
    n_experts_active=6,
    rope_theta=50_000.0,
    block_pattern=(BLOCK_ATTN,),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="moonshot-v1-16b-a3b-reduced", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                          d_ff=64, vocab_size=256, n_experts=8,
                          n_experts_active=2)
