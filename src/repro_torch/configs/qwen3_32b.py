"""qwen3-32b — dense GQA decoder with qk_norm; head_dim=128 (q_dim > d_model).
[hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=(BLOCK_ATTN,),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="qwen3-32b-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256)
