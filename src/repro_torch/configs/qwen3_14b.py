"""qwen3-14b — dense GQA decoder with qk_norm. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=(BLOCK_ATTN,),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="qwen3-14b-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256)
