"""qwen2.5-3b — dense GQA decoder, QKV bias. [hf:Qwen/Qwen2.5-0.5B family]"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    block_pattern=(BLOCK_ATTN,),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="qwen2.5-3b-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256)
