"""qwen2-7b — dense GQA decoder, QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    block_pattern=(BLOCK_ATTN,),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="qwen2-7b-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256)
