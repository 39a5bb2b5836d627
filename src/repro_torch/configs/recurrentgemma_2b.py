"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427]"""
from repro_torch.configs.base import BLOCK_LOCAL_ATTN, BLOCK_RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,             # MQA on the local-attention layers
    d_ff=7680,
    vocab_size=256_000,
    local_window=2048,
    lru_width=2560,
    conv1d_width=4,
    tie_embeddings=True,
    block_pattern=(BLOCK_RGLRU, BLOCK_RGLRU, BLOCK_LOCAL_ATTN),
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="recurrentgemma-2b-reduced", n_layers=3,
                          d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
                          d_ff=128, vocab_size=256, local_window=16,
                          lru_width=64)
