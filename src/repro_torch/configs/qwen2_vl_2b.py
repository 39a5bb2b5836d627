"""qwen2-vl-2b — VLM decoder backbone with M-RoPE; the vision tower is not
modelled: the caller passes precomputed patch embeddings as
``batch["patches"]``, a prefix of the sequence.
[arXiv:2409.12191]"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    mrope=True,
    vision_tokens=256,         # precomputed patch-embedding prefix length
    rope_theta=1_000_000.0,
    block_pattern=(BLOCK_ATTN,),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="qwen2-vl-2b-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, vision_tokens=8)
