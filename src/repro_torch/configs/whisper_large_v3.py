"""whisper-large-v3 — encoder-decoder backbone; the conv frontend is not
modelled: the caller passes precomputed 1500-frame embeddings as
``batch["frames"]``. [arXiv:2212.04356]

MHA (kv=20 == heads): GQA degenerate case. Decoder layers carry self- and
cross-attention; both caches are quantized to C-bits.
"""
from repro_torch.configs.base import BLOCK_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,              # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    tie_embeddings=True,
    rope_theta=0.0,           # no rope: learned absolute positions
    norm_type="ln",
    mlp_type="gelu",
    max_position_embeddings=36_864,
    block_pattern=(BLOCK_ATTN,),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="whisper-large-v3-reduced", n_layers=2,
                          encoder_layers=2, encoder_seq=32, d_model=64,
                          n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256, max_position_embeddings=128)
