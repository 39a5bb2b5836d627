"""xlstm-125m — sLSTM + mLSTM blocks (no separate FFN, d_ff=0); mLSTM matrix
memory is the cache analogue. [arXiv:2405.04517]"""
from repro_torch.configs.base import BLOCK_MLSTM, BLOCK_SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                    # blocks carry their own up-projections
    vocab_size=50_304,
    block_pattern=(BLOCK_MLSTM,) * 5 + (BLOCK_SLSTM,),  # ~5:1 mix
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(name="xlstm-125m-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, head_dim=16, vocab_size=256,
                          block_pattern=(BLOCK_MLSTM, BLOCK_SLSTM))
