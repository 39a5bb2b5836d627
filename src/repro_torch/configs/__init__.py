"""Architecture registry: ``--arch <id>`` lookup for full and reduced configs.

The port holds all ten of the reference's architectures.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "xlstm-125m": "xlstm_125m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mixtral-8x7b": "mixtral_8x7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-7b": "qwen2_7b",
    "whisper-large-v3": "whisper_large_v3",
    "qwen2-vl-2b": "qwen2_vl_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    try:
        mod = _ARCH_MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced()


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_reduced_config"]
