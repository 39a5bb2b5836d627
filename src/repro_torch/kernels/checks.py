"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` has this device, dtype and shape and is
    contiguous — what a kernel reading raw pointers needs."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name: str, t: torch.Tensor, nbytes: int = 16) -> None:
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned")
