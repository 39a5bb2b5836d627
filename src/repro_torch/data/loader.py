"""Host batches to the device.

The port has no mesh yet, so where the reference's ``ShardedLoader``
places each batch on a mesh, ``to_device`` moves it to one device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, non_blocking=True) for k, v in batch.items()}
