"""Host batches to the device: device placement, sharding, prefetch.

:class:`ShardedLoader` is the reference's ``data/loader.py``: it wraps an
iterator of numpy batches, places each batch (on a mesh, this data
rank's rows of it: ``runtime.sharding.shard_batch``) and keeps
``prefetch`` batches placed ahead, behind a lock. Its copies to a CUDA
device start from pinned host memory without blocking, so the next
batch's copy overlaps the step in flight. ``to_device`` places one batch.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


class ShardedLoader:
    """Placed batches from ``it``, ``prefetch`` of them ahead. ``mesh``:
    a ``launch.mesh.Mesh`` (this rank's data replica's rows of each
    batch, the same on each of its model ranks, on ``mesh.device``), or
    None for the whole batch on ``device``.
    ``state_dict`` is the iterator's state as of the last batch handed
    out, not of the ones prefetched, so a checkpoint resumes at the next
    batch to train on."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], mesh=None,
                 batch_axes: tuple = ("data",), prefetch: int = 1,
                 device=None):
        if tuple(batch_axes) != ("data",):
            raise NotImplementedError(
                f"batch axes {batch_axes}: the port's meshes have one "
                "batch axis, 'data' (the reference's 'pod' axis is not "
                "ported)")
        self._it = it
        self._mesh = mesh
        self._device = (mesh.device if mesh is not None else
                        torch.device("cpu" if device is None else device))
        self._q: collections.deque = collections.deque()
        self._prefetch = max(prefetch, 0)
        self._lock = threading.Lock()
        self._state = self._it_state()

    def _it_state(self):
        get = getattr(self._it, "state_dict", None)
        return get() if get is not None else None

    def _place(self, batch: Dict[str, np.ndarray]):
        if self._mesh is not None:
            from repro_torch.runtime.sharding import shard_batch
            batch = shard_batch(batch, self._mesh)
        return to_device(batch, self._device)

    def state_dict(self):
        return self._state

    def __iter__(self):
        return self

    def __next__(self):
        with self._lock:
            while len(self._q) <= self._prefetch:
                batch = self._place(next(self._it))
                self._q.append((batch, self._it_state()))
            batch, self._state = self._q.popleft()
            return batch
