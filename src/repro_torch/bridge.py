"""Reference params -> port params.

``params_from_numpy(tree, device)`` takes the JAX package's parameter tree
with every leaf already converted to a numpy array (the caller runs
``jax.tree.map(np.asarray, params)``; this module imports no jax) and
returns the port's tree:

* leaves are addressed by the ``/``-joined paths of the reference
  checkpointer (``segments/0/0/attn/wq/w``, ``embed/w``, ...);
* the stacked leading layer axis of ``segments/<i>/<j>/...`` is split
  into per-layer entries of ``params["layers"]`` (layer ``r * kinds + j``
  of segment ``i``, after the layers of the segments before it);
* bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
  ``torch.from_numpy`` rejects, so they travel as a ``uint16`` view and
  are reinterpreted with ``.view(torch.bfloat16)``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs, paths ``/``-joined dict keys and list indices."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(flatten(v, f"{prefix}{i}/"))
        return out
    return [(prefix[:-1], tree)]


def to_torch(a: np.ndarray, device) -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _set(tree: Dict, path: List[str], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def params_from_numpy(tree, device) -> Dict:
    flat = flatten(tree)
    out: Dict = {}
    # segment i -> (repeat, kinds): layer offsets follow segment order
    seg_shape: Dict[int, Tuple[int, int]] = {}
    for path, leaf in flat:
        parts = path.split("/")
        if parts[0] == "segments":
            i, j = int(parts[1]), int(parts[2])
            rep, kinds = seg_shape.get(i, (np.asarray(leaf).shape[0], 0))
            seg_shape[i] = (rep, max(kinds, j + 1))
    offsets, n = {}, 0
    for i in sorted(seg_shape):
        offsets[i] = n
        n += seg_shape[i][0] * seg_shape[i][1]
    layers: List[Dict] = [{} for _ in range(n)]
    for path, leaf in flat:
        parts = path.split("/")
        if parts[0] != "segments":
            _set(out, parts, to_torch(leaf, device))
            continue
        i, j, rest = int(parts[1]), int(parts[2]), parts[3:]
        rep, kinds = seg_shape[i]
        stacked = to_torch(leaf, device)
        for r in range(rep):
            _set(layers[offsets[i] + r * kinds + j], rest, stacked[r])
    out["layers"] = layers
    return out
