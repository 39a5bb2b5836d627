"""Reference params <-> port params.

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
  are reinterpreted with ``.view(torch.bfloat16)``;
* every port leaf is a tensor of its own (a clone, never a view of a
  stacked tensor), so it can take ``requires_grad_`` and an in-place
  optimizer update.

``params_to_numpy(params)`` is the inverse: the port's tree back to the
reference's stacked layout, one numpy array per leaf.
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
    a = np.array(a)                # a contiguous copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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
            _set(layers[offsets[i] + r * kinds + j], rest, stacked[r].clone())
    out["layers"] = layers
    return out


def get_path(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def to_numpy(t: torch.Tensor, bfloat16=None) -> np.ndarray:
    """Tensor -> numpy on the host. bf16 comes back as its raw bits viewed
    as ``bfloat16`` when that numpy dtype is given (``ml_dtypes``' in the
    tests), else as float32 arrays of the same values."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if bfloat16 is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(np.uint16).view(bfloat16)
    return t.numpy().copy()


def params_to_numpy(params: Dict, bfloat16=None) -> Dict:
    """The port's params in the reference's layout: ``layers`` stacked
    back into ``segments/0/0/...`` (the dense decoder's one segment of one
    block kind), every other entry as it is, leaves as numpy arrays."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items() if k != "layers"}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return to_numpy(tree, bfloat16)

    out = walk(params)
    layers = params["layers"]
    stacked: Dict = {}
    for path, _ in flatten(layers[0]):
        _set(stacked, path.split("/"), np.stack(
            [to_numpy(get_path(p, path), bfloat16) for p in layers]))
    out["segments"] = [{"0": stacked}]
    return out
