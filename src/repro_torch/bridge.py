"""Reference params <-> port params.

``params_from_numpy(tree, device)`` takes the JAX package's parameter tree
with every leaf already converted to a numpy array (the caller runs
``jax.tree.map(np.asarray, params)``; this module imports no jax) and
returns the port's tree:

* leaves are addressed by the ``/``-joined paths of the reference
  checkpointer (``segments/0/0/attn/wq/w``, ``embed/w``, ...);
* the stacked leading layer axis of ``segments/<i>/<j>/...`` is split
  into per-layer entries of ``params["layers"]`` (layer ``r * kinds + j``
  of segment ``i``, after the layers of the segments before it), and an
  encoder's ``encoder/segments/...`` into ``params["encoder"]["layers"]``;
* bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
  ``torch.from_numpy`` rejects, so they travel as a ``uint16`` view and
  are reinterpreted with ``.view(torch.bfloat16)``;
* every port leaf is a tensor of its own (a clone, never a view of a
  stacked tensor), so it can take ``requires_grad_`` and an in-place
  optimizer update.

``params_to_numpy(params, period=...)`` is the inverse: the port's tree
back to the reference's stacked layout, one numpy array per leaf, with
``period`` the length of the config's block pattern
(:func:`segment_index`).
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


def _unstack(flat: List[Tuple[List[str], Any]], device) -> List[Dict]:
    """Per-layer dicts of the ``segments/<i>/<j>/...`` leaves in ``flat``
    ((path parts from ``segments`` on, leaf) pairs): layer ``r * kinds +
    j`` of segment i, after the layers of the segments before it."""
    # segment i -> (repeat, kinds): layer offsets follow segment order
    seg_shape: Dict[int, Tuple[int, int]] = {}
    for parts, leaf in flat:
        i, j = int(parts[1]), int(parts[2])
        rep, kinds = seg_shape.get(i, (np.asarray(leaf).shape[0], 0))
        seg_shape[i] = (rep, max(kinds, j + 1))
    offsets, n = {}, 0
    for i in sorted(seg_shape):
        offsets[i] = n
        n += seg_shape[i][0] * seg_shape[i][1]
    layers: List[Dict] = [{} for _ in range(n)]
    for parts, leaf in flat:
        i, j, rest = int(parts[1]), int(parts[2]), parts[3:]
        rep, kinds = seg_shape[i]
        stacked = to_torch(leaf, device)
        for r in range(rep):
            _set(layers[offsets[i] + r * kinds + j], rest, stacked[r].clone())
    return layers


def params_from_numpy(tree, device) -> Dict:
    """The port's tree of the reference's: the decoder's ``segments``
    become ``params["layers"]``, an encoder's ``encoder/segments``
    ``params["encoder"]["layers"]``, every other leaf stays where it
    is."""
    out: Dict = {}
    decoder, encoder = [], []
    for path, leaf in flatten(tree):
        parts = path.split("/")
        if parts[0] == "segments":
            decoder.append((parts, leaf))
        elif parts[:2] == ["encoder", "segments"]:
            encoder.append((parts[1:], leaf))
        else:
            _set(out, parts, to_torch(leaf, device))
    out["layers"] = _unstack(decoder, device)
    if encoder:
        out["encoder"]["layers"] = _unstack(encoder, device)
    return out


def segment_index(n_layers: int, period: int = 1
                  ) -> List[Tuple[str, int]]:
    """The reference's address of each layer: (``segments/<i>/<j>``,
    repeat r). Its segment plan stacks ``n_layers // period`` repeats of
    the whole block pattern in segment 0, and one repeat of the remaining
    ``n_layers % period`` kinds in the next segment."""
    n_full, rem = divmod(n_layers, period)
    out = [(f"segments/0/{i % period}", i // period)
           for i in range(n_full * period)]
    seg = 1 if n_full else 0
    out += [(f"segments/{seg}/{j}", 0) for j in range(rem)]
    return out


def stacked_layers(layers: List, period: int = 1
                   ) -> List[Tuple[str, List[Any]]]:
    """(reference path, [leaf of each repeat]) for every leaf of a
    ``layers`` list, the repeats in stacking order."""
    groups: Dict[str, List[Any]] = {}
    for layer, (seg, _) in zip(layers, segment_index(len(layers), period)):
        groups.setdefault(seg, []).append(layer)
    out = []
    for seg, reps in groups.items():
        for path, _ in flatten(reps[0]):
            out.append((f"{seg}/{path}", [get_path(p, path) for p in reps]))
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


def params_to_numpy(params: Dict, bfloat16=None, period: int = 1) -> Dict:
    """The port's params in the reference's layout: ``layers`` stacked
    back into ``segments/<i>/<j>/...`` (``period``: the length of the
    block pattern; 1 for the dense decoder's one kind), an encoder's into
    ``encoder/segments/0/0/...``, every other entry as it is, leaves as
    numpy arrays."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items() if k != "layers"}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return to_numpy(tree, bfloat16)

    def segments(layers, period):
        stacked: Dict = {}
        for path, leaves in stacked_layers(layers, period):
            _set(stacked, path.split("/"),
                 np.stack([to_numpy(t, bfloat16) for t in leaves]))
        segs = stacked["segments"]
        return [segs[str(i)] for i in range(len(segs))]

    out = walk(params)
    out["segments"] = segments(params["layers"], period)
    if "encoder" in params:
        out["encoder"]["segments"] = segments(params["encoder"]["layers"], 1)
    return out
