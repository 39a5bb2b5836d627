"""Fault-tolerant checkpointing, in the reference's on-disk format.

A checkpoint is a directory ``step_XXXXXXXXXX/`` holding ``tensors.npz``
and ``manifest.json`` (``step``, ``keys``, ``dtypes``, ``extra``), exactly
as ``repro/checkpoint/checkpointer.py`` writes it, so a checkpoint of one
package restores in the other:

* keys are the reference's ``/``-joined tree paths: tuple and list
  positions, dict keys, ``.field`` for a named tuple's field (the
  optimizer state: ``1/.step``, ``1/.m/...``), and a dict's ``layers``
  list written as the reference's stacked ``segments/<i>/<j>/...`` arrays
  with the repeat index as the leading axis (``period``: the length of
  the model's block pattern, ``bridge.segment_index``);
* bf16 leaves are stored as ``u2`` views with ``"bfloat16"`` recorded
  under ``dtypes``;
* writes are atomic (``step_XXXX.tmp/`` then ``os.replace``), so a
  crashed writer leaves the newest complete step intact and a torn
  ``.tmp`` is never read; the newest ``keep`` steps are kept.

``restore`` writes the loaded values into the template's own tensors (in
place, under ``no_grad``) and returns it, so the parameters keep their
identity, device and ``requires_grad``. A checkpoint holds whole trees:
training at model > 1 saves the tree its ranks gather
(``runtime.sharding.gather_train_state``) and restores into a whole
template before each rank cuts its part (``launch.train.run_qat``), so
a checkpoint resumes at any data and model size.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import stacked_layers

_MANIFEST = "manifest.json"


def _entries(tree, prefix: str = "",
             period: int = 1) -> Iterator[Tuple[str, Any]]:
    """(reference key, leaf or [leaf of every repeat]) pairs."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _entries(getattr(tree, f), f"{prefix}.{f}/", period)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k == "layers" and isinstance(v, list) and v:
                for path, leaves in stacked_layers(v, period):
                    yield f"{prefix}{path}", leaves
            else:
                yield from _entries(v, f"{prefix}{k}/", period)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _entries(v, f"{prefix}{i}/", period)
    else:
        yield prefix[:-1], tree


def _host(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    # a copy even on the CPU: the optimizer updates the tensors in place
    # while save_async's thread writes these arrays
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _to_host(tree, period: int) -> List[Tuple[str, np.ndarray,
                                             Optional[str]]]:
    out = []
    for key, leaf in _entries(tree, period=period):
        if isinstance(leaf, list):
            parts = [_host(t) for t in leaf]
            out.append((key, np.stack([a for a, _ in parts]), parts[0][1]))
        else:
            out.append((key, *_host(leaf)))
    return out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, period: int = 1):
        self.dir = directory
        self.keep = keep
        self.period = period
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---- write ----------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        self._write(step, _to_host(tree, self.period), extra or {})

    def save_async(self, step: int, tree,
                   extra: Optional[Dict] = None) -> None:
        """Copy to the host now; write to disk on a thread."""
        self.wait()
        arrays = _to_host(tree, self.period)
        self._thread = threading.Thread(
            target=self._write, args=(step, arrays, extra or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays, extra: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        dtypes = {k: d for k, _, d in arrays if d is not None}
        np.savez(os.path.join(tmp, "tensors.npz"),
                 **{k: a for k, a, _ in arrays})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"step": step, "keys": [k for k, _, _ in arrays],
                       "dtypes": dtypes, "extra": extra}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---- read -----------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, _MANIFEST)):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        """Load a step (the newest by default) into ``template``'s tensors,
        in place. Returns (template, extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "tensors.npz"))
        dtypes = manifest.get("dtypes", {})
        entries = list(_entries(template, period=self.period))
        missing = [k for k, _ in entries if k not in data]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
        with torch.no_grad():
            for key, leaf in entries:
                arr = data[key]
                if isinstance(leaf, list):
                    pairs = zip(leaf, arr)
                else:
                    pairs = [(leaf, arr)]
                for t, a in pairs:
                    src = torch.from_numpy(np.array(a))
                    if dtypes.get(key) == "bfloat16":
                        src = src.view(torch.bfloat16)
                    if src.dtype != t.dtype or tuple(src.shape) != tuple(
                            t.shape):
                        raise ValueError(
                            f"checkpoint leaf {key} is {src.dtype} "
                            f"{tuple(src.shape)}, the template's "
                            f"{t.dtype} {tuple(t.shape)}")
                    t.copy_(src)
        return template, manifest["extra"]
