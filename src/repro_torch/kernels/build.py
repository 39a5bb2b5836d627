"""Build the port's CUDA C++ kernels with ``nvcc`` and load them by ctypes.

Each source ``repro_torch/csrc/<name>.cu`` exposes a plain C interface and
is compiled on its own into ``build/kernels/<name>-<hash>.so`` under the
repository root (a git-ignored directory), at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The hash covers the flags, the source text and the text of every
``csrc/*.cuh`` header the source includes (``#include "..."``, followed
through headers), so an edited source or shared header builds anew.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# every kernel source of the port, in a stable order
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_includes(path: Path) -> tuple:
    """The headers of ``csrc/`` that ``path`` includes with ``#include
    "..."``, directly or through another such header, in first-seen
    order (system headers in ``<...>`` are not followed)."""
    seen, todo = [], [path]
    while todo:
        cur = todo.pop(0)
        for inc in _INCLUDE.findall(cur.read_bytes()):
            hdr = cur.parent / inc.decode()
            if hdr.is_file() and hdr not in seen:
                seen.append(hdr)
                todo.append(hdr)
    return tuple(seen)


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src,) + local_includes(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp          # renamed onto ``out`` once nvcc succeeds
    proc.out_path = out
    return proc


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(proc.tmp_path).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)   # atomic: no half-written .so


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every listed source not built yet, all ``nvcc`` runs in
    parallel; returns {name: shared library path}."""
    names = tuple(names or SOURCES)
    with _lock:
        targets = {n: _target(n) for n in names}
        procs = {n: _start(n, t) for n, t in targets.items()
                 if not t.is_file()}
        errors = []
        for n, p in procs.items():
            try:
                _finish(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel source (built if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all((name,))[name]
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _loaded[name] = lib
    return lib
