"""The port's kernel build on the CPU: which texts a built kernel's name
hashes. No ``nvcc`` is run; only the target names are computed.

A kernel is built into ``build/kernels/<name>-<hash>.so`` and reused
while the file exists, so the hash must change with every text the
compiler reads from the repository: the ``.cu`` source, the ``csrc/``
headers it includes (directly or through another header), and the
flags. Otherwise editing a shared header (``kvq_paged_split.cuh``, which
both paged attention launchers include) would leave stale libraries.
"""
import ctypes
import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.kvq_attn import ops as kvq_ops
from repro_torch.kernels.quant import ops as fq_ops
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.w4a8 import ops as w4a8_ops


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A scratch ``csrc/``: a.cu includes x.cuh, which includes y.cuh;
    z.cuh is included by nothing."""
    (tmp_path / "a.cu").write_text(
        '#include <cuda_runtime.h>\n#include "x.cuh"\nint a;\n')
    (tmp_path / "x.cuh").write_text('#pragma once\n#include "y.cuh"\n')
    (tmp_path / "y.cuh").write_text("#pragma once\nint y;\n")
    (tmp_path / "z.cuh").write_text("#pragma once\nint z;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edited,changes", [
    ("a.cu", True),        # the source itself
    ("x.cuh", True),       # a header it includes
    ("y.cuh", True),       # a header included through another header
    ("z.cuh", False),      # a header it does not include
])
def test_target_hashes_the_source_and_its_included_headers(csrc, edited,
                                                           changes):
    before = build._target("a")
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    after = build._target("a")
    assert after.name.startswith("a-") and after.suffix == ".so"
    assert (after != before) is changes


def test_target_hashes_the_flags(csrc, monkeypatch):
    before = build._target("a")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._target("a") != before


def test_local_includes_follows_quoted_headers_only(csrc):
    assert [p.name for p in build.local_includes(csrc / "a.cu")] == [
        "x.cuh", "y.cuh"]


@pytest.mark.parametrize("name", ["kvq_paged_decode_attn",
                                  "kvq_spec_verify_attn", "kvq_decode_attn"])
def test_paged_launchers_share_the_split_header(name):
    """The dense decode, paged decode and verify launchers compile the one
    split-KV header, so an edit to it rebuilds all three."""
    hdrs = build.local_includes(build.CSRC / f"{name}.cu")
    assert [p.name for p in hdrs] == ["kvq_paged_split.cuh"]
    assert name in build.SOURCES


# --------------------------------------------------------------------------
# the ctypes signatures against the C launchers' parameter lists
# --------------------------------------------------------------------------

_EXTERN = re.compile(r'extern "C"\s+(?:int|long long)\s+(\w+)\s*\(([^)]*)\)')
_SCALAR = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def _c_params(source: str, fn: str) -> list:
    """The ctypes class each parameter of ``fn`` in ``csrc/<source>.cu``
    takes: c_void_p for a pointer, else its scalar type."""
    text = (build.CSRC / f"{source}.cu").read_text()
    found = dict(_EXTERN.findall(text))
    assert fn in found, f"{source}.cu has no extern \"C\" {fn}"
    kinds = []
    for param in found[fn].split(","):
        param = " ".join(param.replace("const", " ").split())
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        else:
            kinds.append(_SCALAR[param.rsplit(" ", 1)[0]])
    return kinds


# (source, C function, the wrapper's argtypes)
LAUNCHERS = [
    ("flash_attn_fwd", "flash_attn_fwd_launch", fa_ops._ARGTYPES),
    *[(kvq_ops._SOURCE.get(name, name), f"{name}_launch",
       kvq_ops._ARGTYPES[name]) for name in kvq_ops._ARGTYPES],
    *[("fake_quant", name, fq_ops._ARGTYPES[name][0])
      for name in fq_ops._ARGTYPES],
    ("slstm_scan", "slstm_scan_launch", slstm_ops._ARGTYPES),
    ("slstm_scan", "slstm_scan_route", slstm_ops._ROUTE_ARGTYPES),
    ("w4a8_matmul", "w4a8_matmul_launch", w4a8_ops._ARGTYPES),
    ("w4a8_matmul", "w4a8_accumulate_launch", w4a8_ops._ACC_ARGTYPES),
    ("w4a8_matmul", "w4a8_epilogue_launch", w4a8_ops._EPI_ARGTYPES),
]


@pytest.mark.parametrize("source,fn,argtypes", LAUNCHERS,
                         ids=[f for _, f, _ in LAUNCHERS])
def test_launcher_signature_matches_argtypes(source, fn, argtypes):
    """A C launcher whose parameter list drifts from the wrapper's ctypes
    argtypes still passes every CPU test and only fails (or corrupts
    memory) on the card, so the two are read side by side here: the same
    count, a pointer (c_void_p) exactly where the C side takes one, and
    the same scalar type elsewhere (a 64-bit ``long long`` is not an
    ``int``)."""
    assert source in build.SOURCES
    assert list(argtypes) == _c_params(source, fn)


def test_every_launcher_has_argtypes():
    """No ``*_launch`` entry point of ``csrc/`` is missing from the table
    above, so a new launcher is held to its wrapper too."""
    launchers = {fn for src in build.SOURCES
                 for fn, _ in _EXTERN.findall(
                     (build.CSRC / f"{src}.cu").read_text())
                 if fn.endswith("_launch")}
    assert launchers == {fn for _, fn, _ in LAUNCHERS
                         if fn.endswith("_launch")}


@pytest.mark.parametrize("fn,first", [("fake_quant_fwd_launch", 3),
                                      ("fake_quant_bwd_launch", 6),
                                      ("fake_quant_bwd_workspace", 0)])
def test_fake_quant_launchers_take_slices(fn, first):
    """The fake-quant launchers and the workspace size take x as E slices
    of (R, C) (mode 3: an MoE bank per expert), E first, three 64-bit
    integers in a row, and the wrapper's argtypes say so."""
    text = (build.CSRC / "fake_quant.cu").read_text()
    params = [p.split()[-1].lstrip("*")
              for p in dict(_EXTERN.findall(text))[fn].split(",")]
    assert params[first:first + 4] == ["E", "R", "C", "mode"]
    args = fq_ops._ARGTYPES[fn][0]
    assert list(args[first:first + 3]) == [ctypes.c_longlong] * 3
