"""The port's kernel build on the CPU: which texts a built kernel's name
hashes. No ``nvcc`` is run; only the target names are computed.

A kernel is built into ``build/kernels/<name>-<hash>.so`` and reused
while the file exists, so the hash must change with every text the
compiler reads from the repository: the ``.cu`` source, the ``csrc/``
headers it includes (directly or through another header), and the
flags. Otherwise editing a shared header (``kvq_paged_split.cuh``, which
both paged attention launchers include) would leave stale libraries.
"""
import pytest

from repro_torch.kernels import build


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
                                  "kvq_spec_verify_attn"])
def test_paged_launchers_share_the_split_header(name):
    """Both paged attention launchers compile the one split-KV header, so
    an edit to it rebuilds both."""
    hdrs = build.local_includes(build.CSRC / f"{name}.cu")
    assert [p.name for p in hdrs] == ["kvq_paged_split.cuh"]
    assert name in build.SOURCES
