"""Guards of the port: it imports no jax and nothing of the JAX package,
its entry points refuse to run on the CPU unless asked, and CPU tensors
take the plain versions without ever building or launching a kernel.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# a meta-path finder that refuses jax, jaxlib and the JAX package; run in
# a fresh interpreter so this test process's own imports stay untouched
_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["chip_smoke"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(m.name)
for name in names:
    importlib.import_module(name)
assert "repro_torch.serve.spec" in names, names
assert "repro_torch.serve.scheduler" in names, names
for new in ("kernels.quant.ops", "kernels.flash_attn.ops", "core.calibration",
            "core.distill", "optim.adamw", "optim.schedules",
            "data.synthetic", "data.loader", "launch.steps", "launch.train",
            "checkpoint.checkpointer", "runtime.fault", "tree"):
    assert "repro_torch." + new in names, new
import chip_smoke
chip_smoke.import_port()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("imported", len(names))
"""


def _run(code, cwd=ROOT, timeout=180):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_and_chip_smoke_import_without_jax_or_repro():
    r = _run(_BLOCKED_IMPORTS.format(src=str(SRC), root=str(ROOT)))
    assert r.returncode == 0, r.stderr
    n = int(r.stdout.split()[-1])
    assert n >= 20                       # every module of the port was seen


def test_chip_smoke_fails_without_cuda():
    """With no GPU visible the script exits non-zero and prints no result."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_unless_told_cpu(no_cuda):
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServeEngine
    cfg = get_reduced_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--requests", "1"])
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    assert params["embed"]["w"].device.type == "cpu"


def test_cpu_serving_takes_plain_versions_only(monkeypatch):
    """A w4a8 engine on the CPU runs both kernels' plain versions: no
    kernel is built or loaded, and the launch counters stay at 0."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import build
    from repro_torch.kernels.kvq_attn.ops import kvq_decode_attn
    from repro_torch.kernels.w4a8.ops import w4a8_matmul
    from repro_torch.models import init_params
    from repro_torch.serve.engine import Request, ServeEngine

    def refuse(*a, **k):
        raise AssertionError("a CPU run tried to build or load a kernel")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    before = (w4a8_matmul.launches, kvq_decode_attn.launches)
    cfg = get_reduced_config("qwen2.5-3b")
    eng = ServeEngine(cfg, init_params(cfg, seed=1, device="cpu"),
                      slots=2, cache_len=32, weights_layout="w4a8",
                      device="cpu")
    reqs = [Request(uid=i, prompt=np.arange(3 + 5 * i, dtype=np.int32),
                    max_new_tokens=4) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    assert stats["tokens_out"] == 12 and stats["device"] == "cpu"
    assert (w4a8_matmul.launches, kvq_decode_attn.launches) == before == (0, 0)


def test_cpu_spec_and_preemption_take_plain_versions_only(monkeypatch):
    """The paged engine with speculative decoding and optimistic admission
    on the CPU: requests preempt, swap and verify through the plain
    versions, and no kernel is built, loaded or counted."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import build
    from repro_torch.kernels.kvq_attn import ops
    from repro_torch.kernels.w4a8.ops import w4a8_matmul
    from repro_torch.models import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import SpecConfig

    def refuse(*a, **k):
        raise AssertionError("a CPU run tried to build or load a kernel")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    counted = (w4a8_matmul, ops.kvq_decode_attn, ops.kvq_paged_decode_attn,
               ops.kvq_spec_verify_attn, ops.gather_dequant_paged_kv,
               ops.copy_pool_blocks)
    before = [fn.launches for fn in counted]
    cfg = get_reduced_config("qwen2.5-3b")
    eng = ServeEngine(cfg, init_params(cfg, seed=1, device="cpu"), slots=3,
                      cache_len=64, kv_layout="paged", block_size=8,
                      num_blocks=8, max_seq_len=96, admission="optimistic",
                      prefix_cache=False, spec=SpecConfig(k=2),
                      weights_layout="w4a8", device="cpu")
    reqs = [Request(uid=i, prompt=(np.arange(10, dtype=np.int32) * 7 + i)
                    % 250, max_new_tokens=30) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert all(r.done and len(r.generated) == 30 for r in reqs)
    assert stats["preemptions"] >= 1 and stats["spec_waves"] > 0
    assert [fn.launches for fn in counted] == before == [0] * 6


def test_build_targets_are_content_addressed(monkeypatch, tmp_path):
    """Each CUDA source exists and builds to a name hashed from its text
    and flags; without nvcc the build raises (it never falls back)."""
    from repro_torch.kernels import build
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        t = build._target(name)
        assert t.parent == build.BUILD_DIR and t.name.startswith(name + "-")
        assert t == build._target(name)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if not Path("/usr/local/cuda/bin/nvcc").is_file():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.nvcc_path()
