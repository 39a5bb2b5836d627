#!/usr/bin/env python3
"""Time the multi-leaf COW launcher of ``csrc/pool_block_copy.cu`` with
one part changed or taken out at a time, to see what a COW's launch
spends its time on (the launch itself, the pair's ids, the copy, the
loads a thread keeps in flight, the threads a CUDA block).

    python3 tools/copy_ablate.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
Each variant is the committed source with a text replacement (the tool
stops if a pattern is no longer in the source), built with the port's
``nvcc`` flags into a temporary directory and launched through ctypes
on the paged serve phase's four pool leaves (qwen2.5-3b: 36 layers, 2
KV heads, blocks of 64, head_dim 128) for one COW pair, by
``chip_smoke.time_ms`` (CUDA-graph replays, leaves rotated past the L2
cache). Variants that take a part out copy wrong bytes and are only
timed. Prints the card and one JSON line per variant, appended to
``--out`` if given.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SRC = ROOT / "src/repro_torch/csrc/pool_block_copy.cu"

_IDS = ("  const int d = pairs[n + i];\n",
        "  const int s = min(max(pairs[i], 0), NB - 1);\n")
_VPT = "constexpr int VPT = 4; "
_THREADS = "constexpr int THREADS = 256;"
VARIANTS = (
    ("as committed", ()),
    ("empty (returns at once)",
     ((_IDS[0], "  if (n >= 0) return;\n" + _IDS[0]),)),
    ("ids read, nothing copied",
     ((_IDS[1], _IDS[1] + "  if (d + s != -7) return;\n"),)),
    ("one vector a leaf before the stores (VPT 1)",
     ((_VPT, "constexpr int VPT = 1; "),)),
    ("128 threads a CUDA block",
     ((_THREADS, "constexpr int THREADS = 128;"),)),
    ("512 threads a CUDA block",
     ((_THREADS, "constexpr int THREADS = 512;"),)),
    ("as committed, again", ()),
)
PAIR = (3, 20)


def build(tmp: Path):
    """{index: shared library path}, all nvcc runs at once."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    text = SRC.read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS):
        src = text
        for pat, new in subs:
            if src.count(pat) != 1:
                raise SystemExit(f"variant {name!r}: pattern not once in "
                                 f"the source: {pat!r}")
            src = src.replace(pat, new)
        cu = tmp / f"v{i}.cu"
        cu.write_text(src)
        procs[i] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp / f"v{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for i, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {VARIANTS[i][0]!r} failed:\n{log}")
    return {i: tmp / f"v{i}.so" for i in procs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    P = cs.import_port()
    ops = P["kvq_ops"]
    if not torch.cuda.is_available():
        raise SystemExit("copy_ablate: no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = P["get_config"]("qwen2.5-3b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    nb = cs.PAGED_TOKENS * cs.SLOTS // 64
    base = cs.pool_leaves(torch, gen, cfg, nb, 64, dev)
    sets = [(base,)] + [([x.clone() for x in base],) for _ in range(
        cs.copies_for(cs.tensor_bytes(*base)) - 1)]
    pairs = torch.tensor([[PAIR[0]], [PAIR[1]]], dtype=torch.int32,
                         device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for i, (name, _) in enumerate(VARIANTS):
            fn = ctypes.CDLL(str(libs[i])).pool_block_copy_multi_launch
            fn.argtypes = list(ops._ARGTYPES["pool_block_copy_multi"])
            fn.restype = ctypes.c_int

            def launch(leaves, fn=fn):
                descs = []
                for x in leaves:
                    descs += [x.data_ptr(), *ops._copy_leaf_dims(x)]
                err = fn(*descs, len(leaves), pairs.data_ptr(), 1,
                         leaves[0].shape[0], nb,
                         torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            line = {"variant": name, "us_per_cow": 1e3 * cs.time_ms(
                torch, launch, sets, min_calls=60)}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with args.out.open("a") as f:
            for line in lines:
                f.write(json.dumps({"card": smi.stdout.strip(), **line})
                        + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
