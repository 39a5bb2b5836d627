#!/usr/bin/env python3
"""Time ``csrc/w4a8_matmul.cu`` with one part of a route changed or taken
out at a time, to see what bounds each route.

    python3 tools/w4a8_ablate.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
Each variant is the committed source with a text replacement (the tool
stops if a pattern is no longer in the source), built with the port's
``nvcc`` flags into a temporary directory and launched through ctypes on
each linear of qwen2.5-3b by ``chip_smoke.time_ms`` (CUDA-graph replays,
weights rotated past the L2 cache): the decode-route variants at M 4,
the tensor-core variants at M 512. Variants that take a part out compute
wrong results and are only timed. Prints the card and one JSON line per
variant and linear, appended to ``--out`` if given.
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
SRC = ROOT / "src/repro_torch/csrc/w4a8_matmul.cu"

_SPLIT = ("  const int splits =\n      min(GV_MAX_SPLIT, (nchunks + "
          "GV_SPLIT_CHUNKS - 1) / GV_SPLIT_CHUNKS);",)
_MMA = ("      mma_s8(acc[i][j], alo[i].",)
# (name, route, replacements): route 1 decode, 2 tensor cores
VARIANTS = (
    ("as committed", 1, ()),
    ("x through L2 only (cp.async.cg)", 1, (
        ("      cp_async16_ca(&xs[h][i][c],",
         "      cp_async16(&xs[h][i][c],"),)),
    ("no weight loads", 1, (
        ("    if (c < rc)\n      cp_async16(&ws[n][c],",
         "    if (c < rc && K < 0)\n      cp_async16(&ws[n][c],"),)),
    ("no dot products", 1, (
        ("    if (c < min(GV_ROUND, c1 - r0)) {",
         "    if (c < min(GV_ROUND, c1 - r0) && K < 0) {"),)),
    ("K split 1", 1, ((_SPLIT[0], "  const int splits = 1;"),)),
    ("K split 2", 1, ((_SPLIT[0], "  const int splits = 2;"),)),
    ("K split 8", 1, ((_SPLIT[0], "  const int splits = 8;"),)),
    ("as committed", 2, ()),
    ("no MMAs", 2, ((_MMA[0], "      if (t < 0) mma_s8(acc[i][j], alo[i]."),)),
    ("K split 1", 2, (("  const int splits = mm_splits(tiles, KT);",
                       "  const int splits = 1;"),)),
)


def build(variants, tmp: Path):
    """{index: shared library path}, all nvcc runs at once."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    text = SRC.read_text()
    procs = {}
    for i, (name, _, subs) in enumerate(variants):
        src = text
        for pat, new in subs:
            if src.count(pat) < 1:
                raise SystemExit(f"variant {name!r}: pattern no longer in "
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
            raise SystemExit(f"variant {variants[i][0]!r} failed:\n{log}")
    return {i: tmp / f"v{i}.so" for i in procs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.w4a8 import ops
    if not torch.cuda.is_available():
        print("w4a8_ablate: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = get_config("qwen2.5-3b")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(VARIANTS, Path(tmp))
        fns = {}
        for i, path in libs.items():
            fn = ctypes.CDLL(str(path)).w4a8_matmul_launch
            fn.argtypes = ops._ARGTYPES
            fn.restype = ctypes.c_int
            fns[i] = fn
        for name, K, N, _ in cs.linear_shapes(cfg):
            nb = N * K // 2
            sets = [cs.w4a8_weights(torch, gen, K, N, False, dev)
                    for _ in range(cs.copies_for(nb))]
            for route, M in ((1, cs.SLOTS), (2, cs.PREFILL_M)):
                if route == 2 and name == "head":
                    continue
                x_q, s_x = cs.w4a8_activations(torch, gen, M, K, dev)
                y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
                for i, (vname, vroute, _) in enumerate(VARIANTS):
                    if vroute != route:
                        continue

                    def call(w, s, b, fn=fns[i]):
                        err = fn(x_q.data_ptr(), w.data_ptr(),
                                 s_x.data_ptr(), s.data_ptr(), None,
                                 y.data_ptr(), M, N, K, route,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{vname}: CUDA error {err}")

                    us = cs.time_ms(torch, call, sets) * 1e3
                    line = {"card": card, "linear": name, "M": M,
                            "route": "decode" if route == 1 else "mma",
                            "variant": vname, "us": us}
                    print(json.dumps(line), flush=True)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps(line) + "\n")
            del sets
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
