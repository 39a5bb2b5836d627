#!/usr/bin/env python3
"""Per-collective cost of two tensor-parallel ranks sharing one card.

    python3 tools/tp_collective_times.py [--ops 300] [--kernels 40]

Spawns two ranks on ``cuda:0`` over gloo (``launch.mesh.spawn_tp``) and
times, on rank 0's host clock, ``--ops`` all-reduces of an int32 (4,
2048) tensor (a decode step's row-parallel accumulator) in three ways:

* ``gloo_cuda``: ``torch.distributed.all_reduce`` on the CUDA tensor
  (gloo's own CUDA path);
* ``staged``: the tensor copied to pinned host memory by hand,
  all-reduced there, and copied back (gloo's CUDA path without gloo's
  own staging);
* ``none``: no collective (the work alone);

each with no work between the collectives and with ``--kernels`` small
elementwise kernels between them (about a layer's worth of a decode
step's kernels between two all-reduces). Prints one JSON line of
milliseconds per iteration. A number from this tool is a property of
two processes on one card over gloo, not of NCCL between cards.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def rank_times(mesh, ops: int, kernels: int) -> dict:
    import torch
    import torch.distributed as dist
    dev = mesh.device
    acc = torch.ones((4, 2048), dtype=torch.int32, device=dev)
    host = torch.empty(acc.shape, dtype=acc.dtype, pin_memory=True)
    x = torch.randn((4, 2048), device=dev)

    def work():
        y = x
        for _ in range(kernels):
            y = y * 1.0001
        return y

    def reduce(way):
        if way == "gloo_cuda":
            dist.all_reduce(acc)
        elif way == "staged":
            host.copy_(acc)
            dist.all_reduce(host)
            acc.copy_(host, non_blocking=True)

    out = {}
    for way in ("none", "gloo_cuda", "staged"):
        for with_work in (False, True):
            for i in range(ops + 20):       # 20 warm-up iterations
                if i == 20:
                    torch.cuda.synchronize()
                    dist.barrier()
                    t0 = time.perf_counter()
                if with_work:
                    work()
                reduce(way)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / ops
            out[f"{way}{'_with_work' if with_work else ''}_ms"] = ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=300)
    ap.add_argument("--kernels", type=int, default=40)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    import subprocess
    from repro_torch.launch.mesh import spawn_tp
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    res = spawn_tp(rank_times, 2, args.ops, args.kernels, device="cuda",
                   backend="gloo", timeout_s=600)
    print(json.dumps({"card": card, "ops": args.ops,
                      "kernels_between": args.kernels, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
