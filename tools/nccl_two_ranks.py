#!/usr/bin/env python3
"""Does NCCL take two ranks of one communicator on one card?

    python3 tools/nccl_two_ranks.py [--timeout SECONDS]

Starts two processes, both on ``cuda:0``, joins them in a ``nccl``
process group (a ``file://`` rendezvous in a temporary directory) and
all-reduces one tensor. Prints each rank's outcome: the sum, or the
error NCCL raised. A rank that has not finished by ``--timeout`` is
killed and reported as hung. This is why ``chip_smoke.py``'s
tensor-parallel phase runs its two ranks over gloo on a one-card
machine. Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import traceback
from datetime import timedelta


def rank_main(rank: int, init: str, timeout_s: float, out) -> None:
    try:
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=init, world_size=2,
                                rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        t = torch.full((4,), float(rank + 1), device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out.put((rank, "ok", f"all_reduce gave {t.tolist()}"))
        dist.destroy_process_group()
    except Exception as e:               # noqa: BLE001 - report any fault
        out.put((rank, "error", f"{type(e).__name__}: {e}\n"
                                f"{traceback.format_exc()[-1500:]}"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timeout", type=float, default=90.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="nccl_two_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    out = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, init, args.timeout, out))
             for r in range(2)]
    for p in procs:
        p.start()
    seen = {}
    try:
        while len(seen) < 2:
            rank, kind, msg = out.get(timeout=args.timeout + 30)
            seen[rank] = (kind, msg)
    except queue.Empty:
        pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()
    for r in range(2):
        kind, msg = seen.get(r, ("hung", f"no result in {args.timeout} s; "
                                        f"killed"))
        print(f"rank {r}: {kind}: {msg}")
    print("nccl two ranks on one card: "
          + ("accepted" if all(seen.get(r, ("",))[0] == "ok"
                               for r in range(2)) else "refused"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
