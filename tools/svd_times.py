#!/usr/bin/env python3
"""Time the float64 singular values behind ``rotation_report`` on a CUDA
GPU, by cuSOLVER routine.

    python3 tools/svd_times.py [--batch 12] [--big 11008]

Run on a machine with a CUDA GPU. ``torch.linalg.svdvals`` on a batch of
``--batch`` random f64 2048-squares (the Procrustes products of
qwen2.5-3b at full width, batched by layer as ``rotation_report`` batches
them) under torch's default routine and each cuSOLVER one (``gesvd``:
QR iteration; ``gesvdj``: Jacobi; ``gesvda``: cuSOLVER's approximate
routine for tall matrices), each against the default's values (largest
relative gap and the relative gap of the sums, the nuclear norms
Procrustes takes); then one ``--big``-square (the direct n x n product
of a full-width ``wd``) under the default and ``gesvd`` (0 skips it).
Prints the card (``nvidia-smi`` name, power limit) and one JSON line per
case.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


def timed(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--big", type=int, default=11008)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("svd_times: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.batch, 2048, 2048), dtype=torch.float64,
                    device=dev, generator=gen)
    ref = None
    for routine in (None, "gesvd", "gesvdj", "gesvda"):
        s, out = timed(lambda: torch.linalg.svdvals(x, driver=routine))
        ref = out if ref is None else ref
        print(json.dumps({
            "case": f"{args.batch} x 2048^2", "routine": routine or "default",
            "s": s, "max_rel_vs_default": float(
                (out - ref).abs().max() / ref.abs().max()),
            "sum_rel_vs_default": float(
                ((out.sum(-1) - ref.sum(-1)).abs()
                 / ref.sum(-1).abs()).max())}), flush=True)
    del x, out, ref
    if args.big:
        y = torch.randn((args.big, args.big), dtype=torch.float64,
                        device=dev, generator=gen)
        for routine in (None, "gesvd"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total = float(torch.linalg.svdvals(y, driver=routine).sum())
            torch.cuda.synchronize()
            print(json.dumps({"case": f"{args.big}^2",
                              "routine": routine or "default",
                              "s": time.perf_counter() - t0,
                              "nuclear": total}), flush=True)


if __name__ == "__main__":
    main()
