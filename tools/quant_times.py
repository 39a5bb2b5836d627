#!/usr/bin/env python3
"""Time ``w4a8_matmul`` and ``fake_quant_bwd`` at ``chip_smoke.py``'s
shapes, for this tree's port or for another checkout's.

    python3 tools/quant_times.py [--src OTHER/src] [--label NAME]
                                 [--out FILE] [--routes]

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
``--src`` times the port under ``OTHER/src`` instead (e.g. an unpacked
parent commit; its kernels are built there at first use). Cases:
``w4a8_matmul`` on each linear of qwen2.5-3b at the decode slots (M 4)
and at one admission wave (M 512), and ``fake_quant_bwd`` at each weight
site of the QAT student step (per output channel at 4 bits; the tied
head per vocab row at 8). Each goes through ``chip_smoke``'s timing:
CUDA-graph replays between events with inputs rotated past the L2
cache, beside the bound (bytes over 3.35 TB/s or int8 operations over
1979 TOP/s, whichever is larger). ``--routes`` instead times both routes
of this tree's ``w4a8_matmul`` forced, at M from 1 to 64 on each linear:
the reading behind the route threshold in ``csrc/w4a8_matmul.cu``.

To compare two versions, run the tool once per version in turn on one
card, alternating (parent, tree, tree, parent, ...): the spread between
the runs of one version is the noise a difference has to clear. Prints
the card (``nvidia-smi`` name, power limit) and one JSON line per case,
and appends the lines to ``--out``, if given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ROUTE_MS = (1, 2, 4, 8, 12, 16, 20, 24, 32, 48, 64)


def w4a8_sets(cs, torch, gen, K, N, bias, dev):
    """Weight copies past the L2 cache, for one linear."""
    nb = N * K // 2 + 4 * N * (2 if bias else 1)
    return [cs.w4a8_weights(torch, gen, K, N, bias, dev)
            for _ in range(cs.copies_for(nb))]


def w4a8_cases(cs, torch, ops, cfg, dev, routes):
    """(case, fields) of one w4a8 linear at one M (and route)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    for name, K, N, _ in cs.linear_shapes(cfg):
        bias = name in ("q", "k", "v")
        sets = w4a8_sets(cs, torch, gen, K, N, bias, dev)
        if routes:
            plan = [(M, r) for M in ROUTE_MS for r in ("decode", "mma")]
        else:
            plan = [(cs.SLOTS, None)] + (
                [] if name == "head" else [(cs.PREFILL_M, None)])
        for M, route in plan:
            x_q, s_x = cs.w4a8_activations(torch, gen, M, K, dev)
            args = [(x_q, w, s_x, s, b) for w, s, b in sets]
            if route is None:
                fn = ops.w4a8_matmul
            else:
                def fn(*a, route=route):
                    return ops.w4a8_matmul_route(*a, route=route)
            ms = cs.time_ms(torch, fn, args,
                            min_calls=30 if M <= 64 else 10)
            bound, by = cs.w4a8_bound_ms(M, K, N, bias)
            yield (f"{name} M={M}" + (f" {route}" if route else ""),
                   {"linear": name, "M": M, "K": K, "N": N,
                    "route": route or "auto", "ms": ms, "bound_ms": bound,
                    "bound_by": by})
        del sets
        torch.cuda.empty_cache()


def fq_bwd_cases(cs, torch, ops, cfg, dev):
    """(case, fields) of fake_quant_bwd at one weight site."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    for site, R, C, mode, bits, per_step in cs.fq_shapes(cfg):
        if not per_step:
            continue
        sets = [cs.fq_inputs(torch, gen, R, C, mode, bits, dev)
                for _ in range(cs.copies_for(R * C * 2))]
        ms = cs.time_ms(torch, lambda x, s, g: ops.fake_quant_bwd(
            x, s, g, bits), sets)
        n_s = sets[0][1].numel()
        bound = (6 * R * C + 8 * n_s) / cs.HBM_BYTES_PER_S * 1e3
        yield site, {"site": site, "R": R, "C": C, "mode": mode,
                     "bits": bits, "per_step": per_step, "ms": ms,
                     "bound_ms": bound, "bound_by": "bytes"}
        del sets
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default="")
    ap.add_argument("--routes", action="store_true",
                    help="time both w4a8 routes forced at M 1..64")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant import ops as fq_ops
    from repro_torch.kernels.w4a8 import ops as w4a8_ops
    if not torch.cuda.is_available():
        print("quant_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{card}; {args.label}: {Path(w4a8_ops.__file__).resolve()}",
          flush=True)
    cfg = get_config("qwen2.5-3b")
    dev = torch.device("cuda", 0)
    kernels = [("w4a8_matmul", w4a8_cases(cs, torch, w4a8_ops, cfg, dev,
                                          args.routes))]
    if not args.routes:
        kernels.append(("fake_quant_bwd",
                        fq_bwd_cases(cs, torch, fq_ops, cfg, dev)))
    for kernel, cases in kernels:
        for case, fields in cases:
            line = {"label": args.label, "card": card, "kernel": kernel,
                    "case": case, **fields}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
