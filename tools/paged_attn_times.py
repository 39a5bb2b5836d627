#!/usr/bin/env python3
"""Time the paged decode and verify kernels at ``chip_smoke.py``'s shapes,
for this tree's port or for another checkout's.

    python3 tools/paged_attn_times.py [--src OTHER/src] [--label NAME]
                                      [--out FILE]

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
``--src`` times the port under ``OTHER/src`` instead (e.g. an unpacked
parent commit; its kernels are built there at first use). Each case goes
through ``chip_smoke.time_paged_launch``: CUDA-graph replays between
events with inputs rotated past the L2 cache, host-issued ms, the plain
version, SDPA and the bound. Cases: one launch at the paged serve phase's
lengths (512, 1, 97, 200) and at the long cache (32768, 20000, 8192, 1),
bs 64, for ``kvq_paged_decode_attn`` and for ``kvq_spec_verify_attn``
(C = 5: the serve phase's windows, windows ending at the long lengths);
and decode at lengths (1, 1, 1, 1), where the device work is so small
that ``host_issued_ms`` reads the wrapper's own host cost.

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


def cases(cs, torch, cfg, dev):
    """(kernel, case, make): ``make()`` builds one argument set."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    bs = cs.PAGED_BS[0]
    for name, key, arg in (
            ("paged_decode", "host", (1, 1, 1, 1)),
            ("paged_decode", "short", cs.PAGED_LENGTHS),
            ("paged_decode", "long", cs.PAGED_LONG),
            ("spec_verify", "short", None),
            ("spec_verify", "long", cs.window_lengths(cs.PAGED_LONG))):
        if name == "paged_decode":
            def make(arg=arg):
                return cs.paged_inputs(torch, gen, cfg, bs, arg, dev)
        else:
            def make(arg=arg):
                return cs.spec_inputs(torch, gen, cfg, bs, dev, arg)
        yield name, key, make


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.kvq_attn import ops, ref
    if not torch.cuda.is_available():
        print("paged_attn_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{card}; {args.label}: {Path(ops.__file__).resolve()}",
          flush=True)
    P = {"kvq_ops": ops, "kvq_ref": ref}
    cfg = get_config("qwen2.5-3b")
    dev = torch.device("cuda", 0)
    for name, key, make in cases(cs, torch, cfg, dev):
        t = cs.time_paged_launch(torch, P, cfg, name, make(), make)
        t.pop("lengths", None)
        line = {"label": args.label, "card": card, "kernel": name,
                "case": key, **t}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
