#!/usr/bin/env python3
"""Time the attention kernels at ``chip_smoke.py``'s shapes, for this
tree's port or for another checkout's.

    python3 tools/attn_times.py [--src OTHER/src] [--label NAME]
                                [--out FILE]

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
``--src`` times the port under ``OTHER/src`` instead (e.g. an unpacked
parent commit; its kernels are built there at first use). Each case goes
through ``chip_smoke``'s timing of that kernel: CUDA-graph replays between
events with inputs rotated past the L2 cache, the plain version, SDPA and
the bound. Cases: ``kvq_paged_decode_attn`` at the paged serve phase's
lengths (512, 1, 97, 200) and at the long cache (32768, 20000, 8192, 1),
bs 64, and at lengths (1, 1, 1, 1), where the device work is so small
that ``host_issued_ms`` reads the wrapper's own host cost;
``kvq_spec_verify_attn`` (C = 5: the serve phase's windows, windows
ending at the long lengths); ``kvq_decode_attn`` at the dense serve
phase's lengths (256, 1, 97, 160) in a 256-token cache and at the long
cache; ``flash_attn_fwd`` at (B 8, S 128) and (B 8, S 1024).

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


def cases(cs, torch, P, cfg, dev):
    """(kernel, case, timing): ``timing()`` times one case."""
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
        yield name, key, lambda name=name, make=make: cs.time_paged_launch(
            torch, P, cfg, name, make(), make)
    for key, lengths, S in (("short", cs.KVQ_LENGTHS, cs.CACHE_LEN),
                            ("long", cs.PAGED_LONG, max(cs.PAGED_LONG))):
        yield "dense_decode", key, lambda lengths=lengths, S=S, key=key: (
            cs.time_dense_launch(torch, P, cfg, dev, gen, lengths, S,
                                 key == "short"))
    for key, (B, S) in (("short", (cs.TRAIN_B, cs.TRAIN_T)),
                        ("long", cs.FLASH_LONG)):
        yield "flash", key, lambda B=B, S=S: cs.time_flash_launch(
            torch, P, cfg, dev, gen, B, S, 4)


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
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.kernels.kvq_attn import ops, ref
    if not torch.cuda.is_available():
        print("attn_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{card}; {args.label}: {Path(ops.__file__).resolve()}",
          flush=True)
    P = {"kvq_ops": ops, "kvq_ref": ref,
         "kvq_decode_attn_ref": ref.kvq_decode_attn_ref, "fa_ops": fa_ops,
         "flash_attn_ref": flash_attn_ref}
    cfg = get_config("qwen2.5-3b")
    dev = torch.device("cuda", 0)
    for name, key, timing in cases(cs, torch, P, cfg, dev):
        t = timing()
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
