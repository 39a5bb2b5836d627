#!/usr/bin/env python3
"""Paired end-to-end readings: chip_smoke.py's step phases, another
checkout against this one, in turns on one GPU.

    python3 tools/paired_phases.py --other local/parent [--rounds 3] \
        [--label parent] [--out chiprun_out/paired_phases.json] \
        [--phases serve,qwen_qat,xlstm_qat]

Unpack the other tree first (``git archive <commit> | tar -x -C
local/parent``; ``local/`` is git-ignored). Each round runs both trees,
each in its own subprocess with ``PYTHONPATH`` on its own ``src/`` and
its own ``chip_smoke.py`` (so its own kernels, built into its own
``build/``); the order alternates from round to round (other, this;
this, other; ...). A run drives, through that tree's ``chip_smoke.py``
functions, the dense serve phase (qwen2.5-3b, w4a8, 8 requests through
4 slots), the paged serve phase (prefix sharing, COW, tail-waves), the
qwen2.5-3b QAT phase (36 layers, B 8, T 128) and the xlstm-125m QAT
phase, with every check those functions make; the kernels-versus-plain
gradient comparisons are left out (a check, not a step). It reads the
dense and paged decode step (ms), the paged phase's ``prefill_s``, the
two QAT steps (ms) and a digest of the paged streams, which must agree
across trees and rounds (the paged kernels are bitwise their plain
versions). ``--phases`` keeps a subset: ``serve`` (the two serve
phases), ``qwen_qat``, ``xlstm_qat``.

Prints one JSON line per run, then the median and the min-max spread of
each reading per tree, with the card's name and power limit. Needs one
CUDA GPU; imports nothing of JAX and nothing of ``repro``.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = {"serve": ("dense_decode_step_ms", "paged_decode_step_ms",
                    "paged_prefill_s"),
          "qwen_qat": ("qwen_qat_step_ms",),
          "xlstm_qat": ("xlstm_qat_step_ms",)}
READINGS = tuple(k for keys in PHASES.values() for k in keys)
MARK = "PAIRED_RUN "


def _load_smoke(root: Path):
    """``root``'s chip_smoke.py as a module, with the port it imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_" + hashlib.sha1(str(root).encode()).hexdigest()[:8],
        root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def run_phases(root: Path, phases=tuple(PHASES)) -> dict:
    """One run of ``phases`` of ``root``'s tree (in this process, which
    must have ``root/src`` on its path)."""
    import torch
    cs = _load_smoke(root)
    P = cs.import_port()
    port = Path(P["build"].__file__).resolve()
    if root.resolve() not in port.parents:
        raise RuntimeError(f"the port came from {port}, not from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the readings need the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.grads_vs_plain = lambda *a, **k: None
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)          # the context, before memory stats
    t0 = time.perf_counter()
    P["build"].build_all()
    out = {"build_s": time.perf_counter() - t0}
    cfg = P["get_config"]("qwen2.5-3b")
    report = {}
    if "serve" in phases:
        _, eng = cs.serve(torch, P, cfg, dev, report)
        params = eng.params
        del eng
        torch.cuda.empty_cache()
        _, eng, streams = cs.serve_paged(torch, P, cfg, dev, params, report)
        del eng, params
        torch.cuda.empty_cache()
        out.update({
            "dense_decode_step_ms": report["serve"]["decode_step_ms"],
            "paged_decode_step_ms": report["serve_paged"]["decode_step_ms"],
            "paged_prefill_s": report["serve_paged"]["prefill_s"],
            "paged_launches": report["serve_paged"]["launches"],
            "paged_streams": hashlib.sha256(json.dumps(
                {str(k): [int(t) for t in v]
                 for k, v in sorted(streams.items())}).encode()
            ).hexdigest()[:16]})
    if "qwen_qat" in phases:
        cs.train_full(torch, P, cfg, dev, report)
        torch.cuda.empty_cache()
        out.update({"qwen_qat_step_ms": report["train"]["ms_per_step"],
                    "qwen_qat_split_ms": report["train"]["ms_split"]})
    if "xlstm_qat" in phases:
        cs.train_xlstm(torch, P, P["get_config"]("xlstm-125m"), dev,
                       report)
        out.update({"xlstm_qat_step_ms": report["train_xlstm"]["ms_per_step"],
                    "xlstm_qat_split_ms": report["train_xlstm"]["ms_split"]})
    return out


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def spawn(root: Path, timeout: float, phases) -> dict:
    """One run in a subprocess on ``root``'s own PYTHONPATH."""
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(root), "--phases", ",".join(phases)], env=env, cwd=root,
        capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
    if proc.returncode or not lines:
        raise RuntimeError(f"the run of {root} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len(MARK):])


def summarize(runs: list) -> dict:
    """Median and min-max spread of each reading per tree."""
    out = {}
    for label in dict.fromkeys(r["label"] for r in runs):
        mine = [r for r in runs if r["label"] == label]
        out[label] = {k: {"median": statistics.median(r[k] for r in mine),
                          "min": min(r[k] for r in mine),
                          "max": max(r[k] for r in mine),
                          "n": len(mine)} for k in READINGS if k in mine[0]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path,
                    help="root of the other checkout (e.g. local/parent)")
    ap.add_argument("--label", default="parent",
                    help="what to call the other tree")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds one run may take")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "paired_phases.json")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES))
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = tuple(p for p in args.phases.split(",") if p)
    if not phases or any(p not in PHASES for p in phases):
        ap.error(f"--phases takes a subset of {', '.join(PHASES)}")
    if args.worker:
        print(MARK + json.dumps(run_phases(args.worker, phases)), flush=True)
        return 0
    if args.other is None or not (args.other / "chip_smoke.py").is_file():
        ap.error("--other must be the root of a checkout with chip_smoke.py")
    if args.rounds < 1:
        ap.error("--rounds must be at least 1")
    trees = [(args.label, args.other.resolve()), ("tree", ROOT)]
    the_card = card()
    runs = []
    for r in range(args.rounds):
        for label, root in (trees if r % 2 == 0 else trees[::-1]):
            run = {"round": r, "label": label,
                   **spawn(root, args.timeout, phases)}
            runs.append(run)
            print(json.dumps(run), flush=True)
    digests = {r.get("paged_streams") for r in runs}
    summary = {"card": the_card, "rounds": args.rounds,
               "paged_streams_equal": len(digests) == 1,
               "summary": summarize(runs)}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({**summary, "runs": runs}, indent=1))
    print(the_card)
    print(json.dumps(summary))
    if len(digests) != 1:
        print(f"paired_phases: the paged streams differ between runs: "
              f"{sorted(digests)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
