"""Benchmark entry point: one function per paper table/figure.

Prints ``name,us_per_call,derived`` CSV rows ('#' lines are the
human-readable table reproductions). Runs on ``cuda`` unless told
otherwise; the default scale is the reference benchmarks' (reduced
config, 400 teacher steps, each table's QAT steps)::

    python -m repro_torch.benchmarks.run table1 --full     # on the card
    python -m repro_torch.benchmarks.run table1 --device cpu

``--teacher-steps`` and ``--qat-steps`` cut the steps (the widths stay);
``--cache-dir`` moves the teacher cache. The reference's ``roofline``
suite reads the dry run's artifacts and waits for the port's dry run.
"""
from __future__ import annotations

import argparse
import time
import traceback

from repro_torch.benchmarks import (fig1_acc_vs_steps, fig3_rotation,
                                    table1_ptq_vs_qat,
                                    table2_time_to_quality,
                                    table3_dataset_swap, table4_ablations)
from repro_torch.benchmarks.common import ART, TEACHER_STEPS, Bench, Row

SUITES = {
    "table1": table1_ptq_vs_qat.main,
    "table2": table2_time_to_quality.main,
    "table3": table3_dataset_swap.main,
    "table4": table4_ablations.main,
    "fig1": fig1_acc_vs_steps.main,
    "fig3": fig3_rotation.main,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("suites", nargs="*",
                    help=f"of {sorted(SUITES)} (default: all)")
    ap.add_argument("--full", action="store_true",
                    help="the published config (needs the GPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--teacher-steps", type=int, default=TEACHER_STEPS)
    ap.add_argument("--qat-steps", type=int, default=None,
                    help="QAT steps of every run (default: each table's)")
    ap.add_argument("--cache-dir", default=ART)
    args = ap.parse_args(argv)
    unknown = sorted(set(args.suites) - set(SUITES))
    if unknown:
        ap.error(f"unknown suites {unknown}; known: {sorted(SUITES)}")
    bench = Bench(full=args.full, device=args.device,
                  cache_dir=args.cache_dir,
                  teacher_steps=args.teacher_steps, qat_steps=args.qat_steps)
    row = Row()
    print("name,us_per_call,derived")
    failures = []
    for name in args.suites or list(SUITES):
        t0 = time.perf_counter()
        try:
            SUITES[name](row, bench)
            print(f"# {name} done in {time.perf_counter() - t0:.1f}s",
                  flush=True)
        except Exception as e:          # report every suite, then fail
            failures.append(name)
            print(f"# {name} FAILED: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    row.emit()
    if failures:
        raise SystemExit(f"benchmark failures: {failures}")


if __name__ == "__main__":
    main()
