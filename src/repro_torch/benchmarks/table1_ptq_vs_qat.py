"""Table 1 (mechanism reproduction): SiLQ vs PTQ baselines across precision
configs. Expected ordering, as in the paper: SiLQ > SmoothQuant/RTN at every
A-C-W config, approaching the fp16 baseline."""
from __future__ import annotations

import time

from repro_torch.benchmarks.common import (Bench, Row, eval_quality,
                                           ptq_baselines, run_silq)
from repro_torch.configs.base import TrainConfig

POLICIES = ("A8d-C8-W4", "A8s-C8-W4", "A8d-C4-W4")
QAT_STEPS = 300


def main(row: Row | None = None, bench: Bench = Bench()):
    row = row or Row()
    qat_steps = bench.steps(QAT_STEPS)
    cfg, teacher = bench.teacher()
    base = eval_quality(cfg, teacher, teacher, "A16-C16-W16")
    print(f"# Table1 baseline fp16: loss={base['ntp_loss']:.4f} "
          f"agree={base['teacher_agreement']:.3f}")
    results = {"Baseline-16-16-16": (0.0, base)}
    for pol in POLICIES:
        t0 = time.perf_counter()
        ptq = ptq_baselines(cfg, teacher, pol)
        for name in list(ptq):
            q = ptq.pop(name)          # free each tree before the next run
            dt = time.perf_counter() - t0
            e = eval_quality(cfg, q, teacher, pol)
            del q
            results[f"{name}-{pol}"] = (dt, e)
        tcfg = TrainConfig(precision=pol, total_steps=qat_steps,
                           ref_steps=qat_steps, batch_size=8, seq_len=64)
        student, _, train_s = run_silq(cfg, teacher, tcfg)
        e = eval_quality(cfg, student, teacher, pol)
        del student
        results[f"SiLQ-{pol}"] = (train_s, e)
    print(f"# {'method':28s} {'ntp_loss':>9s} {'agree%':>7s} "
          f"{'KL(T||S)':>9s} {'time_s':>7s}")
    for name, (dt, e) in results.items():
        print(f"# {name:28s} {e['ntp_loss']:9.4f} "
              f"{e['teacher_agreement'] * 100:7.2f} "
              f"{e.get('teacher_kl', 0):9.5f} {dt:7.1f}")
        row.add(f"table1/{name}", dt,
                f"agree={e['teacher_agreement']:.4f};"
                f"kl={e.get('teacher_kl', 0):.5f}")
    # the paper's headline claim, as an assertion
    for pol in POLICIES:
        assert results[f"SiLQ-{pol}"][1]["teacher_agreement"] >= \
            results[f"SmoothQuant-{pol}"][1]["teacher_agreement"] - 0.02, pol
    return results


if __name__ == "__main__":
    main()
