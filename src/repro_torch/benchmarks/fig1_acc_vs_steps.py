"""Figure 1 (mechanism reproduction): QAT quality improves with training
duration, crossing the (fixed) PTQ lines. LR follows the paper's sqrt rule
as duration changes."""
from __future__ import annotations

from repro_torch.benchmarks.common import (Bench, Row, eval_quality,
                                           ptq_baselines, run_silq)
from repro_torch.configs.base import TrainConfig

POLICY = "A8d-C8-W4"
DURATIONS = (25, 75, 200, 400)
REF_STEPS = 200


def main(row: Row | None = None, bench: Bench = Bench()):
    row = row or Row()
    cfg, teacher = bench.teacher()
    ptq = {name: eval_quality(cfg, q, teacher, POLICY)["teacher_agreement"]
           for name, q in ptq_baselines(cfg, teacher, POLICY).items()}
    print("# fig1 PTQ lines: " +
          " ".join(f"{k}={v:.4f}" for k, v in ptq.items()))
    durations = DURATIONS if bench.qat_steps is None else (bench.qat_steps,)
    curve = []
    for steps in durations:
        tcfg = TrainConfig(precision=POLICY, total_steps=steps,
                           ref_steps=REF_STEPS, batch_size=8, seq_len=64)
        student, _, dt = run_silq(cfg, teacher, tcfg)
        agree = eval_quality(cfg, student, teacher,
                             POLICY)["teacher_agreement"]
        del student
        curve.append((steps, agree))
        print(f"# fig1 steps={steps:5d} agree={agree:.4f} "
              f"(lr={tcfg.scaled_lr():.2e})")
        row.add(f"fig1/steps={steps}", dt, f"agree={agree:.4f}")
    # monotone-ish improvement: last point beats first
    assert curve[-1][1] >= curve[0][1] - 0.01
    # longest run beats RTN PTQ
    assert curve[-1][1] >= ptq["RTN"] - 0.02
    return {"curve": curve, "ptq": ptq}


if __name__ == "__main__":
    main()
