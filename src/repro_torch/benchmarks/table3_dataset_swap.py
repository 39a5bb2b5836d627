"""Table 3 (mechanism reproduction): QAT with the model's original mixture
vs a different open dataset. The paper's finding: a good substitute dataset
matches or beats the original; QAT is not tied to the original data."""
from __future__ import annotations

from repro_torch.benchmarks.common import (Bench, Row, eval_quality,
                                           run_silq)
from repro_torch.configs.base import TrainConfig

QAT_STEPS = 150


def main(row: Row | None = None, bench: Bench = Bench()):
    row = row or Row()
    cfg, teacher = bench.teacher()
    steps = bench.steps(QAT_STEPS)
    tcfg = TrainConfig(precision="A8d-C8-W4", total_steps=steps,
                       ref_steps=steps, batch_size=8, seq_len=64)
    results = {}
    for name, seed in (("original-mixture", 0), ("substitute-dataset", 42)):
        student, _, dt = run_silq(cfg, teacher, tcfg, seed_data=seed)
        e = eval_quality(cfg, student, teacher, tcfg.precision)
        del student
        results[name] = e
        print(f"# table3 {name:22s} agree={e['teacher_agreement']:.4f} "
              f"loss={e['ntp_loss']:.4f}")
        row.add(f"table3/{name}", dt, f"agree={e['teacher_agreement']:.4f}")
    gap = abs(results["original-mixture"]["teacher_agreement"]
              - results["substitute-dataset"]["teacher_agreement"])
    assert gap < 0.08, f"dataset swap should be roughly neutral, gap={gap}"
    return results


if __name__ == "__main__":
    main()
