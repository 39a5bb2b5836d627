"""Table 4 (mechanism reproduction): ablations around the SiLQ recipe.
Paper's two critical factors: pure-KD loss and quantile activation
calibration. Each row is one short QAT run differing in one knob."""
from __future__ import annotations

from repro_torch.benchmarks.common import (Bench, Row, eval_quality,
                                           run_silq)
from repro_torch.configs.base import TrainConfig

QAT_STEPS = 150
BASE = dict(precision="A8s-C8-W4", batch_size=8, seq_len=64)

ABLATIONS = [
    ("baseline", {}),
    ("kd_ratio=0.0(pure-NTP)", {"kd_ratio": 0.0}),
    ("kd_ratio=0.5(mixed)", {"kd_ratio": 0.5}),
    ("kd_temp=0.5", {"kd_temperature": 0.5}),
    ("kd_temp=2.0", {"kd_temperature": 2.0}),
    ("dclm_ratio=0.0", {"dclm_ratio": 0.0}),
    ("dclm_ratio=0.5", {"dclm_ratio": 0.5}),
    ("act_lrx=1(no boost)", {"act_scale_lr_mult": 1.0}),
    ("act_calib=max", {"act_calib_method": "max"}),
    ("wgt_calib=lsq", {"wgt_calib_method": "lsq"}),
]


def main(row: Row | None = None, bench: Bench = Bench()):
    row = row or Row()
    cfg, teacher = bench.teacher()
    steps = bench.steps(QAT_STEPS)
    results = {}
    print(f"# {'ablation':26s} {'agree%':>7s} {'d_base':>7s} {'KL':>9s}")
    base_agree = None
    for name, overrides in ABLATIONS:
        tcfg = TrainConfig(**{**BASE, "total_steps": steps,
                              "ref_steps": steps, **overrides})
        student, _, dt = run_silq(cfg, teacher, tcfg)
        e = eval_quality(cfg, student, teacher, tcfg.precision)
        del student
        results[name] = e
        if base_agree is None:
            base_agree = e["teacher_agreement"]
        delta = e["teacher_agreement"] - base_agree
        print(f"# {name:26s} {e['teacher_agreement'] * 100:7.2f} "
              f"{delta * 100:+7.2f} {e.get('teacher_kl', 0):9.5f}")
        row.add(f"table4/{name}", dt,
                f"agree={e['teacher_agreement']:.4f};"
                f"kl={e.get('teacher_kl', 0):.5f}")
    # the paper's headline ablation effect
    assert results["baseline"]["teacher_agreement"] >= \
        results["kd_ratio=0.0(pure-NTP)"]["teacher_agreement"] - 1e-6, \
        "pure KD should beat pure next-token prediction"
    return results


if __name__ == "__main__":
    main()
