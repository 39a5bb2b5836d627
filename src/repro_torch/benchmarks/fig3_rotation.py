"""Figure 3 (mechanism reproduction): factor weight changes into rotational
vs non-rotational parts (orthogonal Procrustes). Expectation, as in the
paper: rotation-based PTQ weight changes are predominantly rotational;
SiLQ's QAT changes are substantially non-rotational, a solution space
rotations cannot reach."""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import Bench, Row, data_cfg, run_silq
from repro_torch.configs.base import TrainConfig
from repro_torch.core.analysis.rotation import (rotate_residual,
                                                rotation_report,
                                                rotational_share)
from repro_torch.core.precision import parse_policy
from repro_torch.core.ptq.rtn import rtn_quantize
from repro_torch.data import calibration_batches

QAT_STEPS = 200
POLICY = "A8d-C8-W4"


def main(row: Row | None = None, bench: Bench = Bench()):
    row = row or Row()
    cfg, teacher = bench.teacher()
    pol = parse_policy(POLICY)
    cb = calibration_batches(data_cfg(cfg), 3)

    # rotation-PTQ path: residual rotation + RTN (SpinQuant-style)
    dev = teacher["embed"]["w"].device
    rotated = rotate_residual(cfg, teacher,
                              torch.Generator(device=dev).manual_seed(11))
    rotated_q = rtn_quantize(cfg, rotated, pol, cb)
    del rotated
    rep_rot = rotation_report(cfg, teacher, rotated_q)
    del rotated_q

    # SiLQ path: QAT from the same teacher
    steps = bench.steps(QAT_STEPS)
    tcfg = TrainConfig(precision=POLICY, total_steps=steps,
                       ref_steps=steps, batch_size=8, seq_len=64)
    student, _, dt = run_silq(cfg, teacher, tcfg)
    rep_qat = rotation_report(cfg, teacher, student)

    s_rot, s_qat = rotational_share(rep_rot), rotational_share(rep_qat)
    print(f"# fig3 rotational share: rotation-PTQ={s_rot:.3f} "
          f"SiLQ-QAT={s_qat:.3f}")
    for name, rep in (("rotationPTQ", rep_rot), ("SiLQ", rep_qat)):
        for lt, d in rep.items():
            print(f"#   {name:12s} {lt:4s} rot={d['rotational']:.4f} "
                  f"nonrot={d['non_rotational']:.4f}")
    row.add("fig3/rotation_ptq_share", 0.0, f"rot_share={s_rot:.4f}")
    row.add("fig3/silq_share", dt, f"rot_share={s_qat:.4f}")
    assert s_rot > s_qat + 0.15, \
        "rotation PTQ must be more rotational than QAT"
    return {"rotation_ptq": s_rot, "silq": s_qat}


if __name__ == "__main__":
    main()
