"""Table 2 (mechanism reproduction): SiLQ on open data vs an LLM-QAT-style
pipeline that self-generates its training set from the model. The paper's
point: sampling data from the model costs wall-clock and does not help;
SiLQ with a real dataset reaches better quality in less time.

The self-generated corpus draws its tokens as the reference does: one
key per step from ``jax.random.split``'s threefry chain, one
``categorical`` over the (B, V) logits (``serve/sampling.py``). It
decodes the teacher's unquantized (C16) cache, through the decode kernel
on CUDA (its bf16 element type)."""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (Bench, Row, data_cfg, device_of,
                                           eval_quality, run_silq,
                                           student_of, sync_device)
from repro_torch.configs.base import TrainConfig
from repro_torch.core.qat import make_ctx
from repro_torch.launch.steps import make_train_step
from repro_torch.models import decode_step, prefill
from repro_torch.optim import adamw_init
from repro_torch.serve.sampling import key_categorical, prng_key, split

QAT_STEPS = 150
GEN_SAMPLES = 32          # self-generated corpus size (LLM-QAT style)
GEN_LEN = 64


def selfgen_corpus(cfg, teacher, n: int, length: int):
    """Sample documents from the model itself (the LLM-QAT data recipe).
    Returns ((n, length) int32 tokens, seconds)."""
    ctx = make_ctx("A16-C16-W16", mode="off")
    dev = device_of(teacher)
    outs = []
    sync_device(dev)
    t0 = time.perf_counter()
    B = 8
    with torch.no_grad():
        for start in range(0, n, B):
            tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
            logits, cache = prefill(cfg, teacher, ctx, {"tokens": tok},
                                    cache_budget=length + 2)
            seq = [tok]
            nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            key = prng_key(start)
            for _ in range(length - 1):
                seq.append(nxt)
                logits, cache = decode_step(cfg, teacher, ctx, nxt, cache)
                key, k2 = split(key)
                lg = logits[:, -1]
                nxt = key_categorical(
                    k2, lg / torch.tensor(0.9, dtype=lg.dtype)).to(
                        torch.int32)[:, None]
            outs.append(torch.cat(seq, 1))
    sync_device(dev)
    return torch.cat(outs, 0)[:n], time.perf_counter() - t0


def main(row: Row | None = None, bench: Bench = Bench()):
    row = row or Row()
    cfg, teacher = bench.teacher()
    steps = bench.steps(QAT_STEPS)

    # --- SiLQ on the open synthetic mixture -------------------------------
    tcfg = TrainConfig(precision="A8d-C8-W4", total_steps=steps,
                       ref_steps=steps, batch_size=8, seq_len=64)
    student, _, silq_s = run_silq(cfg, teacher, tcfg)
    e_silq = eval_quality(cfg, student, teacher, tcfg.precision)
    del student

    # --- LLM-QAT-style: self-generate, then QAT on generated data ---------
    corpus, gen_s = selfgen_corpus(cfg, teacher, GEN_SAMPLES, GEN_LEN)
    studentg = student_of(cfg, teacher, tcfg, data_cfg(cfg))
    opt = adamw_init(studentg)
    step_fn = make_train_step(cfg, tcfg)
    dev = corpus.device
    sync_device(dev)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    for step in range(steps):
        idx = torch.from_numpy(rng.integers(0, corpus.shape[0], 8)).to(dev)
        toks = corpus[idx]
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": torch.ones((8, toks.shape[1] - 1),
                                     dtype=torch.float32, device=dev)}
        studentg, opt, _ = step_fn(studentg, teacher, opt, b, step)
    sync_device(dev)
    qat_g_s = time.perf_counter() - t0
    del opt
    e_gen = eval_quality(cfg, studentg, teacher, tcfg.precision)

    print(f"# {'method':24s} {'gen_s':>7s} {'train_s':>8s} {'agree%':>7s}")
    print(f"# {'SiLQ(open data)':24s} {0.0:7.1f} {silq_s:8.1f} "
          f"{e_silq['teacher_agreement'] * 100:7.2f}")
    print(f"# {'LLM-QAT(selfgen)':24s} {gen_s:7.1f} {qat_g_s:8.1f} "
          f"{e_gen['teacher_agreement'] * 100:7.2f}")
    row.add("table2/SiLQ_open_data", silq_s,
            f"agree={e_silq['teacher_agreement']:.4f},gen_s=0")
    row.add("table2/LLMQAT_selfgen", gen_s + qat_g_s,
            f"agree={e_gen['teacher_agreement']:.4f},gen_s={gen_s:.1f}")
    return {"silq": (silq_s, e_silq), "selfgen": (gen_s + qat_g_s, e_gen)}


if __name__ == "__main__":
    main()
