#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and the CUDA
toolkit (``nvcc``). Phases, each fatal on failure (non-zero exit):

1. device and build: print ``nvidia-smi``'s name and power limit, build
   every CUDA kernel of the path from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once);
2. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: ``w4a8_matmul`` bitwise at M = slots and M = one prefill
   batch, for every linear of qwen2.5-3b with and without bias;
   ``kvq_decode_attn`` within one bf16 ulp on ragged lengths;
   ``kvq_paged_decode_attn`` within one bf16 ulp at block sizes 64 and 16
   on shuffled tables with sentinels and a parked row;
   ``gather_dequant_paged_kv`` and ``pool_block_copy`` bitwise;
   ``kvq_spec_verify_attn`` within one bf16 ulp at both block sizes, each
   query bitwise equal to ``kvq_paged_decode_attn`` at its length;
   ``rms_norm`` bitwise across row counts; ``fake_quant_fwd`` and the
   ``dx`` of ``fake_quant_bwd`` bitwise at bits 4 and 8 on every weight
   shape of qwen2.5-3b (the tied head per vocab row) and two activation
   shapes per tensor, its ``ds`` within 1e-4 of its sums' mass;
   ``flash_attn_fwd`` against its plain version and an f64 oracle at the
   QAT shape, S 1024, a ragged S and a sliding window;
3. serve: ``ServeEngine`` on ``cuda`` with qwen2.5-3b at full width
   (random weights from a seed), policy A8d-C8-W4, w4a8 weights, dense
   KV cache; 8 mixed-length requests through 4 slots, both kernels'
   launch counts > 0, every request finished, tokens in the vocabulary;
   one decode step's logits against the same engine on the plain
   versions;
3b. paged serve: the same model on the paged pool (4 slots, blocks of
   64, 32 blocks, prefix cache on); 8 requests sharing a 160-token prefix,
   so prefix hits, copy-on-write of the split block and tail-waves all
   happen; the three paged kernels' launch counts > 0 and the dense decode
   kernel's 0; one decode step's logits paged vs dense and kernels vs
   plain versions;
3c. spec serve: the paged phase's requests with speculative decoding at
   the CLI's defaults (k = 4, an 18-layer draft, exact mode); the verify
   kernel and the draft's dense decode kernel launch, the paged decode
   kernel does not, and every stream equals 3b's;
3d. self-draft: the target as its own draft; the verify-wave's logits
   against sequential decode steps' at one wave, and the accept rate;
   then a tail-wave row alone against the same row beside a deeper one,
   bitwise;
3e. optimistic admission on about 60% of the worst-case pool (spec on,
   prefix cache off): at least one preemption, swap bytes out == in, and
   every stream equal to reserve admission's;
5. QAT: ``run_qat`` on qwen2.5-3b at full width and depth, A8d-C8-W4,
   2 teacher steps (autograd attention), MSE weight calibration, 4 steps
   at B 8, T 128: 253 ``fake_quant_fwd`` and 253 ``fake_quant_bwd``
   launches and 36 ``flash_attn_fwd`` launches (the teacher) per step,
   finite KD losses, every ``s_w`` moved, AdamW moments non-zero on every
   read leaf, no NaN; ms per step split into teacher forward, student
   forward and backward and optimizer, tokens/s, peak memory, the
   device's idle share (``torch.profiler``) and the model-FLOPs share;
   then one loss and backward through the kernels against the plain
   versions;
5b. a static policy (A8s-C8-W4) at full width and 4 layers: percentile
   calibration over 5 batches (``flash_attn_fwd`` in the calibration
   forward), one step, per-tensor fake-quant launches;
4. times: each kernel per decode step, verify-wave, tail-wave, COW,
   student step or teacher forward (CUDA events, L2 flushed by rotating
   input copies past 100 MB), its plain version, one PyTorch call
   computing the same function (a yardstick the port never calls) and
   the least time the card needs for the work; decode tok/s and TTFT of
   the serve phases.

The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20

SLOTS = 4
CACHE_LEN = 256
MAX_NEW = 32
PREFILL_M = SLOTS * 128        # one admission wave: 4 prompts padded to 128
KVQ_TOL = (2.0 ** -7, 1e-4)    # rtol (one bf16 ulp), atol
LOGIT_REL_TOL = 5e-2           # relative L2 error of one decode step


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def import_port():
    """The port's modules this script drives (fails outside a checkout)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import qat
    from repro_torch.core.distill import silq_loss
    from repro_torch.core.quantizer import unpack_int4
    from repro_torch.data import MixtureIterator, SyntheticConfig, to_device
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.kernels.quant import ops as fq_ops
    from repro_torch.kernels.quant import ref as fq_ref
    from repro_torch.kernels.kvq_attn import ops as kvq_ops
    from repro_torch.kernels.kvq_attn import ref as kvq_ref
    from repro_torch.kernels.kvq_attn.ref import kvq_decode_attn_ref
    from repro_torch.kernels.w4a8 import ops as w4a8_ops
    from repro_torch.kernels.w4a8.ref import w4a8_matmul_ref
    from repro_torch import models
    from repro_torch.launch import steps, train
    from repro_torch.models.common import rms_norm
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import SpecConfig
    return dict(get_config=get_config, qat=qat, unpack_int4=unpack_int4,
                build=build, kvq_ops=kvq_ops, kvq_ref=kvq_ref,
                kvq_decode_attn_ref=kvq_decode_attn_ref, w4a8_ops=w4a8_ops,
                w4a8_matmul_ref=w4a8_matmul_ref, models=models,
                rms_norm=rms_norm, Request=Request, ServeEngine=ServeEngine,
                SpecConfig=SpecConfig, Tracer=Tracer, TrainConfig=TrainConfig,
                MixtureIterator=MixtureIterator,
                SyntheticConfig=SyntheticConfig, to_device=to_device,
                fa_ops=fa_ops, flash_attn_ref=flash_attn_ref, fq_ops=fq_ops,
                fq_ref=fq_ref, steps=steps, train=train,
                silq_loss=silq_loss)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(torch, fn, arg_sets, min_calls=30):
    """Device ms per call of ``fn(*args)`` cycling through ``arg_sets``
    (copies whose total exceeds the L2 cache, so every call reads its
    inputs from device memory). The calls are captured once in a CUDA
    graph and the graph is replayed between two events, so the host's
    per-call launch cost stays out of the number."""
    n = max(min_calls, len(arg_sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                   # warmup off-capture
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / n


def host_issued_ms(torch, fn, arg_sets, min_calls=30):
    """Wall ms per call when the host issues the calls one by one (what
    the eager serving loop pays): host launch cost included."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    n = max(min_calls, len(arg_sets))
    t0 = time.perf_counter()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def copies_for(nbytes):
    return max(1, min(256, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# --------------------------------------------------------------------------
# phase 2 + 4: w4a8_matmul
# --------------------------------------------------------------------------

def linear_shapes(cfg):
    """(name, K, N, launches per decode step) of every served linear."""
    d, f, qd, kvd = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim
    L = cfg.n_layers
    return [("q", d, qd, L), ("k", d, kvd, L), ("v", d, kvd, L),
            ("o", qd, d, L), ("gate", d, f, L), ("up", d, f, L),
            ("down", f, d, L), ("head", d, cfg.vocab_size, 1)]


def w4a8_activations(torch, gen, M, K, dev):
    x_q = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                        dtype=torch.int8)
    s_x = torch.rand((M, 1), generator=gen, device=dev) * 0.05 + 1e-3
    return x_q, s_x


def w4a8_weights(torch, gen, K, N, bias, dev):
    w_p = torch.randint(0, 256, (N, K // 2), generator=gen, device=dev,
                        dtype=torch.uint8)
    s_w = torch.rand((N,), generator=gen, device=dev) * 0.05 + 1e-3
    b = torch.randn((N,), generator=gen, device=dev) if bias else None
    return w_p, s_w, b


def w4a8_inputs(torch, gen, M, K, N, bias, dev):
    x_q, s_x = w4a8_activations(torch, gen, M, K, dev)
    w_p, s_w, b = w4a8_weights(torch, gen, K, N, bias, dev)
    return x_q, w_p, s_x, s_w, b


def w4a8_bound_ms(M, K, N, bias):
    nbytes = M * K + N * K // 2 + 4 * M + 4 * N + (4 * N if bias else 0) \
        + 2 * M * N
    ops = 2 * M * N * K
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_w4a8(torch, P, cfg, dev, report):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    w4a8_matmul = P["w4a8_ops"].w4a8_matmul
    ref = P["w4a8_matmul_ref"]
    n_cmp = 0
    for name, K, N, _ in linear_shapes(cfg):
        for M in (SLOTS, PREFILL_M):
            for bias in (False, True):
                args = w4a8_inputs(torch, gen, M, K, N, bias, dev)
                got = w4a8_matmul(*args)
                want = ref(*args)
                torch.cuda.synchronize()
                check(got.dtype == want.dtype == torch.bfloat16
                      and got.shape == want.shape,
                      f"w4a8 {name} M={M}: dtype/shape")
                if not torch.equal(got, want):
                    diff = (got.float() - want.float()).abs()
                    raise SmokeFailure(
                        f"w4a8_matmul {name} M={M} bias={bias} K={K} N={N} "
                        f"differs from its plain version: "
                        f"{int((diff > 0).sum())} elements, max "
                        f"{float(diff.max())}")
                n_cmp += 1
                del got, want, args
    report["w4a8_compared"] = n_cmp
    print(f"phase 2: w4a8_matmul bitwise equal to its plain version on "
          f"{n_cmp} cases (M in {{{SLOTS}, {PREFILL_M}}}, 8 linears, "
          f"with/without bias)", flush=True)
    return 0.0


def time_w4a8(torch, P, cfg, dev, report):
    """Per-shape times at M = slots, summed over one decode step."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    w4a8_matmul = P["w4a8_ops"].w4a8_matmul
    ref = P["w4a8_matmul_ref"]
    unpack = P["unpack_int4"]
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    t_bytes = t_ops = 0.0
    rows = []
    for name, K, N, per_step in linear_shapes(cfg):
        bias = name in ("q", "k", "v")          # qwen2.5's QKV bias
        M = SLOTS
        x_q, s_x = w4a8_activations(torch, gen, M, K, dev)
        nb = N * K // 2 + 4 * N * (2 if bias else 1)
        sets = []
        for _ in range(copies_for(nb)):
            w_p, s_w, b = w4a8_weights(torch, gen, K, N, bias, dev)
            sets.append((x_q, w_p, s_x, s_w, b))
        t_k = time_ms(torch, w4a8_matmul, sets)
        t_host = host_issued_ms(torch, w4a8_matmul, sets)
        t_p = time_ms(torch, ref, sets[:copies_for(nb * 9)], min_calls=5)
        x_deq = (x_q.float() * s_x).to(torch.bfloat16)
        lib_sets = []
        for s in sets[:copies_for(N * K * 2)]:
            w_deq = (unpack(s[1]).float() * s[3][:, None]).to(torch.bfloat16)
            lib_sets.append((x_deq, w_deq.T))
        t_l = time_ms(torch, torch.matmul, lib_sets)
        bound, by = w4a8_bound_ms(M, K, N, bias)
        # the same linear at one admission wave's M (prefill)
        xp_q, sp_x = w4a8_activations(torch, gen, PREFILL_M, K, dev)
        t_pre = time_ms(torch, w4a8_matmul,
                        [(xp_q,) + (s[1], sp_x) + s[3:] for s in sets],
                        min_calls=10)
        rows.append({"linear": name, "M": M, "K": K, "N": N,
                     "prefill_M": PREFILL_M, "prefill_ms": t_pre,
                     "prefill_bound_ms": w4a8_bound_ms(PREFILL_M, K, N,
                                                       bias)[0],
                     "per_decode_step": per_step, "ms": t_k,
                     "host_issued_ms": t_host, "plain_ms": t_p,
                     "library_ms": t_l, "bound_ms": bound, "bound_by": by})
        totals["ms"] += per_step * t_k
        totals["plain_ms"] += per_step * t_p
        totals["library_ms"] += per_step * t_l
        totals["bound_ms"] += per_step * bound
        nbytes = M * K + N * K // 2 + 8 * M + 4 * N * (2 if bias else 1) \
            + 2 * M * N
        t_bytes += per_step * nbytes / HBM_BYTES_PER_S
        t_ops += per_step * 2 * M * N * K / INT8_OPS_PER_S
        del sets, lib_sets
        torch.cuda.empty_cache()
    report["w4a8_per_shape"] = rows
    totals["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return totals


# --------------------------------------------------------------------------
# phase 2 + 4: kvq_decode_attn
# --------------------------------------------------------------------------

def kvq_inputs(torch, gen, cfg, lengths, dev):
    B, H, Hkv = SLOTS, cfg.n_heads, cfg.n_kv_heads
    S, D = CACHE_LEN, cfg.resolved_head_dim
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randint(-127, 128, (B, Hkv, S, D), generator=gen, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (B, Hkv, S, D), generator=gen, device=dev,
                      dtype=torch.int8)
    s_k = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.02 + 1e-3
    s_v = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.02 + 1e-3
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, s_k, s_v, lens


# ragged decode-time lengths inside cache_len (one full row, one fresh)
KVQ_LENGTHS = (CACHE_LEN, 1, 97, 160)


def check_kvq(torch, P, cfg, dev, report):
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    args = kvq_inputs(torch, gen, cfg, KVQ_LENGTHS, dev)
    got = P["kvq_ops"].kvq_decode_attn(*args).float()
    want = P["kvq_decode_attn_ref"](*args).float()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rtol, atol = KVQ_TOL
    check(bool(torch.isfinite(got).all()), "kvq_decode_attn: non-finite")
    check(torch.allclose(got, want, rtol=rtol, atol=atol),
          f"kvq_decode_attn differs from its plain version: max abs err "
          f"{err} (rtol {rtol}, atol {atol})")
    report["kvq_max_abs_err"] = err
    print(f"phase 2: kvq_decode_attn within rtol {rtol} atol {atol} of its "
          f"plain version (max abs err {err:.3g}, lengths {KVQ_LENGTHS})",
          flush=True)
    return err


def time_kvq(torch, P, cfg, dev, report):
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    base = kvq_inputs(torch, gen, cfg, KVQ_LENGTHS, dev)
    nb = tensor_bytes(*base)
    sets = [base] + [kvq_inputs(torch, gen, cfg, KVQ_LENGTHS, dev)
                     for _ in range(copies_for(nb) - 1)]
    kern = P["kvq_ops"].kvq_decode_attn
    t_k = time_ms(torch, kern, sets)
    t_host = host_issued_ms(torch, kern, sets)
    t_p = time_ms(torch, P["kvq_decode_attn_ref"], sets)
    import torch.nn.functional as F
    G = cfg.n_heads // cfg.n_kv_heads
    lib_sets = []
    for q, k, v, s_k, s_v, lens in sets:
        kd = (k.float() * s_k[..., None]).to(torch.bfloat16)
        vd = (v.float() * s_v[..., None]).to(torch.bfloat16)
        kd = kd.repeat_interleave(G, dim=1)
        vd = vd.repeat_interleave(G, dim=1)
        mask = (torch.arange(CACHE_LEN, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        lib_sets.append((q[:, :, None, :], kd, vd, mask))
    t_l = time_ms(torch, lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m), lib_sets)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    tokens = sum(KVQ_LENGTHS)
    nbytes = (2 * SLOTS * H * D            # q
              + tokens * Hkv * (2 * D + 8)  # int8 K/V rows + f32 scales
              + 4 * SLOTS + 2 * SLOTS * H * D)
    flops = 4 * tokens * H * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    per_step = cfg.n_layers
    report["kvq_per_launch"] = {"ms": t_k, "host_issued_ms": t_host,
                                "plain_ms": t_p, "library_ms": t_l,
                                "bound_ms": max(t_b, t_o) * 1e3,
                                "lengths": list(KVQ_LENGTHS)}
    return {"ms": per_step * t_k, "plain_ms": per_step * t_p,
            "library_ms": per_step * t_l,
            "bound_ms": per_step * max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


# --------------------------------------------------------------------------
# phase 2 + 4: the paged kernels (kvq_paged_decode_attn,
# gather_dequant_paged_kv, pool_block_copy)
# --------------------------------------------------------------------------

PAGED_TOKENS = 512             # the paged serve phase's per-slot extent
PAGED_BS = (64, 16)            # the engine's block size and the tests'
PAGED_LENGTHS = (512, 1, 97, 200)
GATHER_SHAPE = (4, 8, 64)      # n rows, T table entries, bs
COPY_LAYERS = 36


def paged_pool(torch, gen, cfg, nb, bs, dev):
    """Random int8 K/V pools and f32 scales of ``nb`` blocks plus the
    sink block."""
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    k = torch.randint(-127, 128, (nb + 1, Hkv, bs, D), generator=gen,
                      device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (nb + 1, Hkv, bs, D), generator=gen,
                      device=dev, dtype=torch.int8)
    s_k = torch.rand((nb + 1, Hkv, bs), generator=gen, device=dev) * 0.02 \
        + 1e-3
    s_v = torch.rand((nb + 1, Hkv, bs), generator=gen, device=dev) * 0.02 \
        + 1e-3
    return k, v, s_k, s_v


def shuffled_table(torch, gen, nb, rows, T, lengths, bs, dev):
    """Distinct non-contiguous blocks per row in a shuffled order, the
    sentinel ``nb`` past each row's extent (all of a length-0 row)."""
    perm = torch.randperm(nb, generator=gen, device=dev)[:rows * T]
    tbl = perm.reshape(rows, T).to(torch.int32)
    used = torch.tensor([-(-n // bs) for n in lengths], device=dev)
    col = torch.arange(T, device=dev)[None]
    return torch.where(col < used[:, None], tbl,
                       torch.full_like(tbl, nb)).contiguous()


def paged_inputs(torch, gen, cfg, bs, lengths, dev):
    B, T = len(lengths), PAGED_TOKENS // bs
    nb = B * T + 8                     # spare blocks the tables skip
    H, D = cfg.n_heads, cfg.resolved_head_dim
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v, s_k, s_v = paged_pool(torch, gen, cfg, nb, bs, dev)
    tbl = shuffled_table(torch, gen, nb, B, T, lengths, bs, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, s_k, s_v, tbl, lens


def check_paged_decode(torch, P, cfg, dev, report):
    """The paged decode kernel against its plain version at both block
    sizes, on ragged lengths and with one parked (all-sentinel, length 0)
    row in place of the one-token row."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    kern = P["kvq_ops"].kvq_paged_decode_attn
    ref = P["kvq_ref"].kvq_paged_decode_attn_ref
    rtol, atol = KVQ_TOL
    worst = 0.0
    for bs in PAGED_BS:
        for lengths in (PAGED_LENGTHS,
                        (PAGED_LENGTHS[0], 0) + PAGED_LENGTHS[2:]):
            args = paged_inputs(torch, gen, cfg, bs, lengths, dev)
            got = kern(*args).float()
            want = ref(*args).float()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"kvq_paged_decode_attn bs={bs}: non-finite output")
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=rtol, atol=atol),
                  f"kvq_paged_decode_attn bs={bs} lengths {lengths} differs "
                  f"from its plain version: max abs err {err} (rtol {rtol}, "
                  f"atol {atol})")
            if 0 in lengths:
                check(bool((got[1] == 0).all()),
                      "kvq_paged_decode_attn: a parked row is not zero")
            worst = max(worst, err)
    report["paged_decode_max_abs_err"] = worst
    print(f"phase 2: kvq_paged_decode_attn within rtol {rtol} atol {atol} "
          f"of its plain version at bs {PAGED_BS} (max abs err {worst:.3g}, "
          f"lengths {PAGED_LENGTHS}, and a parked row)", flush=True)
    return worst


def gather_inputs(torch, gen, cfg, dev):
    n, T, bs = GATHER_SHAPE
    nb = n * T + 8
    k, _, s_k, _ = paged_pool(torch, gen, cfg, nb, bs, dev)
    lengths = [T * bs, 3 * bs + 5, 1, 5 * bs]
    tbl = shuffled_table(torch, gen, nb, n, T, lengths, bs, dev)
    return k, s_k, tbl


def check_gather(torch, P, cfg, dev, report):
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    args = gather_inputs(torch, gen, cfg, dev)
    got = P["kvq_ops"].gather_dequant_paged_kv(*args)
    want = P["kvq_ref"].gather_dequant_paged_kv_ref(*args)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          "gather_dequant_paged_kv: dtype/shape")
    if not torch.equal(got, want):
        diff = (got - want).abs()
        raise SmokeFailure(
            f"gather_dequant_paged_kv differs from its plain version: "
            f"{int((diff > 0).sum())} elements, max {float(diff.max())}")
    report["gather_bitwise"] = True
    print(f"phase 2: gather_dequant_paged_kv bitwise equal to its plain "
          f"version (n, T, bs = {GATHER_SHAPE})", flush=True)
    return 0.0


def copy_leaves(torch, gen, cfg, nb, bs, dev):
    """A 36-layer stacked pool leaf of each dtype, sink block included."""
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    payload = torch.randint(-127, 128, (COPY_LAYERS, nb + 1, Hkv, bs, D),
                            generator=gen, device=dev, dtype=torch.int8)
    scales = torch.rand((COPY_LAYERS, nb + 1, Hkv, bs), generator=gen,
                        device=dev)
    return payload, scales


def check_copy(torch, P, cfg, dev, report):
    """Bitwise COW clone on both leaf dtypes: real pairs copied, padding
    pairs (dst >= NB) write nothing, every other block untouched."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    nb, bs = PAGED_TOKENS * SLOTS // 64, 64
    src = torch.tensor([3, 17, 0, 0], dtype=torch.int32, device=dev)
    dst = torch.tensor([20, 5, nb, nb], dtype=torch.int32, device=dev)
    kern = P["kvq_ops"].copy_pool_blocks
    ref = P["kvq_ref"].copy_pool_blocks_ref
    for leaf in copy_leaves(torch, gen, cfg, nb, bs, dev):
        got, want = leaf.clone(), leaf.clone()
        kern(got, src, dst)
        ref(want, src, dst)
        torch.cuda.synchronize()
        name = f"pool_block_copy ({leaf.dtype})"
        check(torch.equal(got[:, :nb], want[:, :nb]),
              f"{name} differs from its plain version")
        check(torch.equal(got[:, 20], leaf[:, 3])
              and torch.equal(got[:, 5], leaf[:, 17]),
              f"{name}: a destination block does not hold its source")
        keep = [b for b in range(nb) if b not in (20, 5)]
        check(torch.equal(got[:, keep], leaf[:, keep]),
              f"{name}: a block outside dst changed")
    report["copy_bitwise"] = True
    print(f"phase 2: pool_block_copy bitwise equal to its plain version on "
          f"{COPY_LAYERS}-layer int8 and f32 leaves, padding pairs dropped, "
          f"untouched blocks unchanged", flush=True)
    return 0.0


def time_paged_decode(torch, P, cfg, dev, report):
    """Per decode step (36 launches) at the paged serve phase's shapes:
    B = 4 slots, T = 8 table entries of 64 tokens."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    bs = PAGED_BS[0]
    base = paged_inputs(torch, gen, cfg, bs, PAGED_LENGTHS, dev)
    sets = [base] + [paged_inputs(torch, gen, cfg, bs, PAGED_LENGTHS, dev)
                     for _ in range(copies_for(tensor_bytes(*base)) - 1)]
    kern = P["kvq_ops"].kvq_paged_decode_attn
    t_k = time_ms(torch, kern, sets)
    t_host = host_issued_ms(torch, kern, sets)
    t_p = time_ms(torch, P["kvq_ref"].kvq_paged_decode_attn_ref, sets)
    import torch.nn.functional as F
    G = cfg.n_heads // cfg.n_kv_heads
    gather = P["kvq_ref"].gather_paged_kv
    lib_sets = []
    S = PAGED_TOKENS
    for q, k, v, s_k, s_v, tbl, lens in sets:
        kd = (gather(k, tbl).float() * gather(s_k, tbl)[..., None])
        vd = (gather(v, tbl).float() * gather(s_v, tbl)[..., None])
        kd = kd.to(torch.bfloat16).repeat_interleave(G, dim=1)
        vd = vd.to(torch.bfloat16).repeat_interleave(G, dim=1)
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        lib_sets.append((q[:, :, None, :], kd, vd, mask))
    t_l = time_ms(torch, lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m), lib_sets)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, T = len(PAGED_LENGTHS), PAGED_TOKENS // bs
    tokens = sum(PAGED_LENGTHS)
    nbytes = (2 * B * H * D                  # q
              + tokens * Hkv * (2 * D + 8)   # resident int8 K/V + scales
              + 4 * B * T + 4 * B            # table + lengths
              + 2 * B * H * D)               # out
    flops = 4 * tokens * H * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    per_step = cfg.n_layers
    report["paged_decode_per_launch"] = {
        "ms": t_k, "host_issued_ms": t_host, "plain_ms": t_p,
        "library_ms": t_l, "bound_ms": max(t_b, t_o) * 1e3,
        "lengths": list(PAGED_LENGTHS), "block_size": bs, "T": T}
    return {"ms": per_step * t_k, "plain_ms": per_step * t_p,
            "library_ms": per_step * t_l,
            "bound_ms": per_step * max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def time_gather(torch, P, cfg, dev, report):
    """Per tail-wave (2 launches per layer, 72) at the serve phase's
    largest wave: n = 4 rows, T = 8 entries of 64 tokens."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    base = gather_inputs(torch, gen, cfg, dev)
    n, T, bs = GATHER_SHAPE
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    out_bytes = 4 * n * Hkv * T * bs * D
    sets = [base] + [gather_inputs(torch, gen, cfg, dev) for _ in range(
        copies_for(tensor_bytes(*base) + out_bytes) - 1)]
    t_k = time_ms(torch, P["kvq_ops"].gather_dequant_paged_kv, sets)
    t_host = host_issued_ms(torch, P["kvq_ops"].gather_dequant_paged_kv,
                            sets)
    t_p = time_ms(torch, P["kvq_ref"].gather_dequant_paged_kv_ref, sets)
    nb = base[0].shape[0] - 1

    def library(pool, s, tbl):
        idx = tbl.long().clamp(0, nb - 1)
        return pool[idx].float() * s[idx][..., None]

    t_l = time_ms(torch, library, sets)
    rows = n * Hkv * T * bs
    nbytes = rows * (D + 4) + 4 * n * T + out_bytes
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = rows * D / F32_FLOPS_PER_S
    per_wave = 2 * cfg.n_layers
    report["gather_per_launch"] = {
        "ms": t_k, "host_issued_ms": t_host, "plain_ms": t_p,
        "library_ms": t_l, "bound_ms": max(t_b, t_o) * 1e3,
        "n_T_bs": list(GATHER_SHAPE)}
    return {"ms": per_wave * t_k, "plain_ms": per_wave * t_p,
            "library_ms": per_wave * t_l,
            "bound_ms": per_wave * max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def time_copy(torch, P, cfg, dev, report):
    """Per COW event: one pair, one launch on each of the four pool
    leaves (two int8 payloads, two f32 scale leaves) of the serve phase's
    36-layer pool."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    nb, bs = PAGED_TOKENS * SLOTS // 64, 64
    src = torch.tensor([3], dtype=torch.int32, device=dev)
    dst = torch.tensor([20], dtype=torch.int32, device=dev)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    nbytes = 0
    per_leaf = []
    for which in (0, 1):                    # int8 payload, f32 scales
        leaf = copy_leaves(torch, gen, cfg, nb, bs, dev)[which]
        n_copies = copies_for(tensor_bytes(leaf))
        leaves = [leaf] + [leaf.clone() for _ in range(n_copies - 1)]
        sets = [(x, src, dst) for x in leaves]

        def library(x, s, d):
            x[:, d.long()] = x[:, s.long()]

        t = (time_ms(torch, P["kvq_ops"].copy_pool_blocks, sets),
             time_ms(torch, P["kvq_ref"].copy_pool_blocks_ref, sets),
             time_ms(torch, library, sets))
        per_leaf.append({"dtype": str(leaf.dtype), "ms": t[0],
                         "plain_ms": t[1], "library_ms": t[2]})
        for key, v in zip(("ms", "plain_ms", "library_ms"), t):
            totals[key] += 2 * v            # k and v leaves of this dtype
        nbytes += 2 * 2 * leaf[:, 0].numel() * leaf.element_size()
        del leaves, sets, leaf
        torch.cuda.empty_cache()
    report["copy_per_launch"] = per_leaf
    totals["bound_ms"] = (nbytes + 4 * 8) / HBM_BYTES_PER_S * 1e3
    totals["bound_by"] = "bytes"
    return totals


# --------------------------------------------------------------------------
# phase 2 + 4: kvq_spec_verify_attn (the verify-wave's attention)
# --------------------------------------------------------------------------

SPEC_K = 4                     # the CLI's default draft length
SPEC_C = SPEC_K + 1            # window queries per slot
SPEC_T = 8                     # table entries per slot


def spec_histories(bs):
    """Committed history per slot before the window: a long row, a parked
    row (None: every length 0), a window straddling a block boundary and
    a mid-length row."""
    return (SPEC_T * bs - SPEC_C, None, bs - 2, 3 * bs + 8)


def spec_inputs(torch, gen, cfg, bs, dev):
    hist = spec_histories(bs)
    B, C = len(hist), SPEC_C
    nb = B * SPEC_T + 8
    H, D = cfg.n_heads, cfg.resolved_head_dim
    q = torch.randn((B, C, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v, s_k, s_v = paged_pool(torch, gen, cfg, nb, bs, dev)
    lens = [[0] * C if h is None else [h + 1 + c for c in range(C)]
            for h in hist]
    tbl = shuffled_table(torch, gen, nb, B, SPEC_T, [max(x) for x in lens],
                         bs, dev)
    return (q, k, v, s_k, s_v, tbl,
            torch.tensor(lens, dtype=torch.int32, device=dev))


def check_spec_verify(torch, P, cfg, dev, report):
    """The verify kernel against its plain version within one bf16 ulp at
    both block sizes, a parked row exactly zero, and each query bitwise
    equal to the paged decode kernel at its own length (the property
    exact-mode speculative decoding rests on)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    ops = P["kvq_ops"]
    ref = P["kvq_ref"].kvq_spec_verify_attn_ref
    rtol, atol = KVQ_TOL
    worst = 0.0
    for bs in PAGED_BS:
        q, k, v, s_k, s_v, tbl, lens = spec_inputs(torch, gen, cfg, bs, dev)
        got = ops.kvq_spec_verify_attn(q, k, v, s_k, s_v, tbl, lens)
        want = ref(q, k, v, s_k, s_v, tbl, lens)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()),
              f"kvq_spec_verify_attn bs={bs}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), rtol=rtol,
                             atol=atol),
              f"kvq_spec_verify_attn bs={bs} differs from its plain version:"
              f" max abs err {err} (rtol {rtol}, atol {atol})")
        check(bool((got[1] == 0).all()),
              "kvq_spec_verify_attn: a parked row is not zero")
        for c in range(SPEC_C):
            one = ops.kvq_paged_decode_attn(q[:, c].contiguous(), k, v, s_k,
                                            s_v, tbl,
                                            lens[:, c].contiguous())
            check(torch.equal(got[:, c], one),
                  f"kvq_spec_verify_attn bs={bs} query {c} is not bitwise "
                  f"equal to kvq_paged_decode_attn at its length")
        worst = max(worst, err)
    report["spec_verify_max_abs_err"] = worst
    report["spec_verify_bitwise_vs_paged_decode"] = True
    print(f"phase 2: kvq_spec_verify_attn within rtol {rtol} atol {atol} of "
          f"its plain version at bs {PAGED_BS} (max abs err {worst:.3g}; "
          f"B=4, C={SPEC_C}, T={SPEC_T}, a boundary-straddling window and a "
          f"parked row); every query bitwise equal to kvq_paged_decode_attn",
          flush=True)
    return worst


def check_norm_rows(torch, P, cfg, dev, report):
    """rms_norm gives each row the same bits in a batch of any row count
    (a verify-wave runs it at M = slots * C rows, decode at M = slots)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    w = {"w": torch.ones(cfg.d_model, device=dev, dtype=torch.bfloat16)}
    rows = SLOTS * SPEC_C
    diffs = mean_diffs = n_rows = 0

    def mean_sq(x):                 # one torch.mean, the CPU path's form
        xf = x.float()
        return torch.mean(xf * xf, dim=-1, keepdim=True)

    for _ in range(8):
        x = torch.randn((rows, cfg.d_model), generator=gen, device=dev).to(
            torch.bfloat16) * 3
        full = P["rms_norm"](x, w, cfg.norm_eps)
        full_var = mean_sq(x)
        for m in (1, SLOTS, 2 * SLOTS):
            diffs += int((P["rms_norm"](x[:m].contiguous(), w, cfg.norm_eps)
                          != full[:m]).sum())
            mean_diffs += int((mean_sq(x[:m].contiguous())
                               != full_var[:m]).sum())
            n_rows += m
        x3 = x.reshape(SLOTS, SPEC_C, cfg.d_model)
        diffs += int((P["rms_norm"](x3[:, :1].contiguous(), w, cfg.norm_eps)
                      != P["rms_norm"](x3, w, cfg.norm_eps)[:, :1]).sum())
    report["rms_norm_row_count_diffs"] = diffs
    # what the two-stage sum replaced: torch.mean's variance, per row
    report["torch_mean_row_count_var_diffs"] = mean_diffs
    check(diffs == 0, f"rms_norm differs across row counts: {diffs} "
                      f"elements")
    print(f"phase 2: rms_norm bitwise equal across row counts 1..{rows} "
          f"(one torch.mean's variance differed in {mean_diffs} of "
          f"{n_rows} rows)",
          flush=True)


def time_spec_verify(torch, P, cfg, dev, report):
    """Per verify-wave (36 launches) at bs = 64: B = 4 slots, C = 5, T = 8,
    the histories of ``spec_histories``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    bs = PAGED_BS[0]
    base = spec_inputs(torch, gen, cfg, bs, dev)
    sets = [base] + [spec_inputs(torch, gen, cfg, bs, dev)
                     for _ in range(copies_for(tensor_bytes(*base)) - 1)]
    kern = P["kvq_ops"].kvq_spec_verify_attn
    t_k = time_ms(torch, kern, sets)
    t_host = host_issued_ms(torch, kern, sets)
    t_p = time_ms(torch, P["kvq_ref"].kvq_spec_verify_attn_ref, sets)
    import torch.nn.functional as F
    G = cfg.n_heads // cfg.n_kv_heads
    gather = P["kvq_ref"].gather_paged_kv
    S = SPEC_T * bs
    lib_sets = []
    for q, k, v, s_k, s_v, tbl, lens in sets:
        kd = (gather(k, tbl).float() * gather(s_k, tbl)[..., None])
        vd = (gather(v, tbl).float() * gather(s_v, tbl)[..., None])
        kd = kd.to(torch.bfloat16).repeat_interleave(G, dim=1)
        vd = vd.to(torch.bfloat16).repeat_interleave(G, dim=1)
        mask = (torch.arange(S, device=dev)[None, None, :]
                < lens[:, :, None])[:, None]                 # (B, 1, C, S)
        lib_sets.append((q.transpose(1, 2), kd, vd, mask))
    t_l = time_ms(torch, lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m), lib_sets)
    q, _, _, _, _, _, lens = base
    B, C, H, D = q.shape
    Hkv = cfg.n_kv_heads
    resident = int(lens.max(dim=1).values.sum())    # each block read once
    nbytes = (2 * B * C * H * D                     # q
              + resident * Hkv * (2 * D + 8)        # int8 K/V + f32 scales
              + 4 * B * SPEC_T + 4 * B * C          # table + lengths
              + 2 * B * C * H * D)                  # out
    flops = 4 * int(lens.sum()) * H * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    per_wave = cfg.n_layers
    report["spec_verify_per_launch"] = {
        "ms": t_k, "host_issued_ms": t_host, "plain_ms": t_p,
        "library_ms": t_l, "bound_ms": max(t_b, t_o) * 1e3,
        "byte_bound_ms": t_b * 1e3, "operation_bound_ms": t_o * 1e3,
        "lengths": lens.tolist(), "block_size": bs, "T": SPEC_T}
    print(f"phase 4: kvq_spec_verify_attn per launch: {t_k * 1e3:.2f} us "
          f"(byte bound {t_b * 1e6:.3f} us, operation bound "
          f"{t_o * 1e6:.3f} us), plain {t_p * 1e3:.1f} us, SDPA "
          f"{t_l * 1e3:.2f} us", flush=True)
    return {"ms": per_wave * t_k, "plain_ms": per_wave * t_p,
            "library_ms": per_wave * t_l,
            "bound_ms": per_wave * max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


# --------------------------------------------------------------------------
# phase 2 + 4: fake_quant_fwd / fake_quant_bwd (the QAT path's LSQ sites)
# --------------------------------------------------------------------------

BF16_PEAK_FLOPS = 989e12       # dense bf16 tensor-core peak
TRAIN_B, TRAIN_T = 8, 128      # the QAT phase's batch and sequence
TRAIN_STEPS = 4
FLASH_TOL = (2.0 ** -7, 2.0 ** -7)   # rtol, atol (see check_flash)
FLASH_ULP_SHARE = 5e-2         # of elements allowed beyond one ulp
FLASH_ORACLE_RATIO = 1.5       # kernel's f64-oracle error / plain's
FQ_DS_TOL = 1e-4               # of gscale * sum |g * dq/ds| per scale
GRAD_REL_TOL = 1e-3            # per-leaf relative L2, fake-quant kernels
GRAD_REL_TOL_STEP = 1e-1       # the same, whole step (see grads_vs_plain)


def fq_shapes(cfg):
    """(site, R, C, mode, bits, launches per student step): every weight
    of A8d-C8-W4 (mode 1: per output channel; the tied head in mode 2, per
    vocab row of embed.w, at head_bits 8) and, per tensor (mode 0), the
    activation sites a static policy adds at B * T = 1024 tokens: s_in on
    the linears' inputs, and s_q / s_k / s_v on the (B, T, heads, D)
    attention operands, which the kernel reads as (B * T * heads, D)."""
    d, f, qd, kvd, L = (cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim,
                        cfg.n_layers)
    tok = TRAIN_B * TRAIN_T
    return [("wq", d, qd, 1, 4, L), ("wk", d, kvd, 1, 4, L),
            ("wv", d, kvd, 1, 4, L), ("wo", qd, d, 1, 4, L),
            ("wg", d, f, 1, 4, L), ("wu", d, f, 1, 4, L),
            ("wd", f, d, 1, 4, L), ("head", cfg.vocab_size, d, 2, 8, 1),
            ("act_d", tok, d, 0, 8, 0), ("act_ff", tok, f, 0, 8, 0),
            ("act_q", tok * cfg.n_heads, cfg.resolved_head_dim, 0, 8, 0),
            ("act_kv", tok * cfg.n_kv_heads, cfg.resolved_head_dim, 0, 8, 0)]


def fq_inputs(torch, gen, R, C, mode, bits, dev):
    """x bf16 (weights ~0.02, activations ~1), s near absmax / qp so some
    values clip, g bf16 for the backward."""
    qp = 2 ** (bits - 1) - 1
    x = torch.randn((R, C), generator=gen, device=dev) * (
        1.0 if mode == 0 else 0.02)
    if mode == 0:
        s = x.abs().amax() / qp * 0.8
    elif mode == 1:
        s = x.abs().amax(0, keepdim=True) / qp * (
            0.5 + 0.5 * torch.rand((1, C), generator=gen, device=dev))
    else:
        s = x.abs().amax(1, keepdim=True) / qp * (
            0.5 + 0.5 * torch.rand((R, 1), generator=gen, device=dev))
    g = torch.randn((R, C), generator=gen, device=dev) * 1e-3
    return (x.to(torch.bfloat16), s.float().contiguous(),
            g.to(torch.bfloat16))


def fq_ds_mass(torch, P, x, s, g, bits):
    """gscale * sum |g * dq/ds| per scale: the scale of the f32 sums'
    order error."""
    qn, qp = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    v = x.float() / torch.clamp_min(s, 1e-9)
    dq = torch.where((v >= qn) & (v <= qp), torch.round(v) - v,
                     torch.clamp(v, qn, qp))
    mass = (g.float() * dq).abs()
    del v, dq
    dims = {0: None, 1: (0,), 2: (1,)}[P["fq_ops"].scale_mode(x, s)]
    mass = mass.sum() if dims is None else mass.sum(dim=dims, keepdim=True)
    return mass.reshape(s.shape) * P["fq_ops"].grad_scale(x, s, bits)


def check_fake_quant(torch, P, cfg, dev, report):
    ops, ref = P["fq_ops"], P["fq_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    worst_ds, n = 0.0, 0
    for site, R, C, mode, _, _ in fq_shapes(cfg):
        for bits in (4, 8):
            x, s, g = fq_inputs(torch, gen, R, C, mode, bits, dev)
            got = ops.fake_quant_fwd(x, s, bits)
            want = ref.fake_quant_fwd_ref(x, s, bits)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"fake_quant_fwd {site} bits {bits} differs from its plain "
                  f"version in {int((got != want).sum())} elements")
            del got, want
            dx, ds = ops.fake_quant_bwd(x, s, g, bits)
            dx_p, ds_p = ops.fake_quant_bwd(x, s, g, bits, plain=True)
            torch.cuda.synchronize()
            check(torch.equal(dx, dx_p),
                  f"fake_quant_bwd {site} bits {bits}: dx differs from its "
                  f"plain version in {int((dx != dx_p).sum())} elements")
            mass = fq_ds_mass(torch, P, x, s, g, bits)
            rel = float(((ds - ds_p).abs() / mass.clamp_min(1e-30)).max())
            check(bool(torch.isfinite(ds).all()) and rel <= FQ_DS_TOL,
                  f"fake_quant_bwd {site} bits {bits}: ds off its plain "
                  f"version by {rel} of its sums' mass (> {FQ_DS_TOL})")
            worst_ds = max(worst_ds, rel)
            n += 1
            del x, s, g, dx, ds, dx_p, ds_p, mass
    torch.cuda.empty_cache()
    report["fake_quant_checked"] = n
    report["fake_quant_ds_rel_mass_err"] = worst_ds
    print(f"phase 2: fake_quant_fwd and dx of fake_quant_bwd bitwise equal "
          f"to their plain versions on {n} cases (every weight shape of "
          f"qwen2.5-3b per channel, the tied head per row, two linear-input "
          f"and two attention shapes per tensor; bits 4 and 8); ds within {worst_ds:.3g} of "
          f"its sums' mass (tolerance {FQ_DS_TOL})", flush=True)
    return 0.0


def time_fake_quant(torch, P, cfg, dev, report):
    """Per student step: the forward and the backward of every weight site
    (253 launches each), summed over the shapes' per-step counts."""
    ops, ref = P["fq_ops"], P["fq_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    fwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    bwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    fwd_bytes = bwd_bytes = fwd_ops = bwd_ops = 0
    rows = []
    for site, R, C, mode, bits, per_step in fq_shapes(cfg):
        if not per_step:
            continue
        nb = R * C * 2
        sets = [fq_inputs(torch, gen, R, C, mode, bits, dev)
                for _ in range(copies_for(nb))]
        qn, qp = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        axis = 1 if mode == 1 else 0
        row = {"site": site, "R": R, "C": C, "mode": mode, "bits": bits,
               "per_step": per_step}
        row["fwd_ms"] = time_ms(torch, lambda x, s, g: ops.fake_quant_fwd(
            x, s, bits), sets)
        row["fwd_plain_ms"] = time_ms(
            torch, lambda x, s, g: ref.fake_quant_fwd_ref(x, s, bits),
            sets[:1], min_calls=5)
        row["bwd_ms"] = time_ms(torch, lambda x, s, g: ops.fake_quant_bwd(
            x, s, g, bits), sets)
        row["bwd_plain_ms"] = time_ms(
            torch, lambda x, s, g: ops.fake_quant_bwd(x, s, g, bits,
                                                      plain=True),
            sets[:1], min_calls=5)
        n_s = sets[0][1].numel()
        zp = torch.zeros(n_s, dtype=torch.int32, device=dev)
        lib = [(x, s.reshape(-1), g) for x, s, g in sets]
        # the library op checks its zero points on the host, which a
        # CUDA graph capture refuses: timed as eager calls
        row["fwd_library_ms"] = time_eager_ms(
            torch, lambda x, s, g: torch.fake_quantize_per_channel_affine(
                x, s, zp, axis, qn, qp), lib)
        zpf = torch.zeros(n_s, dtype=torch.float32, device=dev)

        def lib_bwd(x, s, g):
            xr = x.detach().requires_grad_(True)
            sr = s.detach().requires_grad_(True)
            y = torch._fake_quantize_learnable_per_channel_affine(
                xr, sr, zpf, axis, qn, qp, 1.0)
            return torch.autograd.grad(y, (xr, sr), g)

        row["bwd_library_ms"] = time_eager_ms(torch, lib_bwd, lib)
        rows.append(row)
        for d_, k in ((fwd, "fwd"), (bwd, "bwd")):
            d_["ms"] += per_step * row[f"{k}_ms"]
            d_["plain_ms"] += per_step * row[f"{k}_plain_ms"]
            d_["library_ms"] += per_step * row[f"{k}_library_ms"]
        n_el = R * C
        fwd_bytes += per_step * (4 * n_el + 4 * n_s)
        bwd_bytes += per_step * (6 * n_el + 8 * n_s)
        fwd_ops += per_step * 4 * n_el          # divide, clip, round, scale
        bwd_ops += per_step * 8 * n_el
        del sets, lib
        torch.cuda.empty_cache()
    report["fake_quant_per_shape"] = rows
    out = []
    for d_, nbytes, nops in ((fwd, fwd_bytes, fwd_ops),
                             (bwd, bwd_bytes, bwd_ops)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS_PER_S
        d_["bound_ms"] = max(t_b, t_o) * 1e3
        d_["bound_by"] = "bytes" if t_b >= t_o else "operations"
        out.append(d_)
    return out


def time_eager_ms(torch, fn, arg_sets, min_calls=10):
    """Device ms per call issued eagerly between two events (for a call
    that runs autograd, which a CUDA graph capture would not take)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    n = max(min_calls, len(arg_sets))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


# --------------------------------------------------------------------------
# phase 2 + 4: flash_attn_fwd (attention without a gradient)
# --------------------------------------------------------------------------

# (B, S, window): the QAT phase's shape, TrainConfig's default seq_len, a
# ragged length and a sliding window
FLASH_CASES = ((TRAIN_B, TRAIN_T, 0), (2, 1024, 0), (3, 333, 0),
               (2, 200, 64))


def flash_inputs(torch, gen, cfg, B, S, dev):
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return tuple(torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((B, S, H, D), (B, S, Hkv, D),
                                      (B, S, Hkv, D)))


def check_flash(torch, P, cfg, dev, report):
    """The kernel against its plain version, and both against an f64
    softmax attention with unrounded probabilities (the oracle).

    P is rounded to bf16 before P.V, as in the reference. Scores summed in
    another order than cuBLAS's put some probabilities on the neighbouring
    bf16 value (one in a few thousand), and for a query with few keys
    (early causal rows) one such flip moves the output by up to about
    2^-8 of the spread of its V rows, whatever the output's own size
    (1.05% of the elements beyond one ulp, max 0.0039, read at S 128 on
    the card). So the kernel is held to ``FLASH_TOL`` (rtol one bf16 ulp,
    atol 2^-7 for V rows of unit scale) and ``FLASH_ULP_SHARE`` beyond
    one ulp, and its error against the oracle to at most
    ``FLASH_ORACLE_RATIO`` times the plain version's."""
    fa, ref = P["fa_ops"].flash_attn_fwd, P["flash_attn_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    rtol, atol = FLASH_TOL
    worst, cases = 0.0, []
    for B, S, window in FLASH_CASES:
        q, k, v = flash_inputs(torch, gen, cfg, B, S, dev)
        got = fa(q, k, v, causal=True, window=window).float()
        want = ref(q, k, v, causal=True, window=window).float()
        oracle = flash_oracle(torch, q, k, v, window)
        torch.cuda.synchronize()
        err = (got - want).abs()
        beyond_ulp = float((err > KVQ_TOL[1] + KVQ_TOL[0] * want.abs())
                           .float().mean())
        e_k = float((got - oracle).abs().max())
        e_p = float((want - oracle).abs().max())
        cases.append({"B": B, "S": S, "window": window,
                      "max_abs_err": float(err.max()),
                      "share_beyond_one_ulp": beyond_ulp,
                      "kernel_vs_oracle": e_k, "plain_vs_oracle": e_p})
        check(bool(torch.isfinite(got).all()),
              f"flash_attn_fwd B={B} S={S}: non-finite")
        check(torch.allclose(got, want, rtol=rtol, atol=atol)
              and beyond_ulp <= FLASH_ULP_SHARE
              and e_k <= FLASH_ORACLE_RATIO * e_p,
              f"flash_attn_fwd B={B} S={S} window={window} differs from its "
              f"plain version: {cases[-1]} (rtol {rtol}, atol {atol}, at "
              f"most {FLASH_ULP_SHARE} beyond one ulp, oracle error at most "
              f"{FLASH_ORACLE_RATIO}x the plain version's)")
        worst = max(worst, float(err.max()))
        del q, k, v, got, want, oracle, err
    report["flash_check"] = cases
    print(f"phase 2: flash_attn_fwd within rtol {rtol} atol {atol} of its "
          f"plain version at H=16, Hkv=2, D=128: {cases}", flush=True)
    return worst


def flash_oracle(torch, q, k, v, window):
    """Causal softmax attention in f64 with unrounded probabilities."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    kr = k.double().repeat_interleave(g, dim=2)
    vr = v.double().repeat_interleave(g, dim=2)
    s_ = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr) * D ** -0.5
    i = torch.arange(S, device=q.device)
    mask = i[:, None] >= i[None, :]
    if window:
        mask &= i[:, None] - i[None, :] < window
    s_ = s_.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, -1), vr).float()


def time_flash(torch, P, cfg, dev, report):
    """Per teacher forward: 36 launches at the QAT phase's shape."""
    import torch.nn.functional as F
    fa, ref = P["fa_ops"].flash_attn_fwd, P["flash_attn_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    B, S = TRAIN_B, TRAIN_T
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    base = flash_inputs(torch, gen, cfg, B, S, dev)
    nb = tensor_bytes(*base)
    sets = [base] + [flash_inputs(torch, gen, cfg, B, S, dev)
                     for _ in range(copies_for(nb) - 1)]
    t_k = time_ms(torch, fa, sets)
    t_p = time_ms(torch, ref, sets[:4], min_calls=10)
    lib = [tuple(t.transpose(1, 2) for t in s) for s in sets]
    t_l = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), lib)
    pairs = S * (S + 1) // 2                    # causal (query, key) pairs
    flops = 4 * B * H * D * pairs               # QK^T and P.V
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D)   # q, o, k, v
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    L = cfg.n_layers
    report["flash_per_launch"] = {"ms": t_k, "plain_ms": t_p,
                                  "library_ms": t_l,
                                  "bound_ms": max(t_b, t_o) * 1e3,
                                  "flops": flops, "bytes": nbytes}
    return {"ms": L * t_k, "plain_ms": L * t_p, "library_ms": L * t_l,
            "bound_ms": L * max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


# --------------------------------------------------------------------------
# phase 5: QAT at full width; 5b: a static policy
# --------------------------------------------------------------------------

def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def train_counters(P):
    return (P["fq_ops"].fake_quant_fwd, P["fq_ops"].fake_quant_bwd,
            P["fa_ops"].flash_attn_fwd)


def train_flops(cfg, B, T):
    """Model FLOPs of one QAT step: the teacher's forward (2 N per token)
    and the student's forward and backward (6 N), N the matmul weights
    (the tied head counted once), plus attention's QK^T and P.V over
    all (query, key) pairs, three times for the student."""
    d, f, qd, kvd, L = (cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim,
                        cfg.n_layers)
    n_mm = L * (2 * d * qd + 2 * d * kvd + 3 * d * f) + d * cfg.vocab_size
    attn = L * 4 * B * T * T * qd
    return 8 * n_mm * B * T + 4 * attn


def train_full(torch, P, cfg, dev, report):
    """run_qat on qwen2.5-3b at full width and depth, A8d-C8-W4."""
    tcfg = P["TrainConfig"](precision="A8d-C8-W4", total_steps=TRAIN_STEPS,
                            ref_steps=TRAIN_STEPS, batch_size=TRAIN_B,
                            seq_len=TRAIN_T)
    fq_fwd, fq_bwd, fa = train_counters(P)
    steps, state = [], {}

    def on_start(student, opt):
        state["s_w0"] = {k: t.detach().clone() for k, t in
                         _named_leaves(student) if k.endswith("s_w")}
        state["counts"] = (fq_fwd.launches, fq_bwd.launches, fa.launches)

    def on_step(step, metrics, student, opt):
        counts = (fq_fwd.launches, fq_bwd.launches, fa.launches)
        steps.append({"step": step, "loss": float(metrics["loss"]),
                      "ms": metrics["ms"],
                      "launches": [a - b for a, b in
                                   zip(counts, state["counts"])]})
        state["counts"] = counts
        state["opt"] = opt

    for fn in train_counters(P):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    teacher, student, _ = P["train"].run_qat(
        "qwen2.5-3b", tcfg, reduced=False, teacher_steps=2, device=dev,
        log_every=1, split_times=True, on_start=on_start, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fake_quant_fwd": fq_fwd.launches,
                "fake_quant_bwd": fq_bwd.launches,
                "flash_attn_fwd": fa.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    n_w = 7 * cfg.n_layers + 1
    for s in steps:
        check(s["launches"] == [n_w, n_w, cfg.n_layers],
              f"QAT step {s['step']}: launches (fake_quant_fwd, "
              f"fake_quant_bwd, flash_attn_fwd) = {s['launches']}, want "
              f"({n_w}, {n_w}, {cfg.n_layers})")
        check(math.isfinite(s["loss"]), f"QAT step {s['step']}: KD loss "
                                        f"{s['loss']}")
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} QAT steps ran")
    opt = state.pop("opt")
    named = dict(_named_leaves(student))
    unmoved = [k for k, t0_ in state["s_w0"].items()
               if torch.equal(named[k], t0_)]
    check(len(state["s_w0"]) == n_w and not unmoved,
          f"s_w that did not move: {unmoved[:5]} ({len(unmoved)})")
    zero_m = sorted({k.split("/")[-1] for k, m in _named_leaves(opt.m)
                     if not bool(m.any())})
    check(zero_m == ["s_in", "s_k", "s_q", "s_v"],
          f"AdamW first moments all zero on {zero_m}: under A8d exactly the "
          f"unread activation scales may be")
    check(all(bool(v.any()) for k, v in _named_leaves(opt.v)
              if k.split("/")[-1] not in zero_m),
          "a read leaf has all-zero second moments")
    check(all(bool(torch.isfinite(t).all()) for t in named.values()),
          "a parameter is not finite after QAT")
    check(int(opt.step) == TRAIN_STEPS, f"AdamW step {int(opt.step)}")

    # the device's idle share over one more step, under the profiler
    idle = profile_train_step(torch, P, cfg, tcfg, teacher, student, opt,
                              steps, dev, report)
    del opt, state
    torch.cuda.empty_cache()

    per = {k: sum(s["ms"][k] for s in steps[1:]) / (len(steps) - 1)
           for k in ("teacher", "student", "optimizer")}
    step_ms = sum(per.values())
    flops = train_flops(cfg, TRAIN_B, TRAIN_T)
    trained = {"steps": TRAIN_STEPS, "batch": TRAIN_B, "seq": TRAIN_T,
               "losses": [s["loss"] for s in steps],
               "ms_per_step": step_ms, "ms_split": per,
               "ms_first_step": sum(steps[0]["ms"].values()),
               "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
               "peak_memory_bytes": peak, "wall_s": wall,
               "device_idle_share": idle,
               "model_flops_per_step": flops,
               "model_flops_share": flops / (step_ms / 1e3) / BF16_PEAK_FLOPS,
               "launches": launches}
    report["train"] = trained
    print("phase 5: " + json.dumps(trained), flush=True)
    grads_vs_plain(torch, P, cfg, tcfg, teacher, student, dev, report)
    return launches


def profile_train_step(torch, P, cfg, tcfg, teacher, student, opt, steps,
                       dev, report):
    from torch.profiler import ProfilerActivity, profile
    step_fn = P["steps"].make_train_step(cfg, tcfg)
    it = P["MixtureIterator"](P["SyntheticConfig"](
        vocab_size=cfg.vocab_size, seq_len=TRAIN_T, batch_size=TRAIN_B),
        start_step=1 + TRAIN_STEPS)
    batch = P["to_device"](next(it), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(student, teacher, opt, batch, TRAIN_STEPS - 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        report["train_profile"] = "not measured: no device records"
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    report["train_profile"] = {
        "step_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "kernels": len(kernels),
        "top_kernels_us": [(n[:90], us) for n, us in top]}
    return max(0.0, 1.0 - busy_ms / wall_ms)


def _grad_gaps(torch, ga, gb):
    """Per-leaf relative L2 gaps of two gradient trees: (worst, its leaf,
    leaves compared, leaves bitwise equal)."""
    worst, worst_key, n, same = 0.0, "", 0, 0
    for (k, a), (_, b) in zip(_named_leaves(ga), _named_leaves(gb)):
        if a is None or b is None:
            check(a is None and b is None, f"gradient {k} only on one side")
            continue
        rel = float(torch.linalg.vector_norm(a.float() - b.float())
                    / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))
        n += 1
        same += int(torch.equal(a, b))
        if rel > worst:
            worst, worst_key = rel, k
    return worst, worst_key, n, same


def grads_vs_plain(torch, P, cfg, tcfg, teacher, student, dev, report):
    """One loss and backward on one batch and the same parameters, through
    the kernels and through their plain versions (launches not counted).

    Twice: the whole step (teacher forward through ``flash_attn_fwd`` or
    its plain version), and the student alone against one set of teacher
    logits, which isolates the fake-quant kernels. The teacher's logits
    are bf16: a one-ulp move of a logit near 16 (0.125) moves its
    probability by 13%, and the flash kernel moves some logits so (check
    on the teacher logits below), so the whole step's gradients are held
    to ``GRAD_REL_TOL_STEP``; with the teacher's logits shared, the
    forward is bitwise and the backward differs only in the order of the
    LSQ step-size sums: ``GRAD_REL_TOL``."""
    qat, models = P["qat"], P["models"]
    it = P["MixtureIterator"](P["SyntheticConfig"](
        vocab_size=cfg.vocab_size, seq_len=TRAIN_T, batch_size=TRAIN_B),
        start_step=1)
    batch = P["to_device"](next(it), dev)
    counts = [fn.launches for fn in train_counters(P)]
    lk, gk = P["steps"].make_train_step(cfg, tcfg).loss_and_grads(
        student, teacher, batch)
    lp, gp = P["steps"].make_train_step(
        cfg, tcfg, kernel_backend="ref").loss_and_grads(student, teacher,
                                                        batch)
    step_gap = _grad_gaps(torch, gk, gp)
    del gk, gp
    with torch.no_grad():
        t_k = models.forward(cfg, teacher, qat.make_ctx(
            "A16-C16-W16", mode="off"), batch)[0]
        t_p = models.forward(cfg, teacher, qat.make_ctx(
            "A16-C16-W16", mode="off", kernel_backend="ref"), batch)[0]
        t_rel = float(torch.linalg.vector_norm((t_k - t_p).float())
                      / torch.linalg.vector_norm(t_p.float()))
        t_flips = float((t_k != t_p).float().mean())
    del t_p
    student_only = {}
    for backend in ("auto", "ref"):
        ctx = qat.make_ctx(tcfg.precision, kernel_backend=backend)
        logits, _ = models.forward(cfg, student, ctx, batch)
        loss = P["silq_loss"](logits, t_k, batch["labels"],
                              mask=batch["loss_mask"])
        del logits
        student_only[backend] = (loss.detach(),
                                 P["steps"].grads_of(loss, student))
        del loss
    (ls_k, gs_k), (ls_p, gs_p) = student_only["auto"], student_only["ref"]
    fq_gap = _grad_gaps(torch, gs_k, gs_p)
    del student_only, gs_k, gs_p, t_k
    for fn, c in zip(train_counters(P), counts):
        fn.launches = c
    torch.cuda.empty_cache()
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    out = {"loss_kernels": float(lk), "loss_plain": float(lp),
           "loss_rel_err": loss_rel, "teacher_logits_rel_l2": t_rel,
           "teacher_logits_share_differing": t_flips,
           "step_grad_max_rel_l2": step_gap[0],
           "step_grad_worst_leaf": step_gap[1], "grad_leaves": step_gap[2],
           "student_only_loss_equal": bool(float(ls_k) == float(ls_p)),
           "student_only_grad_max_rel_l2": fq_gap[0],
           "student_only_grad_worst_leaf": fq_gap[1],
           "student_only_grad_leaves_bitwise": fq_gap[3]}
    report["train_vs_plain"] = out
    check(loss_rel <= 1e-3, f"KD loss through the kernels {float(lk)} vs "
                            f"plain {float(lp)}: relative {loss_rel}")
    check(step_gap[0] <= GRAD_REL_TOL_STEP,
          f"gradient {step_gap[1]} of the whole step through the kernels "
          f"off the plain versions' by relative L2 {step_gap[0]} > "
          f"{GRAD_REL_TOL_STEP}")
    check(float(ls_k) == float(ls_p),
          f"student loss through the fake-quant kernels {float(ls_k)} vs "
          f"plain {float(ls_p)} on the same teacher logits")
    check(fq_gap[0] <= GRAD_REL_TOL,
          f"gradient {fq_gap[1]} through the fake-quant kernels off the "
          f"plain versions' by relative L2 {fq_gap[0]} > {GRAD_REL_TOL}")
    print("phase 5: one loss and backward, kernels vs plain versions: "
          + json.dumps(out), flush=True)


def train_static(torch, P, cfg, dev, report):
    """A8s-C8-W4 at full width, 4 layers: percentile calibration over 5
    batches (the calibration forward runs flash_attn_fwd), then one step."""
    L = 4
    tcfg = P["TrainConfig"](precision="A8s-C8-W4", total_steps=1,
                            ref_steps=1, batch_size=TRAIN_B, seq_len=TRAIN_T)
    fq_fwd, fq_bwd, fa = train_counters(P)
    seen = {}

    def on_start(student, opt):
        seen["calib"] = [fn.launches for fn in train_counters(P)]
        s_in = student["layers"][0]["attn"]["wq"]["s_in"]
        seen["s_in"] = float(s_in.detach())

    def on_step(step, metrics, student, opt):
        seen["loss"] = float(metrics["loss"])

    for fn in train_counters(P):
        fn.launches = 0
    P["train"].run_qat("qwen2.5-3b", tcfg, reduced=False, teacher_steps=1,
                       device=dev, n_layers=L, log_every=1,
                       on_start=on_start, on_step=on_step)
    torch.cuda.synchronize()
    calib = seen["calib"]
    step = [fn.launches - c for fn, c in zip(train_counters(P), calib)]
    n_w = 7 * L + 1
    per_tensor = step[0] - n_w
    out = {"layers": L, "calib_launches": calib, "step_launches": step,
           "per_tensor_fwd_launches": per_tensor, "loss": seen["loss"],
           "calibrated_s_in": seen["s_in"]}
    report["train_static"] = out
    check(calib[2] == 5 * L, f"calibration launched flash_attn_fwd "
                             f"{calib[2]} times, want {5 * L}")
    check(per_tensor == 10 * L + 1 and step[1] == step[0],
          f"A8s step launches {step}: want {n_w} weight + {10 * L + 1} "
          f"per-tensor forward and as many backward launches")
    check(math.isfinite(seen["loss"]) and seen["s_in"] != 1.0,
          f"A8s: loss {seen['loss']}, calibrated s_in {seen['s_in']}")
    print("phase 5b: " + json.dumps(out), flush=True)


# --------------------------------------------------------------------------
# phase 3: serve
# --------------------------------------------------------------------------

def serve(torch, P, cfg, dev, report):
    import numpy as np
    qat, models = P["qat"], P["models"]
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device=dev)
    eng = P["ServeEngine"](cfg, params, policy="A8d-C8-W4", slots=SLOTS,
                           cache_len=CACHE_LEN, max_new_cap=MAX_NEW,
                           decode_block=8, weights_layout="w4a8", device=dev)
    del params
    # the w4a8 forward never reads the bf16 linear weights
    eng.params = qat.drop_exported_weights(eng.params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    report["setup_s"] = time.perf_counter() - t0
    report["weights_bytes_after_drop"] = sum(
        t.numel() * t.element_size() for t in _leaves(eng.params))

    rng = np.random.default_rng(0)
    lens = rng.integers(32, 129, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]

    # one decode step: kernels vs the same engine on the plain versions,
    # from the same post-prefill cache (launches here are not counted)
    L = int(math.ceil(max(lens[:SLOTS]) / 16) * 16)
    toks = torch.zeros((SLOTS, L), dtype=torch.int32, device=dev)
    for i in range(SLOTS):
        toks[i, :lens[i]] = torch.from_numpy(prompts[i]).to(dev)
    batch = {"tokens": toks, "lengths": torch.tensor(
        lens[:SLOTS], dtype=torch.int32, device=dev)}
    logits0, cache = models.prefill(cfg, eng.params, eng.ctx, batch,
                                    cache_budget=CACHE_LEN)
    tok1 = torch.argmax(logits0[:, -1].float(), -1).to(torch.int32)[:, None]
    lk, _ = models.decode_step(cfg, eng.params, eng.ctx, tok1,
                               models.clone_cache(cache))
    plain_ctx = replace(eng.ctx, kernel_backend="ref")
    lp, _ = models.decode_step(cfg, eng.params, plain_ctx, tok1,
                               models.clone_cache(cache))
    lk, lp = lk.float(), lp.float()
    check(bool(torch.isfinite(lk).all()), "decode logits not finite")
    rel = float(torch.linalg.vector_norm(lk - lp)
                / torch.linalg.vector_norm(lp))
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    report["decode_logits"] = {"rel_l2_err": rel,
                               "max_abs_err": float((lk - lp).abs().max()),
                               "argmax_agreement": agree,
                               "logit_absmax": float(lp.abs().max())}
    check(rel <= LOGIT_REL_TOL,
          f"kernel decode logits differ from the plain versions' by "
          f"relative L2 {rel} > {LOGIT_REL_TOL}")
    print(f"phase 3: one decode step's logits, kernels vs plain versions: "
          f"relative L2 {rel:.3g}, argmax agreement {agree:.2f}", flush=True)
    del cache, logits0, lk, lp

    reqs = [P["Request"](uid=i, prompt=p, max_new_tokens=MAX_NEW,
                         temperature=0.8 if i % 4 == 3 else 0.0,
                         top_k=8 if i % 4 == 3 else 0, seed=i)
            for i, p in enumerate(prompts)]
    w4a8_fn = P["w4a8_ops"].w4a8_matmul
    kvq_fn = P["kvq_ops"].kvq_decode_attn
    for r in reqs:
        eng.submit(r)
    w4a8_fn.launches = 0
    kvq_fn.launches = 0
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"w4a8_matmul": w4a8_fn.launches,
                "kvq_decode_attn": kvq_fn.launches}
    check(all(r.done for r in reqs), "not every request finished")
    check(all(len(r.generated) == MAX_NEW for r in reqs),
          "a request stopped short of max_new_tokens (no EOS was set)")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "a generated token is outside the vocabulary")
    check(launches["w4a8_matmul"] > 0 and launches["kvq_decode_attn"] > 0,
          f"a kernel of the path never launched: {launches}")
    decode_tokens = stats["tokens_out"] - len(reqs)
    served = {"requests": len(reqs), "tokens_out": stats["tokens_out"],
              "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
              "decode_tokens_per_s": decode_tokens / stats["decode_s"],
              "decode_step_ms": 1e3 * stats["decode_step_s"],
              "decode_steps": stats["decode_steps"],
              "ttft_p50_s": stats["ttft_p50_s"],
              "ttft_p95_s": stats["ttft_p95_s"],
              "prefill_s": stats["prefill_s"],
              "launches": launches,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    report["serve"] = served
    print("serve " + json.dumps(served), flush=True)
    return launches, eng


# --------------------------------------------------------------------------
# phase 3b: paged serve, with prefix sharing, COW and the tail-wave
# --------------------------------------------------------------------------

PAGED_ENGINE = dict(kv_layout="paged", slots=SLOTS, cache_len=PAGED_TOKENS,
                    block_size=64, prefill_chunk=64, max_new_cap=MAX_NEW,
                    decode_block=8)
SHARED_PREFIX = 160            # 2.5 blocks: the split block is shared


def paged_engine(P, cfg, params, dev, **kw):
    """An engine with the paged phase's settings (``kw`` overrides them;
    ``kv_layout="dense"`` gives the dense engine of the same geometry)."""
    return P["ServeEngine"](cfg, params, policy="A8d-C8-W4",
                            weights_layout="w4a8", device=dev,
                            **{**PAGED_ENGINE, **kw})


def shared_prefix_requests(P, cfg, n, uid0, seed):
    """n requests sharing a 160-token prefix, each with its own suffix of
    24 to 72 tokens; every fourth samples (temperature 0.8, top-k 8).

    The first suffix is the shortest, so the first prompt (184 tokens)
    ends inside the block where the prompts diverge: the prefix index
    registers that block as a split block with its content, and the
    followers admitted after it share it and copy it on first write."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, SHARED_PREFIX)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, cfg.vocab_size, 24 + 48 * i // max(n - 1, 1))
        sampled = i % 4 == 3
        reqs.append(P["Request"](
            uid=uid0 + i, prompt=np.concatenate([prefix, tail]).astype(
                np.int32), max_new_tokens=MAX_NEW,
            temperature=0.8 if sampled else 0.0,
            top_k=8 if sampled else 0, seed=uid0 + i))
    return reqs


def logit_gap(torch, got, want):
    got, want = got.float(), want.float()
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return rel, agree


def check_paged_logits(torch, P, cfg, dev, params, report):
    """Two one-step logit checks of the paged path, each within the
    relative L2 bound: (a) paged vs dense engines on the same prompts with
    the prefix cache off, both on the kernels; (b) on a paged state with
    prefix hits, COW and tail-waves behind it, the kernels vs the plain
    versions. No launch here is counted."""
    import numpy as np
    models = P["models"]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(32, 65, SLOTS)]
    logits = {}
    for layout, kw in (("dense", dict(kv_layout="dense")),
                       ("paged", dict(prefix_cache=False))):
        eng = paged_engine(P, cfg, params, dev, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(P["Request"](uid=i, prompt=pr,
                                    max_new_tokens=MAX_NEW))
        eng._admit()
        check(len(eng._slot_req) == SLOTS, f"{layout}: a wave short")
        if layout == "paged":
            eng._ensure_decode_blocks()
        lg, _ = models.decode_step(cfg, eng.params, eng.ctx,
                                   eng.state["tokens"],
                                   models.clone_cache(eng.state["cache"]))
        logits[layout] = lg
        del eng
    rel_a, agree_a = logit_gap(torch, logits["paged"], logits["dense"])
    check(bool(torch.isfinite(logits["paged"]).all()),
          "paged decode logits not finite")
    check(rel_a <= LOGIT_REL_TOL,
          f"paged decode logits differ from dense by relative L2 {rel_a} "
          f"> {LOGIT_REL_TOL}")

    eng = paged_engine(P, cfg, params, dev)
    reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 300, seed=13)
    for r in reqs:
        eng.submit(r)
    for _ in range(64):          # until a full slate decodes after a COW
        eng.step()
        if (len(eng._slot_req) == SLOTS and not eng._tail_jobs
                and eng.stats()["cow_copies"] > 0):
            break
    st = eng.stats()
    check(len(eng._slot_req) == SLOTS and st["cow_copies"] > 0
          and st["tail_waves"] > 0,
          f"logit check state lacks residents, COW or tail-waves: {st}")
    eng._ensure_decode_blocks()
    tokens = eng.state["tokens"]
    lk, _ = models.decode_step(cfg, eng.params, eng.ctx, tokens,
                               models.clone_cache(eng.state["cache"]))
    plain_ctx = replace(eng.ctx, kernel_backend="ref")
    lp, _ = models.decode_step(cfg, eng.params, plain_ctx, tokens,
                               models.clone_cache(eng.state["cache"]))
    rel_b, agree_b = logit_gap(torch, lk, lp)
    check(bool(torch.isfinite(lk).all()), "paged kernel logits not finite")
    check(rel_b <= LOGIT_REL_TOL,
          f"paged kernel decode logits differ from the plain versions' by "
          f"relative L2 {rel_b} > {LOGIT_REL_TOL}")
    eng.run_until_drained()
    check(all(r.done for r in reqs), "logit-check requests not finished")
    report["paged_logits"] = {
        "paged_vs_dense_rel_l2": rel_a, "paged_vs_dense_argmax": agree_a,
        "kernels_vs_plain_rel_l2": rel_b, "kernels_vs_plain_argmax": agree_b}
    print(f"phase 3b: one paged decode step's logits: vs dense relative L2 "
          f"{rel_a:.3g} (argmax agreement {agree_a:.2f}); kernels vs plain "
          f"versions {rel_b:.3g} ({agree_b:.2f})", flush=True)


def serve_paged(torch, P, cfg, dev, params, report):
    """qwen2.5-3b at full width on the paged pool: 8 requests sharing a
    160-token prefix through 4 slots, prefix cache on."""
    ops = P["kvq_ops"]
    counted = {"kvq_paged_decode_attn": ops.kvq_paged_decode_attn,
               "gather_dequant_paged_kv": ops.gather_dequant_paged_kv,
               "pool_block_copy": ops.copy_pool_blocks,
               "kvq_decode_attn": ops.kvq_decode_attn,
               "w4a8_matmul": P["w4a8_ops"].w4a8_matmul}
    eng = paged_engine(P, cfg, params, dev)
    check(eng.num_blocks == 32 and eng.table_len == 8,
          f"paged engine geometry: {eng.num_blocks} blocks, table "
          f"{eng.table_len}")
    reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 200, seed=14)
    for r in reqs:
        eng.submit(r)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    check(all(r.done for r in reqs), "paged: not every request finished")
    check(all(len(r.generated) == MAX_NEW for r in reqs),
          "paged: a request stopped short of max_new_tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "paged: a generated token is outside the vocabulary")
    check(stats["prefix_hit_blocks"] > 0 and stats["cow_copies"] > 0
          and stats["tail_waves"] > 0,
          f"paged: no prefix hit, COW or tail-wave: {stats}")
    for name in ("kvq_paged_decode_attn", "gather_dequant_paged_kv",
                 "pool_block_copy", "w4a8_matmul"):
        check(launches[name] > 0, f"paged: {name} never launched: "
                                  f"{launches}")
    check(launches["kvq_decode_attn"] == 0,
          f"paged: the dense decode kernel ran: {launches}")
    check(stats["free_blocks"] == eng.num_blocks,
          "paged: blocks leaked after the drain")
    decode_tokens = stats["tokens_out"] - len(reqs)
    served = {"requests": len(reqs), "tokens_out": stats["tokens_out"],
              "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
              "decode_tokens_per_s": decode_tokens / stats["decode_s"],
              "decode_step_ms": 1e3 * stats["decode_step_s"],
              "decode_steps": stats["decode_steps"],
              "ttft_p50_s": stats["ttft_p50_s"],
              "ttft_p95_s": stats["ttft_p95_s"],
              "prefill_s": stats["prefill_s"],
              "tail_waves": stats["tail_waves"],
              "prefill_chunks": stats["prefill_chunks"],
              "prefix_hit_tokens": stats["prefix_hit_tokens"],
              "prefix_hit_blocks": stats["prefix_hit_blocks"],
              "cow_copies": stats["cow_copies"],
              "prompt_tokens_prefilled": stats["prompt_tokens_prefilled"],
              "peak_cache_tokens": stats["peak_cache_tokens"],
              "launches": launches,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    report["serve_paged"] = served
    print("serve_paged " + json.dumps(served), flush=True)
    return launches, eng, {r.uid: r.generated for r in reqs}


# --------------------------------------------------------------------------
# phases 3c-3e: speculative decoding and optimistic admission
# --------------------------------------------------------------------------

def counted_kernels(P):
    ops = P["kvq_ops"]
    return {"kvq_spec_verify_attn": ops.kvq_spec_verify_attn,
            "kvq_decode_attn": ops.kvq_decode_attn,
            "kvq_paged_decode_attn": ops.kvq_paged_decode_attn,
            "gather_dequant_paged_kv": ops.gather_dequant_paged_kv,
            "pool_block_copy": ops.copy_pool_blocks,
            "w4a8_matmul": P["w4a8_ops"].w4a8_matmul}


def drive(torch, P, eng, reqs):
    """Serve ``reqs`` to the end with every launch count set to 0 just
    before and read just after. Returns (stats, launches, wall s)."""
    counted = counted_kernels(P)
    for r in reqs:
        eng.submit(r)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return stats, {n: fn.launches for n, fn in counted.items()}, wall


def span_ms(tracer, name):
    durs = [e["dur"] for e in tracer.events()
            if e["ph"] == "span" and e["name"] == name]
    return 1e3 * sum(durs) / max(len(durs), 1), len(durs)


def spec_summary(stats, reqs, wall, launches, tracer):
    verify_ms, waves = span_ms(tracer, "spec_verify")
    draft_ms, _ = span_ms(tracer, "spec_draft")
    decode_tokens = stats["tokens_out"] - len(reqs)
    return {"requests": len(reqs), "tokens_out": stats["tokens_out"],
            "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
            "decode_tokens_per_s": decode_tokens / stats["decode_s"],
            "verify_wave_ms": verify_ms, "draft_ms_per_wave": draft_ms,
            "wave_ms": 1e3 * stats["decode_s"] / max(stats["spec_waves"], 1),
            "ttft_p50_s": stats["ttft_p50_s"],
            "ttft_p95_s": stats["ttft_p95_s"],
            "spec_waves": stats["spec_waves"],
            "spec_drafted": stats["spec_drafted"],
            "spec_accepted": stats["spec_accepted"],
            "spec_rolled_back": stats["spec_rolled_back"],
            "spec_accept_rate": stats["spec_accept_rate"],
            "spec_draft_layers": stats["spec_draft_layers"],
            "tail_waves": stats["tail_waves"],
            "cow_copies": stats["cow_copies"],
            "preemptions": stats["preemptions"],
            "swap_out_bytes": stats["swap_out_bytes"],
            "swap_in_bytes": stats["swap_in_bytes"],
            "swap_s": stats["swap_s"],
            "launches": launches}


def check_streams(cfg, reqs, what):
    check(all(r.done for r in reqs), f"{what}: not every request finished")
    check(all(len(r.generated) == MAX_NEW for r in reqs),
          f"{what}: a request stopped short of max_new_tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{what}: a generated token is outside the vocabulary")


def serve_spec(torch, P, cfg, dev, params, report, plain_streams):
    """The paged phase's 8 shared-prefix requests with speculative decoding
    at the CLI's defaults (k = 4, a draft of half the layers, exact mode):
    the verify kernel and the draft's dense decode kernel launch, the
    paged decode kernel does not, and every stream equals the plain
    paged phase's stream of the same request."""
    tracer = P["Tracer"](capacity=1 << 16)
    eng = paged_engine(P, cfg, params, dev, spec=P["SpecConfig"](k=SPEC_K),
                       trace=tracer)
    check(eng.spec.resolved_layers(cfg) == cfg.n_layers // 2,
          "spec: the default draft is not half the target's layers")
    reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 200, seed=14)
    stats, launches, wall = drive(torch, P, eng, reqs)
    check_streams(cfg, reqs, "spec")
    for name in ("kvq_spec_verify_attn", "kvq_decode_attn", "w4a8_matmul"):
        check(launches[name] > 0, f"spec: {name} never launched: {launches}")
    check(launches["kvq_paged_decode_attn"] == 0,
          f"spec: the paged decode kernel ran: {launches}")
    check(stats["free_blocks"] == eng.num_blocks,
          "spec: blocks leaked after the drain")
    differ = [r.uid for r in reqs if r.generated != plain_streams[r.uid]]
    served = spec_summary(stats, reqs, wall, launches, tracer)
    served["streams_differing_from_plain"] = differ
    report["serve_spec"] = served
    print("serve_spec " + json.dumps(served), flush=True)
    check(not differ, f"spec: exact-mode streams differ from plain paged "
                      f"decode for requests {differ}")
    print(f"phase 3c: spec serve, {served['decode_tokens_per_s']:.2f} decode "
          f"tok/s, {served['verify_wave_ms']:.1f} ms per verify-wave, "
          f"TTFT p50 {served['ttft_p50_s']:.3f} s p95 "
          f"{served['ttft_p95_s']:.3f} s; {served['spec_waves']} waves, "
          f"{served['spec_drafted']} drafted, {served['spec_accepted']} "
          f"accepted, {served['spec_rolled_back']} rolled back, accept rate "
          f"{served['spec_accept_rate']:.3f}; streams equal plain decode",
          flush=True)
    return launches


def verify_vs_decode(torch, P, cfg, eng):
    """At one wave of ``eng``'s residents: the logits of ``spec_verify``
    over a greedy window against C sequential ``decode_step`` calls
    consuming the same tokens, each on its own copy of the cache."""
    models = P["models"]
    C = SPEC_C
    tails = torch.zeros((eng.slots,), dtype=torch.int32)
    for s, r in list(eng._slot_req.items()):
        w = eng._written[s]
        t = min(C, len(r.prompt) + r.max_new_tokens - 1 - w)
        check(eng._ensure(s, w + t) and eng._cow_guard(s, w, w + t),
              "verify-vs-decode: a resident was swapped out")
        tails[s] = t
    eng._push_tables()
    st = eng.state
    tok = st["tokens"].clone()
    window, seq = [tok], []
    cache_a = models.clone_cache(st["cache"])
    for j in range(C):
        lg, cache_a = models.decode_step(cfg, eng.params, eng.ctx, tok,
                                         cache_a)
        seq.append(lg[:, 0].float())
        tok = torch.argmax(lg[:, -1].float(), -1).to(torch.int32)[:, None]
        if j < C - 1:
            window.append(tok)
    cache_b = models.clone_cache(st["cache"])
    vl, _ = models.spec_verify(
        cfg, eng.params, eng.ctx, torch.cat(window, dim=1), cache_b,
        torch.arange(eng.slots, dtype=torch.int32, device=tok.device),
        cache_b["position"].clone(), tails.to(tok.device),
        hist_blocks=eng.table_len)
    seq = torch.stack(seq, dim=1)
    rows = [(s, j) for s in eng._slot_req for j in range(int(tails[s]))]
    got = torch.stack([vl[s, j].float() for s, j in rows])
    want = torch.stack([seq[s, j] for s, j in rows])
    rel, agree = logit_gap(torch, got, want)
    return bool(torch.equal(got, want)), rel, agree, len(rows)


def serve_self_draft(torch, P, cfg, dev, params, report):
    """Greedy requests with the target as its own draft (36 layers): the
    verify logits against decode's at one wave, then the accept rate
    (1.0 when they agree bitwise). Prompts fit one prefill window and the
    prefix cache is off, so the draft's dense prefill and the target's
    paged prefill compute the same cache."""
    import numpy as np
    rng = np.random.default_rng(18)
    reqs = [P["Request"](uid=500 + i, prompt=rng.integers(
        0, cfg.vocab_size, int(n)).astype(np.int32), max_new_tokens=MAX_NEW)
        for i, n in enumerate(rng.integers(40, 65, SLOTS))]
    eng = paged_engine(P, cfg, params, dev, prefix_cache=False,
                       spec=P["SpecConfig"](k=SPEC_K,
                                            draft_layers=cfg.n_layers))
    for r in reqs:
        eng.submit(r)
    eng._admit()
    check(len(eng._slot_req) == SLOTS, "self-draft: a wave short")
    bitwise, rel, agree, n_rows = verify_vs_decode(torch, P, cfg, eng)
    check(rel <= LOGIT_REL_TOL,
          f"verify logits differ from decode's by relative L2 {rel} > "
          f"{LOGIT_REL_TOL}")
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_streams(cfg, reqs, "self-draft")
    out = {"verify_vs_decode_bitwise": bitwise,
           "verify_vs_decode_rel_l2": rel,
           "verify_vs_decode_argmax": agree, "positions": n_rows,
           "spec_accept_rate": stats["spec_accept_rate"],
           "spec_waves": stats["spec_waves"],
           "spec_drafted": stats["spec_drafted"],
           "spec_accepted": stats["spec_accepted"],
           "decode_tokens_per_s": (stats["tokens_out"] - len(reqs))
           / stats["decode_s"],
           "wave_ms": 1e3 * stats["decode_s"] / max(stats["spec_waves"], 1),
           "wall_s": wall}
    report["self_draft"] = out
    print(f"phase 3d: self-draft ({cfg.n_layers} layers): accept rate "
          f"{out['spec_accept_rate']:.3f} over {out['spec_waves']} waves; "
          f"verify logits vs decode at one wave ({n_rows} positions): "
          f"bitwise {'yes' if bitwise else 'no'}, relative L2 {rel:.3g}, "
          f"argmax agreement {agree:.3f}", flush=True)


def check_tail_rows(torch, P, cfg, dev, params, report):
    """A tail-wave row gives the same bits alone as in a wave with a
    deeper row (whose history sets the wave's table walk): one attention
    layer of qwen2.5-3b, its output and the cache blocks it commits
    compared bitwise."""
    import numpy as np
    from repro_torch.models import blocks
    from repro_torch.models.common import rope_tables
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    bs, NB, C = 64, 24, 64
    ctx = P["qat"].make_ctx("A8d-C8-W4", weights_layout="w4a8")
    pool, layers = blocks.init_paged_attn_cache(cfg, 2, NB, bs, layers=1,
                                                device=dev)
    for key in ("k_q", "v_q"):
        pool[key].copy_(torch.randint(-127, 128, pool[key].shape,
                                      generator=gen, device=dev,
                                      dtype=torch.int8))
    for key in ("s_k", "s_v"):
        pool[key].copy_(torch.rand(pool[key].shape, generator=gen,
                                   device=dev) * 0.02 + 1e-3)
    perm = torch.randperm(NB, generator=gen, device=dev).to(torch.int32)
    tbl = perm[:16].reshape(2, 8).contiguous()
    offs = [100, 400]
    x = torch.randn((2, C, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    p = params["layers"][0]["attn"]

    def run(rows, hb):
        pl = {k: v.clone() for k, v in pool.items()}
        layer = {**{k: pl[k][0] for k in pl},
                 "length": torch.zeros((2,), dtype=torch.int32, device=dev)}
        off = torch.tensor([offs[i] for i in rows], dtype=torch.int32,
                           device=dev)
        pos = off.long()[:, None] + torch.arange(C, device=dev)[None]
        rope = rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
        own = [min(int(2 ** np.ceil(np.log2(-(-(offs[i] + C) // bs)))), 8)
               for i in rows]
        y, _ = blocks.attn_chunk_prefill(
            cfg, ctx, p, x[rows], rope, layer, tbl[rows, :hb].contiguous(),
            torch.tensor(rows, dtype=torch.int32, device=dev), off,
            torch.full((len(rows),), C, dtype=torch.int32, device=dev),
            hist_rows=own)
        return y, pl

    y_wave, pool_wave = run([0, 1], 8)
    y_alone, pool_alone = run([0], 4)
    own = tbl[0].long()                 # row 0's blocks (row 1's differ)
    same = (torch.equal(y_wave[0], y_alone[0])
            and all(torch.equal(pool_wave[k][:, own], pool_alone[k][:, own])
                    for k in pool))
    report["tail_row_invariant"] = same
    check(same, "a tail-wave row differs alone and inside a deeper wave")
    print("phase 3b: a tail-wave row is bitwise the same alone and beside "
          "a deeper row", flush=True)


def serve_optimistic(torch, P, cfg, dev, params, report):
    """The paged phase's requests, prefix cache off, under optimistic
    admission (speculative decoding at the CLI's defaults) on a pool of
    about 60% of the reserve worst case: at least one preemption, the
    bytes swapped out all swapped back in, and every stream equal to the
    same request's under reserve admission on a full pool. The prefix
    cache is off on both sides because the admission order decides which
    prompt tokens a request finds cached, and a cached token is read back
    quantized where a computed one is not."""
    def run(**kw):
        reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 200, seed=14)
        tracer = P["Tracer"](capacity=1 << 16)
        eng = paged_engine(P, cfg, params, dev, prefix_cache=False,
                           max_seq_len=PAGED_TOKENS, trace=tracer, **kw)
        stats, launches, wall = drive(torch, P, eng, reqs)
        check_streams(cfg, reqs, f"optimistic phase {kw}")
        check(stats["free_blocks"] == eng.num_blocks,
              f"optimistic phase {kw}: blocks leaked after the drain")
        return reqs, stats, launches, wall, tracer

    reqs, _, _, _, _ = run()                          # reserve, plain decode
    reserve_streams = {r.uid: r.generated for r in reqs}
    need = sorted(-(-(len(r.prompt) + MAX_NEW - 1) // 64) for r in reqs)
    worst = sum(need[-SLOTS:])
    nb = max(need[-1], int(0.6 * worst))
    reqs, stats, launches, wall, tracer = run(
        num_blocks=nb, admission="optimistic",
        spec=P["SpecConfig"](k=SPEC_K))
    served = spec_summary(stats, reqs, wall, launches, tracer)
    served.update(num_blocks=nb, reserve_worst_case_blocks=worst)
    differ = [r.uid for r in reqs if r.generated != reserve_streams[r.uid]]
    served["streams_differing_from_reserve"] = differ
    report["serve_optimistic"] = served
    print("serve_optimistic " + json.dumps(served), flush=True)
    check(stats["preemptions"] >= 1,
          f"optimistic: no preemption on {nb} blocks")
    check(stats["swap_out_bytes"] == stats["swap_in_bytes"] > 0,
          f"optimistic: swap bytes out {stats['swap_out_bytes']} != in "
          f"{stats['swap_in_bytes']}")
    check(not differ, f"optimistic: streams differ from reserve admission "
                      f"for requests {differ}")
    print(f"phase 3e: optimistic admission on {nb} of {worst} worst-case "
          f"blocks: {stats['preemptions']} preemptions, "
          f"{stats['swap_out_bytes']} bytes out and in, swap "
          f"{1e3 * stats['swap_s']:.1f} ms; streams equal reserve "
          f"admission's", flush=True)


def profile_decode(torch, P, cfg, eng, report, key="serve"):
    """Device busy time of decode chunks, from the profiler's CUDA
    kernel records, beside the un-profiled decode step time of the serve
    phase ``key``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    reqs = [P["Request"](uid=100 + i, prompt=rng.integers(
        0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=MAX_NEW)
        for i in range(SLOTS)]
    for r in reqs:
        eng.submit(r)
    eng.step()                          # admission + first chunk, unprofiled
    torch.cuda.synchronize()
    steps0 = eng.stats()["decode_steps"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.step()
        eng.step()
        torch.cuda.synchronize()
    steps = eng.stats()["decode_steps"] - steps0
    eng.run_until_drained()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    name = "decode_profile" if key == "serve" else f"{key}_decode_profile"
    if not kernels or not steps:
        report[name] = "not measured: no device records"
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / steps
    step_ms = report[key]["decode_step_ms"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    report[name] = {
        "decode_steps": steps, "device_busy_ms_per_step": busy_ms,
        "decode_step_ms_unprofiled": step_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
        "kernels_per_step": len(kernels) / steps,
        "top_kernels_us_per_step": [(n[:90], us / steps) for n, us in top]}
    print(f"{key} decode profile: device busy {busy_ms:.2f} ms of a "
          f"{step_ms:.2f} ms step ({len(kernels) / steps:.0f} kernels per "
          f"step)", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this check runs only "
              "on a GPU", file=sys.stderr)
        return 1
    try:
        P = import_port()
    except ImportError as e:
        print(f"chip_smoke: cannot import the port next to this script "
              f"({e}); run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # exact f32 plain matmul
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report = {}
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    report["card"] = card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = P["build"].build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"phase 1: built {sorted(libs)} in {report['build_s']:.1f} s",
          flush=True)

    cfg = P["get_config"]("qwen2.5-3b")
    w4a8_err = check_w4a8(torch, P, cfg, dev, report)
    kvq_err = check_kvq(torch, P, cfg, dev, report)
    paged_err = check_paged_decode(torch, P, cfg, dev, report)
    gather_err = check_gather(torch, P, cfg, dev, report)
    copy_err = check_copy(torch, P, cfg, dev, report)
    spec_err = check_spec_verify(torch, P, cfg, dev, report)
    check_norm_rows(torch, P, cfg, dev, report)
    fq_err = check_fake_quant(torch, P, cfg, dev, report)
    flash_err = check_flash(torch, P, cfg, dev, report)
    launches, eng = serve(torch, P, cfg, dev, report)
    profile_decode(torch, P, cfg, eng, report)
    params = eng.params                 # packed exports, bf16 linears gone
    del eng
    torch.cuda.empty_cache()
    paged_launches, eng, plain_streams = serve_paged(torch, P, cfg, dev,
                                                     params, report)
    profile_decode(torch, P, cfg, eng, report, key="serve_paged")
    del eng
    check_paged_logits(torch, P, cfg, dev, params, report)
    spec_launches = serve_spec(torch, P, cfg, dev, params, report,
                               plain_streams)
    serve_self_draft(torch, P, cfg, dev, params, report)
    check_tail_rows(torch, P, cfg, dev, params, report)
    serve_optimistic(torch, P, cfg, dev, params, report)
    del params
    torch.cuda.empty_cache()
    train_launches = train_full(torch, P, cfg, dev, report)
    torch.cuda.empty_cache()
    train_static(torch, P, cfg, dev, report)
    torch.cuda.empty_cache()
    w4a8_t = time_w4a8(torch, P, cfg, dev, report)
    kvq_t = time_kvq(torch, P, cfg, dev, report)
    paged_t = time_paged_decode(torch, P, cfg, dev, report)
    gather_t = time_gather(torch, P, cfg, dev, report)
    copy_t = time_copy(torch, P, cfg, dev, report)
    spec_t = time_spec_verify(torch, P, cfg, dev, report)
    fq_fwd_t, fq_bwd_t = time_fake_quant(torch, P, cfg, dev, report)
    flash_t = time_flash(torch, P, cfg, dev, report)
    for name, t in (("kvq_paged_decode_attn", paged_t),
                    ("gather_dequant_paged_kv", gather_t),
                    ("pool_block_copy", copy_t),
                    ("kvq_spec_verify_attn", spec_t),
                    ("fake_quant_fwd", fq_fwd_t),
                    ("fake_quant_bwd", fq_bwd_t),
                    ("flash_attn_fwd", flash_t)):
        print(f"phase 4: {name}: {t['ms']:.4f} ms (bound {t['bound_ms']:.5f}"
              f" ms by {t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms", flush=True)
    report["total_s"] = time.perf_counter() - t_start

    kernels = [
        {"name": "w4a8_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/w4a8_matmul.cu",
         "replaces": "src/repro/kernels/w4a8/kernel.py:62",
         "launches": launches["w4a8_matmul"], "max_abs_err": w4a8_err,
         **w4a8_t,
         "per": f"one decode step at M={SLOTS}: 36 layers x 7 linears + "
                "the tied head"},
        {"name": "kvq_decode_attn", "route": "cuda",
         "source": "src/repro_torch/csrc/kvq_decode_attn.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:338",
         "launches": launches["kvq_decode_attn"], "max_abs_err": kvq_err,
         **kvq_t,
         "per": f"one decode step: 36 launches at B={SLOTS}, H=16, Hkv=2, "
                f"D=128, S={CACHE_LEN}, lengths {list(KVQ_LENGTHS)}"},
        {"name": "kvq_paged_decode_attn", "route": "cuda",
         "source": "src/repro_torch/csrc/kvq_paged_decode_attn.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:109",
         "launches": paged_launches["kvq_paged_decode_attn"],
         "max_abs_err": paged_err, **paged_t,
         "per": f"one paged decode step: 36 launches at B={SLOTS}, H=16, "
                f"Hkv=2, D=128, block 64, T=8, lengths "
                f"{list(PAGED_LENGTHS)}"},
        {"name": "gather_dequant_paged_kv", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_dequant_paged_kv.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:174",
         "launches": paged_launches["gather_dequant_paged_kv"],
         "max_abs_err": gather_err, **gather_t,
         "per": "one tail-wave: 72 launches (K and V of 36 layers) at "
                "n, T, bs = %s" % (GATHER_SHAPE,)},
        {"name": "pool_block_copy", "route": "cuda",
         "source": "src/repro_torch/csrc/pool_block_copy.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:308",
         "launches": paged_launches["pool_block_copy"],
         "max_abs_err": copy_err, **copy_t,
         "per": "one COW of one block: 4 launches (k_q, v_q, s_k, s_v "
                "leaves of 36 layers)"},
        {"name": "kvq_spec_verify_attn", "route": "cuda",
         "source": "src/repro_torch/csrc/kvq_spec_verify_attn.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:255",
         "launches": spec_launches["kvq_spec_verify_attn"],
         "max_abs_err": spec_err, **spec_t,
         "per": f"one verify-wave: 36 launches at B={SLOTS}, C={SPEC_C}, "
                f"H=16, Hkv=2, D=128, block 64, T={SPEC_T}, histories "
                f"{list(spec_histories(64))}"},
        {"name": "fake_quant_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/quant/kernel.py:55",
         "launches": train_launches["fake_quant_fwd"],
         "max_abs_err": fq_err, **fq_fwd_t,
         "per": "one QAT student step: 253 launches (36 layers x 7 "
                "weights per output channel at 4 bits + the tied head per "
                "vocab row at 8 bits)"},
        {"name": "fake_quant_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/quant/kernel.py:74",
         "launches": train_launches["fake_quant_bwd"],
         "max_abs_err": fq_err, **fq_bwd_t,
         "per": "one QAT student backward: 253 launches, the forward's "
                "sites"},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attn_fwd.cu",
         "replaces": "src/repro/kernels/flash_attn/kernel.py:74",
         "launches": train_launches["flash_attn_fwd"],
         "max_abs_err": flash_err, **flash_t,
         "per": f"one teacher forward: 36 launches at B={TRAIN_B}, "
                f"S={TRAIN_T}, H=16, Hkv=2, D=128, causal"},
    ]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"done in {report['total_s']:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
