#!/usr/bin/env python3
"""Time ``slstm_scan`` and ``gather_dequant_paged_kv`` at ``chip_smoke.py``'s
shapes, for this tree's port or for another checkout's, and, with
``--ablate``, this tree's sources with parts taken out.

    python3 tools/scan_times.py [--src OTHER/src] [--label NAME]
                                [--out FILE] [--ablate]

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
``--src`` times the port under ``OTHER/src`` instead (e.g. an unpacked
parent commit; its kernels are built there at first use). Cases:
``slstm_scan`` per call and per step at the xLSTM QAT teacher's shape (B 8,
T 128, d 768, bf16) through the wrapper's own route (and each route
forced, where the port has routes; in each carry, f32 and gx, where the
port has carries); ``gather_dequant_paged_kv`` per launch
(one leaf, and K and V in one launch where the port has it) at the
tail-wave's shape (n 4, T 8, bs 64) and at a 512-entry table (32k tokens
a row). Each goes through ``chip_smoke``'s timing: CUDA-graph
replays between events with inputs rotated past the L2 cache, beside the
bound (f32 operations over 67 TF/s, or bytes over 3.35 TB/s).

``--ablate`` builds variants of ``csrc/slstm_scan.cu`` (the resident
route in the gx carry, the teacher's, with a quarter of its FMAs, every
load kept; without the grid
barrier; without the read of h; with r_h read from global memory, L2,
instead of shared memory) and of ``csrc/gather_dequant_paged_kv.cu``
(streaming stores; no table read; no pool or scale loads), each the
committed source with a text replacement (the tool stops if a pattern
is no longer in the source), into a temporary directory with the port's
``nvcc`` flags, and times each through ctypes beside the source as
committed; the two store variants also with a read of the output after
the gather (``out.sum()``, as the attention that reads it next).
Variants that take a part out compute wrong results and are only
timed.

To compare two versions, run the tool once per version in turn on one
card, alternating (parent, tree, tree, parent, ...): the spread between
the runs of one version is the noise a difference has to clear. Prints
the card (``nvidia-smi`` name, power limit) and one JSON line per case,
and appends the lines to ``--out``, if given.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SCAN_SHAPE = (8, 128, 768)
GATHER_LONG = (4, 512, 64, (512 * 64,) * 4)
# (name, replacements) of each variant
SCAN_VARIANTS = (
    ("as committed", ()),
    ("a quarter of the FMAs", ((
        "                acc[q * 8 + b] = fmaf(hb, r[q], acc[q * 8 + b]);",
        "                if (q == (b & 3)) acc[b] = fmaf(hb, r[q], acc[b]);"),
    )),
    ("no barrier", ((
        "    if (t + 1 < T) grid_barrier(bar, (t + 1) * gridDim.x);", ""),)),
    ("no h read", ((
        "      load_h(h_sh, h_in + (size_t)b0 * d, nb * d, d);", ""),)),
    ("r_h from L2", ((
        "            load4(rj + (size_t)m * 4, r);",
        "            for (int q = 0; q < 4; ++q)\n              r[q] = "
        "to_f32(rh[(size_t)m * d4 + (size_t)q * d + j]);"),
    )),
)
GATHER_VARIANTS = (
    ("as committed", ()),
    ("streaming stores", ((
        "        o[j] = make_float4(__fmul_rn(byte_at(words[j], 0), sc),\n"
        "                           __fmul_rn(byte_at(words[j], 1), sc),\n"
        "                           __fmul_rn(byte_at(words[j], 2), sc),\n"
        "                           __fmul_rn(byte_at(words[j], 3), sc));",
        "        __stcs(o + j, make_float4(__fmul_rn(byte_at(words[j], 0), "
        "sc),\n __fmul_rn(byte_at(words[j], 1), sc),\n"
        " __fmul_rn(byte_at(words[j], 2), sc),\n"
        " __fmul_rn(byte_at(words[j], 3), sc)));"),)),
    ("no table read", ((
        "min(max(__ldg(tbl + (size_t)(rh / Hkv) * T + t), 0), NB - 1)",
        "t % NB"),)),
    ("no pool or scale loads", ((
        "    const int4 w =\n        __ldg(reinterpret_cast<const int4*>"
        "(pool + (src + p) * D * ES) + c);\n    const float sc = "
        "__ldg(s + src + p);",
        "    const int4 w = make_int4(i, i, i, i);\n"
        "    const float sc = 1.0f;"),)),
)


def scan_bound_ms(cs, B, T, d):
    flops = 2 * B * T * d * 4 * d
    nbytes = 2 * B * T * 4 * d + 2 * d * 4 * d + 2 * B * T * d + 16 * B * d
    return max(nbytes / cs.HBM_BYTES_PER_S, flops / cs.F32_FLOPS_PER_S) * 1e3


def gather_bound_ms(cs, cfg, case):
    n, T, bs, _ = case
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    rows = n * Hkv * T * bs
    return (rows * (D + 4) + 4 * n * T + 4 * rows * D) \
        / cs.HBM_BYTES_PER_S * 1e3


def scan_sets(cs, torch, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    B, T, d = SCAN_SHAPE
    base = cs.slstm_inputs(torch, gen, B, T, d, dev)
    return [base] + [cs.slstm_inputs(torch, gen, B, T, d, dev) for _ in
                     range(cs.copies_for(cs.tensor_bytes(*base)) - 1)]


def gather_sets(cs, torch, cfg, dev, case):
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    n, T, bs, _ = case
    out_bytes = 8 * n * cfg.n_kv_heads * T * bs * cfg.resolved_head_dim
    base = cs.gather_inputs(torch, gen, cfg, dev, case)
    return [base] + [cs.gather_inputs(torch, gen, cfg, dev, case) for _ in
                     range(cs.copies_for(cs.tensor_bytes(*base)
                                         + out_bytes) - 1)]


def port_cases(cs, torch, P, cfg, dev):
    """(kernel, case, fields) through the port's wrappers."""
    ops = P["slstm_ops"]
    sets = scan_sets(cs, torch, dev)
    B, T, d = SCAN_SHAPE
    params = inspect.signature(ops.slstm_scan).parameters
    routes = [None] + (["resident", "step"] if "route" in params else [])
    carries = ["f32", "gx"] if "carry" in params else [None]
    for carry in carries:
        for route in routes:
            kw = {k: v for k, v in (("route", route), ("carry", carry))
                  if v is not None}

            def fn(*a, kw=kw):
                return ops.slstm_scan(*a, **kw)
            ms = cs.time_ms(torch, fn, sets, min_calls=10)
            yield "slstm_scan", (f"B={B} T={T} d={d} {route or 'own route'}"
                                 + (f" carry {carry}" if carry else "")), {
                "ms": ms, "ms_per_step": ms / T, "us_per_step": ms / T * 1e3,
                "bound_ms": scan_bound_ms(cs, B, T, d),
                "route": route or "auto", "carry": carry or "f32"}
    del sets
    kops = P["kvq_ops"]
    fns = [("one leaf", 1, lambda k, s_k, v, s_v, tbl:
            kops.gather_dequant_paged_kv(k, s_k, tbl))]
    if hasattr(kops, "gather_dequant_paged_kv_pair"):
        fns.append(("K and V in one launch", 2,
                    kops.gather_dequant_paged_kv_pair))
    for case in (cs.GATHER_CASES[0], GATHER_LONG):
        sets = gather_sets(cs, torch, cfg, dev, case)
        for how, leaves, fn in fns:
            ms = cs.time_ms(torch, fn, sets)
            yield "gather_dequant_paged_kv", f"n, T, bs = {case[:3]} {how}", {
                "ms": ms, "us": ms * 1e3, "leaves": leaves,
                "bound_ms": leaves * gather_bound_ms(cs, cfg, case)}
        del sets
        torch.cuda.empty_cache()


def build_variants(source, variants, tmp: Path):
    """[ctypes library] of ``csrc/<source>.cu`` with each variant's text
    replacements, all nvcc runs at once."""
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, nvcc_path
    text = (CSRC / f"{source}.cu").read_text()
    procs = []
    for i, (name, reps) in enumerate(variants):
        src = text
        for old, new in reps:
            if old not in src:
                raise SystemExit(f"{source}.cu no longer contains the text "
                                 f"variant {name!r} replaces: {old!r}")
            src = src.replace(old, new)
        cu, so = tmp / f"{source}-{i}.cu", tmp / f"{source}-{i}.so"
        cu.write_text(src)
        procs.append((so, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (name, _), (so, p) in zip(variants, procs):
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        libs.append(ctypes.CDLL(str(so)))
    return libs


def ablate_cases(cs, torch, P, cfg, dev, tmp: Path):
    """(kernel, case, fields) of each ablation variant."""
    sops, kops = P["slstm_ops"], P["kvq_ops"]
    libs = build_variants("slstm_scan", SCAN_VARIANTS, tmp)
    sets = scan_sets(cs, torch, dev)
    B, T, d = SCAN_SHAPE
    for (what, _), lib in zip(SCAN_VARIANTS, libs):
        fn_c = lib.slstm_scan_launch
        fn_c.argtypes = list(sops._ARGTYPES)
        fn_c.restype = ctypes.c_int

        def scan(gx, r_h, h0, c0, fn_c=fn_c, what=what):
            hbuf = torch.empty((2, B, d), dtype=torch.float32, device=dev)
            hbuf[0].copy_(h0.to(gx.dtype))
            c = c0.clone()
            hs = torch.empty((B, T, d), dtype=gx.dtype, device=dev)
            bar = torch.zeros(sops.BAR_INTS, dtype=torch.int32, device=dev)
            err = fn_c(gx.data_ptr(), r_h.data_ptr(), hbuf.data_ptr(),
                       c.data_ptr(), hs.data_ptr(), bar.data_ptr(),
                       sops.BAR_INTS, B, T, d, 1, 1, 1,
                       sops.ROUTES["resident"],
                       torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"scan variant {what!r}: CUDA error {err}")
            return hs

        ms = cs.time_ms(torch, scan, sets, min_calls=10)
        yield "slstm_scan", f"ablate: {what}", {
            "ms": ms, "us_per_step": ms / T * 1e3}
    del sets
    libs = build_variants("gather_dequant_paged_kv", GATHER_VARIANTS, tmp)
    for case in (cs.GATHER_CASES[0], GATHER_LONG):
        sets = gather_sets(cs, torch, cfg, dev, case)
        for (what, _), lib in zip(GATHER_VARIANTS, libs):
            fn_c = lib.gather_dequant_paged_kv_launch
            fn_c.argtypes = list(kops._ARGTYPES["gather_dequant_paged_kv"])
            fn_c.restype = ctypes.c_int

            def gather(pool, s, v_pool, s_v, tbl, fn_c=fn_c, what=what):
                NB1, Hkv, bs, D = pool.shape
                n, T_ = tbl.shape
                out = torch.empty((n, Hkv, T_ * bs, D), dtype=torch.float32,
                                  device=dev)
                err = fn_c(pool.data_ptr(), s.data_ptr(), tbl.data_ptr(),
                           out.data_ptr(), n, Hkv, NB1 - 1, bs, T_, D,
                           kops.KV_DTYPES[pool.dtype],
                           torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"gather variant {what!r}: error "
                                       f"{err}")
                return out

            stores = what in ("as committed", "streaming stores")
            for read in (False, True) if stores else (False,):
                fn = (lambda *a, g=gather: g(*a).sum()) if read else gather
                ms = cs.time_ms(torch, fn, sets)
                yield "gather_dequant_paged_kv", (
                    f"n, T, bs = {case[:3]} ablate: {what}"
                    + (" + out.sum()" if read else "")), {
                    "ms": ms, "us": ms * 1e3, "read_after": read}
        del sets
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default="")
    ap.add_argument("--ablate", action="store_true",
                    help="time this tree's sources with parts taken out")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("scan_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels.kvq_attn import ops as kvq_ops
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    P = dict(get_config=get_config, kvq_ops=kvq_ops, slstm_ops=slstm_ops)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{card}; {args.label}: "
          f"{Path(P['slstm_ops'].__file__).resolve()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = P["get_config"]("qwen2.5-3b")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        cases = (ablate_cases(cs, torch, P, cfg, dev, Path(tmp))
                 if args.ablate else port_cases(cs, torch, P, cfg, dev))
        for kernel, case, fields in cases:
            line = {"label": args.label, "card": card, "kernel": kernel,
                    "case": case, **fields}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
