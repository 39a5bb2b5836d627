#!/usr/bin/env python3
"""Time ``csrc/flash_attn_fwd.cu`` with one part of its tile loop taken
out at a time (or the whole tile compute), to see what bounds it.

    python3 tools/flash_ablate.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
Each variant is the committed source with a text replacement (the tool
stops if a pattern is no longer in the source), built with the port's
``nvcc`` flags into a temporary directory and launched through ctypes at
(B 8, S 128) and (B 8, S 1024), qwen2.5-3b's heads (H 16, Hkv 2, D 128),
causal, by ``chip_smoke.time_ms`` (CUDA-graph replays, inputs rotated
past the L2 cache), beside SDPA with ``enable_gqa``. The ablated variants
compute wrong results and are only timed; the committed source and the
accurate-``expf``, ring-depth and tile-size variants are also held to
``chip_smoke.check_flash``, which prints each one's share of outputs
beyond one ulp of the plain version. Prints the card and
one JSON line per variant and shape, appended to ``--out`` if given.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SRC = ROOT / "src/repro_torch/csrc/flash_attn_fwd.cu"

_MMA_S = ("""          mma(s[mt][2 * j], qa[mt], kf[0], kf[1]);
          mma(s[mt][2 * j + 1], qa[mt], kf[2], kf[3]);""",
          """          s[mt][2 * j][0] += __uint_as_float(kf[0] ^ qa[mt][0]);
          s[mt][2 * j + 1][1] += __uint_as_float(kf[3] ^ qa[mt][3]);""")
_MMA_O = ("""          mma(o[mt][2 * j], pa[mt][kk], vf[0], vf[1]);
          mma(o[mt][2 * j + 1], pa[mt][kk], vf[2], vf[3]);""",
          """          o[mt][2 * j][0] += __uint_as_float(vf[0] ^ pa[mt][kk][0]);
          o[mt][2 * j + 1][1] += __uint_as_float(vf[3] ^ pa[mt][kk][3]);""")
_FAKE_LDSM = """__device__ __forceinline__ void ldsm_fake(unsigned (&r)[4],
                                          const void* p) {
  const unsigned a = smem_addr(p);
  r[0] = a; r[1] = a ^ 1; r[2] = a ^ 2; r[3] = a ^ 3;
}

// d += a . b"""
# the tile compute: from the line after the first marker up to the second
_TILE = ("    const __nv_bfloat16* vs = v_s + (it % STAGES) * BK * LD;\n",
         "    __syncthreads();                        // the buffer is free")
_KEEP = ("    if (threadIdx.x == 0 && ks[0] == vs[0]) o[0][0][0] += 1.f;\n")
_NO_LOADS = ("    load_kv(it + STAGES - 1);", "    cp_async_commit();")
# (name, replacements, checked): a replacement is (pattern, text), or
# (first marker, second marker, text) for the region between them
VARIANTS = (
    ("as committed", (), True),
    ("no MMAs", (_MMA_S, _MMA_O), False),
    ("no exponentials", (
        ("exp2_approx(fmaf(s[mt][j][e], LOG2E, -ml[r]))", "s[mt][j][e]"),),
     False),
    ("no fragment loads", (
        ("// d += a . b", _FAKE_LDSM), ("ldsm_x4(qa[mt],", "ldsm_fake(qa[mt],"),
        ("ldsm_x4(kf,", "ldsm_fake(kf,"),
        ("ldsm_x4_trans(vf,", "ldsm_fake(vf,")), False),
    ("no tile loads", (_NO_LOADS,), False),
    ("no tile compute", (_TILE + (_KEEP,),), False),
    ("no tile compute, no tile loads", (_TILE + (_KEEP,), _NO_LOADS), False),
    ("no rescale", (("""        o[mt][n][0] *= corr[2 * mt];
        o[mt][n][1] *= corr[2 * mt];
        o[mt][n][2] *= corr[2 * mt + 1];
        o[mt][n][3] *= corr[2 * mt + 1];""", ""),), False),
    ("expf", (
        ("exp2_approx(fmaf(s[mt][j][e], LOG2E, -ml[r]))",
         "expf(__fsub_rn(s[mt][j][e], m[r]))"),
        ("exp2_approx(fmaf(m[r], LOG2E, -ml[r]))",
         "expf(__fsub_rn(m[r], mx[r]))")), True),
    ("ring of 3", (("constexpr int STAGES = 2;",
                    "constexpr int STAGES = 3;"),), True),
    ("64-key tiles", (("constexpr int BK = 32;",
                       "constexpr int BK = 64;"),), True),
)
SHAPES = ((8, 128), (8, 1024))


def build(tmp: Path) -> dict:
    """{variant: shared library}; every nvcc runs at once."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    text = SRC.read_text()
    procs = {}
    for i, (name, reps, _) in enumerate(VARIANTS):
        src = text
        for *pats, new in reps:
            for pat in pats:
                if pat not in src:
                    raise SystemExit(f"flash_ablate: '{name}' no longer "
                                     f"matches the source: "
                                     f"{pat.splitlines()[0]!r}")
            if len(pats) == 1:
                src = src.replace(pats[0], new)
            else:
                a = src.index(pats[0]) + len(pats[0])
                src = src[:a] + new + src[src.index(pats[1], a):]
        cu = tmp / f"v{i}.cu"
        cu.write_text(src)
        procs[name] = (tmp / f"v{i}.so", subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp / f"v{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"flash_ablate: '{name}' failed to build:\n{log}")
        libs[name] = so
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("flash_ablate: no CUDA device", file=sys.stderr)
        return 1
    P = cs.import_port()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = P["get_config"]("qwen2.5-3b")
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dev = torch.device("cuda", 0)
    fa = P["fa_ops"]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        fns = {}
        for name, reps, checked in VARIANTS:
            fn = ctypes.CDLL(str(libs[name])).flash_attn_fwd_launch
            fn.argtypes = list(fa._ARGTYPES)
            fn.restype = ctypes.c_int
            fns[name] = fn
            if checked:                      # the wrapper, on this library
                fa._fn = lambda fn=fn: fn
                cs.check_flash(torch, P, cfg, dev, {})
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        for B, S in SHAPES:
            base = cs.flash_inputs(torch, gen, cfg, B, S, dev)
            sets = [base] + [cs.flash_inputs(torch, gen, cfg, B, S, dev)
                             for _ in range(cs.copies_for(
                                 cs.tensor_bytes(*base)) - 1)]
            lib = [tuple(x.transpose(1, 2) for x in st) for st in sets]
            sdpa = cs.time_ms(torch, lambda q, k, v: (
                F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True)), lib)
            for name, fn in fns.items():
                def call(q, k, v, fn=fn):
                    out = torch.empty_like(q)
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B, S, S, H, Hkv, D, S, S, 1, 0, 0,
                             D ** -0.5,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                    return out
                line = {"card": card, "variant": name, "B": B, "S": S,
                        "ms": cs.time_ms(torch, call, sets),
                        "sdpa_ms": sdpa}
                print(json.dumps(line), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(line) + "\n")
            del sets, lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
