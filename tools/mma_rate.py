#!/usr/bin/env python3
"""What ``mma.sync`` sustains on this card, beside what the tensor-core
route of ``csrc/w4a8_matmul.cu`` gets from it.

    python3 tools/mma_rate.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA GPU and ``nvcc``.
Builds a small CUDA source (below) with the port's ``nvcc`` flags and
times, between CUDA events, 132 x CTAs-an-SM CTAs of 8 warps:

- ``s8 m16n8k32`` and ``bf16 m16n8k16``: 16 independent accumulators a
  warp, operands held in registers (the instruction alone);
- ``s8 from shared memory``: the route's inner step, a warp's 64 x 32
  tile over 64 k with its A words and packed B words read from shared
  memory as the route reads them and the nibbles unpacked as it does, no
  global loads and no barrier.

Operations count 2 per multiply-add. Prints the card and one JSON line per
case, appended to ``--out`` if given.
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

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#define MMA_S8(d, a0, a1, a2, a3, b0, b1)                                  \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "          \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"  \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])            \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1))

__global__ void __launch_bounds__(256) s8_regs(int* out, int iters) {
  int acc[16][4] = {};
  const unsigned a = threadIdx.x, b = threadIdx.x * 7;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 16; ++c) MMA_S8(acc[c], a, a + 1, a + 2, a + 3, b, b + 1);
  int s = 0;
  for (int c = 0; c < 16; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(256) bf16_regs(float* out, int iters) {
  float acc[16][4] = {};
  const unsigned a = threadIdx.x, b = threadIdx.x * 7;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 16; ++c)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
                     "+f"(acc[c][3])
                   : "r"(a), "r"(a + 1), "r"(a + 2), "r"(a + 3), "r"(b), "r"(b + 1));
  float s = 0;
  for (int c = 0; c < 16; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// the route's step: x tile 128 x 64 bytes, packed w tile 128 x 32 bytes,
// warps 2 x 4 of 64 x 32, two slots alternating
__global__ void __launch_bounds__(256) s8_smem(int* out, int iters) {
  __shared__ __align__(16) unsigned char sm[2][128 * 64 + 128 * 32];
  for (int i = threadIdx.x; i < (int)sizeof(sm) / 4; i += 256)
    reinterpret_cast<unsigned*>(sm)[i] = i * 2654435761u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  int acc[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
    const unsigned char* xt = sm[it & 1];
    const unsigned char* wt = sm[it & 1] + 128 * 64;
    uint4 lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = *reinterpret_cast<const uint4*>(xt + (wm * 64 + i * 16 + g) * 64 + t * 16);
      hi[i] = *reinterpret_cast<const uint4*>(xt + (wm * 64 + i * 16 + g + 8) * 64 + t * 16);
    }
    int b[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 p = *reinterpret_cast<const uint2*>(wt + (wn * 32 + j * 8 + g) * 32 + t * 8);
      const unsigned l0 = (p.x << 4) & 0xF0F0F0F0u, h0 = p.x & 0xF0F0F0F0u;
      const unsigned l1 = (p.y << 4) & 0xF0F0F0F0u, h1 = p.y & 0xF0F0F0F0u;
      b[j][0] = __byte_perm(l0, h0, 0x5140); b[j][1] = __byte_perm(l0, h0, 0x7362);
      b[j][2] = __byte_perm(l1, h1, 0x5140); b[j][3] = __byte_perm(l1, h1, 0x7362);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) MMA_S8(acc[i][j], lo[i].x, hi[i].x, lo[i].y, hi[i].y, b[j][0], b[j][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) MMA_S8(acc[i][j], lo[i].z, hi[i].z, lo[i].w, hi[i].w, b[j][2], b[j][3]);
  }
  int s = 0;
  for (int i = 0; i < 4; ++i) for (int j = 0; j < 4; ++j) s += acc[i][j][0] + acc[i][j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(int kind, void* out, int blocks, int iters) {
  if (kind == 0) s8_regs<<<blocks, 256>>>((int*)out, iters);
  else if (kind == 1) bf16_regs<<<blocks, 256>>>((float*)out, iters);
  else s8_smem<<<blocks, 256>>>((int*)out, iters);
  return (int)cudaGetLastError();
}
"""

# (name, kind, multiply-adds an iteration a warp)
CASES = (("s8 m16n8k32, operands in registers", 0, 16 * 16 * 8 * 32),
         ("bf16 m16n8k16, operands in registers", 1, 16 * 16 * 8 * 16),
         ("s8 from shared memory (the route's step)", 2, 32 * 16 * 8 * 32))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "mma_rate.cu", Path(tmp) / "mma_rate.so"
        cu.write_text(SOURCE)
        subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True)
        fn = ctypes.CDLL(str(so)).run
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
        out = torch.empty(132 * 4 * 256, dtype=torch.int32, device="cuda")
        for name, kind, macs in CASES:
            for per_sm in (1, 2):
                blocks, iters = 132 * per_sm, 2000
                if fn(kind, out.data_ptr(), blocks, 10):
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                err = fn(kind, out.data_ptr(), blocks, iters)
                stop.record()
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
                ms = start.elapsed_time(stop)
                tops = 2 * macs * iters * blocks * 8 / ms / 1e9
                line = {"card": card, "case": name, "ctas_per_sm": per_sm,
                        "ms": ms, "tera_ops_per_s": tops}
                print(json.dumps(line), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
