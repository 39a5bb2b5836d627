// Fused gather + dequantize of each row's block-table extent of a paged
// int8 KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kvq_attn/kernel.py
// (gather_dequant_paged_kv / _gather_dequant_kernel):
//
//   out[r, h, t * bs + p, :] = float(pool[blk, h, p, :]) * s[blk, h, p],
//   blk = tbl[r, t] clamped to [0, NB - 1]
//
// pool (NB + 1, Hkv, bs, D) int8, the last block a write sink that is never
// read; s (NB + 1, Hkv, bs) f32; tbl (n, T) int32, entries >= NB are
// unallocated sentinels; out (n, Hkv, T * bs, D) f32. The result is
// bitwise equal to the plain two-gather version: one f32 multiply per
// element, done with __fmul_rn so no contraction can move a bit.
//
// What bounds it on the H100: bytes. It reads D int8 values and one f32
// scale per gathered row and writes 4 * D bytes of f32, with no arithmetic
// worth counting; the f32 write is 4x the int8 read and decides the time.
//
// Design: the TPU kernel runs one grid step per (row, head, table entry)
// and DMAs a whole (bs, D) tile. Here the grid runs over the output's
// (n, Hkv, T * bs) rows with D / 16 threads per row: each thread makes one
// 16-byte load of 16 int8 values, clamps its table entry before forming
// the address, and writes four float4, so neighbouring threads touch
// neighbouring addresses on both sides. No int8 intermediate is written.
//
// Requirements (checked by the Python wrapper): D % 16 == 0, the pool
// 16-byte aligned, every tensor contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float byte_at(int w, int i) {
  return (float)(int8_t)(w >> (8 * i));
}

__global__ void __launch_bounds__(THREADS)
gather_dequant_paged_kv_kernel(const int8_t* __restrict__ pool,
                               const float* __restrict__ s,
                               const int* __restrict__ tbl,
                               float* __restrict__ out, long long n_chunks,
                               int Hkv, int NB, int bs, int T, int D) {
  const int per_row = D / 16;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < n_chunks; i += (long long)gridDim.x * THREADS) {
    const long long row = i / per_row;            // (r, h, t, p) flattened
    const int c = (int)(i % per_row);
    const int p = (int)(row % bs);
    const long long rt = row / bs;
    const int t = (int)(rt % T);
    const long long rh = rt / T;
    const int h = (int)(rh % Hkv);
    const long long r = rh / Hkv;
    const int blk = min(max(tbl[r * T + t], 0), NB - 1);
    const size_t tok = ((size_t)blk * Hkv + h) * bs + p;
    const int4 w = *reinterpret_cast<const int4*>(pool + tok * D + c * 16);
    const float sc = s[tok];
    const int words[4] = {w.x, w.y, w.z, w.w};
    float4* dst = reinterpret_cast<float4*>(out + row * D + c * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[j] = make_float4(__fmul_rn(byte_at(words[j], 0), sc),
                           __fmul_rn(byte_at(words[j], 1), sc),
                           __fmul_rn(byte_at(words[j], 2), sc),
                           __fmul_rn(byte_at(words[j], 3), sc));
    }
  }
}

}  // namespace

extern "C" int gather_dequant_paged_kv_launch(const void* pool,
                                              const void* s,
                                              const void* tbl, void* out,
                                              int n, int Hkv, int NB, int bs,
                                              int T, int D, void* stream) {
  if (D % 16 || D < 16 || NB < 1 || bs < 1 || T < 1 || Hkv < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_chunks = (long long)n * Hkv * T * bs * (D / 16);
  if (n_chunks > 0) {
    const long long want = (n_chunks + THREADS - 1) / THREADS;
    const int grid = (int)(want < 65535LL * 16 ? want : 65535LL * 16);
    gather_dequant_paged_kv_kernel<<<grid, THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(pool), static_cast<const float*>(s),
        static_cast<const int*>(tbl), static_cast<float*>(out), n_chunks,
        Hkv, NB, bs, T, D);
  }
  return static_cast<int>(cudaGetLastError());
}
