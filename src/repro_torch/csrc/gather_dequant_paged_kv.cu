// Fused gather + dequantize of each row's block-table extent of a paged
// int8 or bf16 KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kvq_attn/kernel.py
// (gather_dequant_paged_kv / _gather_dequant_kernel):
//
//   out[r, h, t * bs + p, :] = float(pool[blk, h, p, :]) * s[blk, h, p],
//   blk = tbl[r, t] clamped to [0, NB - 1]
//
// pool (NB + 1, Hkv, bs, D) int8 (a C8 cache) or bf16 (C16), the last
// block a write sink that is never read; s (NB + 1, Hkv, bs) f32; tbl
// (n, T) int32, entries >= NB are unallocated sentinels; out (n, Hkv, T * bs, D) f32. The result is
// bitwise equal to the plain two-gather version: one f32 multiply per
// element, done with __fmul_rn so no contraction can move a bit.
//
// What bounds it on the H100: bytes. It reads D int8 values and one f32
// scale per gathered row and writes 4 * D bytes of f32, with no arithmetic
// worth counting; the f32 write is 4x the int8 read and decides the time.
//
// Design: the TPU kernel runs one grid step per (row, head, table entry)
// and DMAs a whole (bs, D) tile. Here a CTA of 128 threads owns a part of
// such a tile: `rows` = 128 / (D * ES / 16) token rows (16 at D 128 in
// int8, ES the element bytes), so the
// serve phase's tail-wave (n 4, T 8, bs 64, Hkv 2: 64 tiles) runs 256 CTAs,
// about two a SM. The block index gives (r, h, t, part) by 32-bit
// division once per CTA; one thread loads and clamps the table entry and
// hands it over in shared memory; then each thread makes 16-byte loads of
// 16 int8 (or 8 bf16) values and a scale per token row and writes four
// (two) float4, with
// neighbouring threads on neighbouring addresses on both sides. No 64-bit
// division or modulo is left and no int8 intermediate is written. Plain
// stores: the output is read next by the layer's window attention, so it
// is left in L2 (streaming stores read no faster at the tail-wave once the
// output is read after, tools/scan_times.py --ablate). A launch of the
// tail-wave's size is mostly fixed cost (without its pool and scale loads
// it keeps 3.5 of its 4.1 us, ibid.), and K and V share the table, so a
// second launcher gathers both leaves in one launch (blockIdx.y picks the
// leaf).
//
// Requirements (checked by the Python wrapper): D % 16 == 0, the pool
// 16-byte aligned, every tensor contiguous; kv_bytes 1 (int8) or 2 (bf16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float byte_at(int w, int i) {
  return (float)(int8_t)(w >> (8 * i));
}

// bf16 half i (0 low, 1 high) of w as an exact f32
__device__ __forceinline__ float half_at(int w, int i) {
  const unsigned u = static_cast<unsigned>(w);
  return __uint_as_float(i ? u & 0xFFFF0000u : u << 16);
}

struct Leaf {
  const unsigned char* pool;
  const float* s;
  float* out;
};

// ES: element bytes of the pool (1 int8, 2 bf16)
template <int ES>
__global__ void __launch_bounds__(THREADS)
gather_dequant_paged_kv_kernel(Leaf a, Leaf b, const int* __restrict__ tbl,
                               int Hkv, int NB, int bs, int T, int D,
                               int parts, int rows) {
  constexpr int VALS = 16 / ES;                  // values a 16-byte chunk
  __shared__ int blk_sh;
  const Leaf leaf = blockIdx.y ? b : a;
  const unsigned char* __restrict__ pool = leaf.pool;
  const float* __restrict__ s = leaf.s;
  float* __restrict__ out = leaf.out;
  const int part = blockIdx.x % parts;
  const int tile = blockIdx.x / parts;
  const int t = tile % T;
  const int rh = tile / T;                       // r * Hkv + h
  const int h = rh % Hkv;
  if (threadIdx.x == 0)
    blk_sh = min(max(__ldg(tbl + (size_t)(rh / Hkv) * T + t), 0), NB - 1);
  __syncthreads();
  const int per_row = D / VALS;                  // 16-byte chunks a row
  const int p0 = part * rows;
  const int n = min(rows, bs - p0) * per_row;
  const size_t src = ((size_t)blk_sh * Hkv + h) * bs + p0;
  const size_t dst = ((size_t)rh * T + t) * bs + p0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int p = i / per_row, c = i - p * per_row;
    const int4 w =
        __ldg(reinterpret_cast<const int4*>(pool + (src + p) * D * ES) + c);
    const float sc = __ldg(s + src + p);
    const int words[4] = {w.x, w.y, w.z, w.w};
    float4* o = reinterpret_cast<float4*>(out + (dst + p) * D) +
                (VALS / 4) * c;
    if constexpr (ES == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = make_float4(__fmul_rn(byte_at(words[j], 0), sc),
                           __fmul_rn(byte_at(words[j], 1), sc),
                           __fmul_rn(byte_at(words[j], 2), sc),
                           __fmul_rn(byte_at(words[j], 3), sc));
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        o[j] = make_float4(__fmul_rn(half_at(words[2 * j], 0), sc),
                           __fmul_rn(half_at(words[2 * j], 1), sc),
                           __fmul_rn(half_at(words[2 * j + 1], 0), sc),
                           __fmul_rn(half_at(words[2 * j + 1], 1), sc));
    }
  }
}

int launch(Leaf a, Leaf b, int leaves, const void* tbl, int n, int Hkv,
           int NB, int bs, int T, int D, int es, void* stream) {
  if (D % 16 || D < 16 || NB < 1 || bs < 1 || T < 1 || Hkv < 1 || n < 0 ||
      (es != 1 && es != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = max(1, THREADS / (D * es / 16));
  const int parts = (bs + rows - 1) / rows;
  const long long grid = (long long)n * Hkv * T * parts;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g((unsigned)grid, leaves);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tbl);
  if (grid > 0 && es == 1)
    gather_dequant_paged_kv_kernel<1><<<g, THREADS, 0, st>>>(
        a, b, t, Hkv, NB, bs, T, D, parts, rows);
  else if (grid > 0)
    gather_dequant_paged_kv_kernel<2><<<g, THREADS, 0, st>>>(
        a, b, t, Hkv, NB, bs, T, D, parts, rows);
  return static_cast<int>(cudaGetLastError());
}

Leaf leaf(const void* pool, const void* s, void* out) {
  return {static_cast<const unsigned char*>(pool),
          static_cast<const float*>(s), static_cast<float*>(out)};
}

}  // namespace

// One leaf: pool, s and out as at the top.
// kv_bytes: the pool's element bytes (1 int8, 2 bf16).
extern "C" int gather_dequant_paged_kv_launch(const void* pool,
                                              const void* s,
                                              const void* tbl, void* out,
                                              int n, int Hkv, int NB, int bs,
                                              int T, int D, int kv_bytes,
                                              void* stream) {
  const Leaf a = leaf(pool, s, out);
  return launch(a, a, 1, tbl, n, Hkv, NB, bs, T, D, kv_bytes, stream);
}

// K and V of one layer through the same table in one launch: both pools
// (NB + 1, Hkv, bs, D), both outputs (n, Hkv, T * bs, D).
extern "C" int gather_dequant_paged_kv2_launch(
    const void* k_pool, const void* s_k, const void* v_pool, const void* s_v,
    const void* tbl, void* k_out, void* v_out, int n, int Hkv, int NB, int bs,
    int T, int D, int kv_bytes, void* stream) {
  return launch(leaf(k_pool, s_k, k_out), leaf(v_pool, s_v, v_out), 2, tbl,
                n, Hkv, NB, bs, T, D, kv_bytes, stream);
}
