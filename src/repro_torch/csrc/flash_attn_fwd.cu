// Causal / sliding-window GQA flash-attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py
// (flash_attn_fwd / _kernel). q (B, Sq, H, D), k/v (B, Skv, Hkv, D), out
// (B, Sq, H, D), all bf16 and contiguous; query head h reads KV head
// h / (H / Hkv). The TPU kernel's math, kept here:
//
//   s    = (f32(q) * scale) . f32(k)        scale = D^-0.5 rounded to f32
//   s    = masked ? -1e30 : s               mask: q row >= s_q, key >= s_kv,
//                                           causal key > row, window
//                                           row - key >= window
//   online softmax over key tiles: m = max(m, max s), p = masked ? 0 :
//   exp(s - m), l = l * exp(m_old - m) + sum p, acc = acc * exp(m_old - m)
//   + bf16(p) . f32(v)
//   out  = bf16(acc / max(l, 1e-20))
//
// Scores and products are f32 FMAs (no tensor cores in this first
// kernel); P is rounded to bf16 before P.V as in the reference, and since
// v is bf16 each product is exact in f32. The result differs from the
// plain version only by the order of the f32 sums, within one bf16 ulp.
//
// What bounds it on the H100: operations. At the training shapes (S 128 to
// 1024, D 128) a (64 x 64) tile pair does 2 * 64 * 64 * 128 multiply-adds
// against 32 KB of K/V read from memory (or L2), ~64 f32 operations per
// byte, above the card's f32 ridge (67 TF/s over 3.35 TB/s, ~20), so the
// f32 pipe is the limit; the tensor-core rate (bf16 wgmma) is a later
// kernel's.
//
// Design: one block of 8 warps per (64-query tile, head, batch row). The
// TPU kernel's sequential kv grid axis becomes a loop inside the block.
// The block holds the pre-scaled Q tile, one K tile (rows padded by one
// float so that 32 lanes reading 32 different keys hit 32 banks) and one V
// tile in shared memory as f32. Each warp owns 8 query rows: a lane
// computes the scores of keys lane and lane + 32 for all 8 rows, the warp
// reduces each row's max and sum with shuffles, stages bf16-rounded
// probabilities in shared memory, and then each lane accumulates D / 32
// output columns of the 8 rows. Key tiles that the causal or window mask
// removes entirely are skipped (they would add exactly nothing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;        // query rows per warp
constexpr float NEG = -1e30f;

template <int D>
struct Smem {
  float q[BQ][D];
  float k[BK][D + 1];
  float v[BK][D];
  float p[WARPS][RPW][BK];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 of one 16-byte load -> f32
__device__ __forceinline__ void unpack8(const uint4 w, float* o) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(words[i] << 16);
    o[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                      int Hkv, int s_q, int s_kv, int causal, int window,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  constexpr int CH = D / 8;                 // 16-byte chunks per row
  constexpr int DL = D / 32;                // output columns per lane
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int q0 = qt * BQ;

  // pre-scaled Q tile (rows past s_q are zero and never written out)
  for (int c = threadIdx.x; c < BQ * CH; c += THREADS) {
    const int r = c / CH, d0 = (c % CH) * 8;
    float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (q0 + r < s_q) {
      const size_t off = (((size_t)b * Sq + q0 + r) * H + h) * D + d0;
      unpack8(*reinterpret_cast<const uint4*>(q + off), f);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm.q[r][d0 + i] = __fmul_rn(f[i], scale);
  }

  float m[RPW], l[RPW], acc[RPW][DL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[r][t] = 0.0f;
  }

  // key tiles that can hold an unmasked key for some row of this block
  const int q_last = min(q0 + BQ, s_q) - 1;
  int k_end = s_kv;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 - window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                        // previous tile fully consumed
    for (int c = threadIdx.x; c < BK * CH; c += THREADS) {
      const int r = c / CH, d0 = (c % CH) * 8;
      float fk[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      float fv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (k0 + r < s_kv) {
        const size_t off = (((size_t)b * Skv + k0 + r) * Hkv + hk) * D + d0;
        unpack8(*reinterpret_cast<const uint4*>(k + off), fk);
        unpack8(*reinterpret_cast<const uint4*>(v + off), fv);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sm.k[r][d0 + i] = fk[i];
        sm.v[r][d0 + i] = fv[i];
      }
    }
    __syncthreads();

    // scores of keys lane and lane + 32 for this warp's rows
    float s[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      float ka[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = sm.k[lane][d + i];
        kb[i] = sm.k[lane + 32][d + i];
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sm.q[warp * RPW + r][d]);
        s[r][0] = fmaf(qv.x, ka[0], s[r][0]);
        s[r][0] = fmaf(qv.y, ka[1], s[r][0]);
        s[r][0] = fmaf(qv.z, ka[2], s[r][0]);
        s[r][0] = fmaf(qv.w, ka[3], s[r][0]);
        s[r][1] = fmaf(qv.x, kb[0], s[r][1]);
        s[r][1] = fmaf(qv.y, kb[1], s[r][1]);
        s[r][1] = fmaf(qv.z, kb[2], s[r][1]);
        s[r][1] = fmaf(qv.w, kb[3], s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q0 + warp * RPW + r;
      bool ok[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        ok[j] = qpos < s_q && kpos < s_kv && (!causal || qpos >= kpos) &&
                (!window || qpos - kpos < window);
        if (!ok[j]) s[r][j] = NEG;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = ok[0] ? expf(s[r][0] - m_new) : 0.0f;
      const float p1 = ok[1] ? expf(s[r][1] - m_new) : 0.0f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DL; ++t) acc[r][t] *= corr;
      sm.p[warp][r][lane] = __bfloat162float(__float2bfloat16_rn(p0));
      sm.p[warp][r][lane + 32] = __bfloat162float(__float2bfloat16_rn(p1));
    }
    __syncwarp();

    // P.V: lane owns columns lane + 32 t
    for (int j = 0; j < BK; ++j) {
      float vv[DL];
#pragma unroll
      for (int t = 0; t < DL; ++t) vv[t] = sm.v[j][lane + 32 * t];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = sm.p[warp][r][j];
#pragma unroll
        for (int t = 0; t < DL; ++t) acc[r][t] = fmaf(pj, vv[t], acc[r][t]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qpos = q0 + warp * RPW + r;
    if (qpos >= s_q) continue;
    const float inv_den = fmaxf(l[r], 1e-20f);
    const size_t off = (((size_t)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int t = 0; t < DL; ++t)
      out[off + lane + 32 * t] =
          __float2bfloat16_rn(__fdiv_rn(acc[r][t], inv_den));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Hkv, int s_q, int s_kv, int causal,
           int window, float scale, cudaStream_t st) {
  const int smem = (int)sizeof(Smem<D>);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((unsigned)((s_q + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_attn_fwd_kernel<D><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, H, Hkv, s_q, s_kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s_q / s_kv: the true lengths (<= Sq / Skv); rows past s_q are not
// written. Requires D of 64 or 128, H % Hkv == 0 and 16-byte aligned
// pointers (checked by the Python wrapper). Returns cudaGetLastError().
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int H, int Hkv, int D, int s_q,
                                     int s_kv, int causal, int window,
                                     float scale, void* stream) {
  if (B < 0 || Hkv < 1 || H % Hkv || s_q < 0 || s_q > Sq || s_kv < 0 ||
      s_kv > Skv || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || s_q == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, out, B, Sq, Skv, H, Hkv, s_q, s_kv, causal,
                       window, scale, st);
  if (D == 64)
    return launch<64>(q, k, v, out, B, Sq, Skv, H, Hkv, s_q, s_kv, causal,
                      window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
