// One-query decode attention over a dense int8 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kvq_attn/kernel.py
// (kvq_decode_attn / _kernel):
//
//   out[b, h] = softmax_s( q[b, h] . (k_q[b, h/G, s] * s_k[b, h/G, s])
//                          / sqrt(D), s < len[b] )
//               . (v_q[b, h/G, s] * s_v[b, h/G, s])
//
// q (B, H, D) bf16; k_q / v_q (B, Hkv, S, D) int8; s_k / s_v (B, Hkv, S)
// f32 per-token scales; lengths (B) int32; out (B, H, D) bf16; G = H / Hkv.
//
// What bounds it on the H100: bytes. Each cached token is read once as
// 2 * D int8 values plus two f32 scales and feeds 4 * D * G flops, far
// below the card's flop-to-byte ratio, so the int8 cache read at
// 3.35 TB/s is the floor. At serving sizes (a few slots, a few hundred
// cached tokens) the read is small and latency decides: the design keeps
// every warp independent so many row loads are in flight at once.
//
// Design: the TPU grid (B, H, S/512) re-reads every K/V tile once per
// query head. Here one block owns one (slot, KV head) and serves the
// whole GQA group of G query heads, so each int8 K/V row leaves device
// memory once. The block's WARPS warps split the cached tokens (warp w
// takes s = w, w + WARPS, ...) and never synchronise inside the loop:
// within a warp each lane owns DL = D / 32 head dimensions, reads them
// from the K and V rows as one 2- or 4-byte load (the warp reads a row
// contiguously), dequantizes on chip, and keeps the G pre-scaled queries
// and its own online-softmax state (running max and denominator per head,
// the P.V accumulator per head and dimension) in registers, all in f32.
// Scores need one warp reduction per head. At the end the warps' states
// merge through shared memory (max, rescale, sum) and the denominator is
// clamped at 1e-20 as in the reference, so an empty row returns zeros.
// No dequantized K/V copy is written to device memory.
//
// Requirements (checked by the Python wrapper): D == 64 or D == 128,
// G <= 8, every tensor contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int GM = 8;                    // largest GQA group held on chip
constexpr float NEG = -1e30f;

template <int DL>
__device__ __forceinline__ void load_row(const int8_t* p, float (&x)[DL]) {
  if constexpr (DL == 4) {
    const int w = *reinterpret_cast<const int*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = (float)(int8_t)(w >> (8 * i));
  } else {
    const short w = *reinterpret_cast<const short*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) x[i] = (float)(int8_t)(w >> (8 * i));
  }
}

// DL: head dimensions per lane (D / 32)
template <int DL>
__global__ void __launch_bounds__(THREADS)
kvq_decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                       const int8_t* __restrict__ k,
                       const int8_t* __restrict__ v,
                       const float* __restrict__ sk,
                       const float* __restrict__ sv,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out,
                       int H, int Hkv, int S, float scale) {
  constexpr int D = 32 * DL;
  __shared__ float m_s[WARPS][GM];
  __shared__ float l_s[WARPS][GM];
  __shared__ float acc_s[WARPS][GM][D];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t qrow = (size_t)b * H + (size_t)kh * G;      // first q head
  const size_t base = ((size_t)b * Hkv + kh) * S;          // first token
  const int len = max(0, min(lengths[b], S));

  float qv[GM][DL], m[GM], l[GM], acc[GM][DL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      acc[g][i] = 0.f;
      qv[g][i] = g < G ? __bfloat162float(
                             q[(qrow + g) * D + lane * DL + i]) * scale
                       : 0.f;
    }
  }

#pragma unroll 2
  for (int s = warp; s < len; s += WARPS) {
    float kx[DL], vx[DL];
    load_row<DL>(k + (base + s) * D + lane * DL, kx);
    load_row<DL>(v + (base + s) * D + lane * DL, vx);
    const float ks = sk[base + s];
    const float vs = sv[base + s];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) sc = fmaf(qv[g][i], kx[i], sc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sc += __shfl_xor_sync(0xFFFFFFFFu, sc, off);
        sc *= ks;
        const float m_new = fmaxf(m[g], sc);
        const float corr = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        m[g] = m_new;
        l[g] = l[g] * corr + p;
        const float pv = p * vs;
#pragma unroll
        for (int i = 0; i < DL; ++i)
          acc[g][i] = fmaf(pv, vx[i], acc[g][i] * corr);
      }
    }
  }

  // merge the warps' online-softmax states
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) acc_s[warp][g][lane * DL + i] = acc[g][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D;
    const int d = e % D;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(m_s[w][g] - mx);
      den = fmaf(l_s[w][g], c, den);
      num = fmaf(acc_s[w][g][d], c, num);
    }
    out[(qrow + g) * D + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-20f));
  }
}

template <int DL>
void launch(const dim3& grid, cudaStream_t stream, const void* q,
            const void* k, const void* v, const void* sk, const void* sv,
            const void* lengths, void* out, int H, int Hkv, int S,
            float scale) {
  kvq_decode_attn_kernel<DL><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), H, Hkv, S, scale);
}

}  // namespace

extern "C" int kvq_decode_attn_launch(const void* q, const void* k,
                                      const void* v, const void* sk,
                                      const void* sv, const void* lengths,
                                      void* out, int B, int H, int Hkv, int S,
                                      int D, float scale, void* stream) {
  const int G = Hkv > 0 ? H / Hkv : 0;
  if (G < 1 || G > GM || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const dim3 grid(B, Hkv);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 128)
      launch<4>(grid, st, q, k, v, sk, sv, lengths, out, H, Hkv, S, scale);
    else
      launch<2>(grid, st, q, k, v, sk, sv, lengths, out, H, Hkv, S, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
