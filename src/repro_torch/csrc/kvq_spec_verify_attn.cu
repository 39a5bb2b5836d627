// Multi-query attention through a block table over a paged int8 KV pool,
// for the speculative verify-wave, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kvq_attn/kernel.py
// (kvq_spec_verify_attn / _spec_verify_kernel):
//
//   blk(b, p) = tbl[b, p / bs] clamped to [0, NB - 1],  row(p) = p % bs
//   out[b, c, h] = softmax_p( q[b, c, h] . (k[blk, h/G, row] *
//                  s_k[blk, h/G, row]) / sqrt(D), p < len[b, c] )
//                  . (v[blk, h/G, row] * s_v[blk, h/G, row])
//
// q (B, C, H, D) bf16: the C = k + 1 window queries of each slot, whose
// K/V the verify-wave has already committed to the pool; k / v pools
// (NB + 1, Hkv, bs, D) int8, the last block a write sink that is never
// read; s_k / s_v (NB + 1, Hkv, bs) f32 per-token scales; tbl (B, T) int32
// block ids, entries >= NB are unallocated sentinels; lengths (B, C) int32
// per-query extents (history + the window through the query itself);
// out (B, C, H, D) bf16; G = H / Hkv.
//
// The property the engine's exact mode rests on: query c's output is
// bitwise equal to what kvq_paged_decode_attn.cu returns for that query
// at lengths[:, c], so a verified stream equals plain decode. It holds
// because each CTA here runs that kernel's code for one query: the same
// token striding (warp w takes p = w, w + 8, ...), the same dim split
// (each lane owns D / 32 dims), the same shuffle order and the same merge
// of the warps. Only the grid and the q / out / lengths addressing differ.
//
// Design: grid (B, Hkv, C), one CTA per (slot, KV head, query) serving the
// whole GQA group. Holding all C queries of a CTA at once would need
// C * G pre-scaled queries and accumulators of D / 32 floats per lane
// (5 * 8 * 4 * 2 = 320 at C = 5), past the 255 registers a thread has;
// one query per CTA keeps the paged kernel's 80. The C CTAs of a slot
// re-read its blocks, from L2 after the first: walking the table once for
// all C queries, the TPU kernel's point, is left to a later version.
// Sentinels are clamped to NB - 1 in shared memory before any address is
// formed; a query of length 0 (a parked slot) returns zeros through the
// 1e-20 denominator clamp, never NaN.
//
// Requirements (checked by the Python wrapper): D == 64 or D == 128,
// G <= 8, bs >= 1, every tensor contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int GM = 8;                    // largest GQA group held on chip
constexpr int TBL_CHUNK = 512;           // table entries staged at a time
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
kvq_spec_verify_attn_kernel(const __nv_bfloat16* __restrict__ q,
                            const int8_t* __restrict__ k,
                            const int8_t* __restrict__ v,
                            const float* __restrict__ sk,
                            const float* __restrict__ sv,
                            const int* __restrict__ tbl,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out,
                            int C, int H, int Hkv, int NB, int bs, int T,
                            float scale) {
  constexpr int D = 32 * DL;
  __shared__ int tbl_s[TBL_CHUNK];
  __shared__ float m_s[WARPS][GM];
  __shared__ float l_s[WARPS][GM];
  __shared__ float acc_s[WARPS][GM][D];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int c = blockIdx.z;
  const int G = H / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t bc = (size_t)b * C + c;                    // (slot, query)
  const size_t qrow = bc * H + (size_t)kh * G;            // first q head
  const long long cap = (long long)T * bs;
  const int len = (int)max(0LL, min((long long)lengths[bc], cap));

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

  const int n_tbl = (len + bs - 1) / bs;          // table entries in use
  for (int t0 = 0; t0 < n_tbl; t0 += TBL_CHUNK) {
    const int nt = min(TBL_CHUNK, n_tbl - t0);
    __syncthreads();                              // previous chunk consumed
    for (int i = threadIdx.x; i < nt; i += THREADS) {
      const int e = tbl[(size_t)b * T + t0 + i];
      tbl_s[i] = min(max(e, 0), NB - 1);          // sentinel -> NB - 1
    }
    __syncthreads();
    const int p_lo = t0 * bs;
    const int p_hi = min(len, (t0 + nt) * bs);
#pragma unroll 2
    for (int p = p_lo + warp; p < p_hi; p += WARPS) {
      const int blk = tbl_s[p / bs - t0];
      const size_t tok = ((size_t)blk * Hkv + kh) * bs + (p % bs);
      float kx[DL], vx[DL];
      load_row<DL>(k + tok * D + lane * DL, kx);
      load_row<DL>(v + tok * D + lane * DL, vx);
      const float ks = sk[tok];
      const float vs = sv[tok];
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
          const float pr = expf(sc - m_new);
          m[g] = m_new;
          l[g] = l[g] * corr + pr;
          const float pv = pr * vs;
#pragma unroll
          for (int i = 0; i < DL; ++i)
            acc[g][i] = fmaf(pv, vx[i], acc[g][i] * corr);
        }
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
      const float cw = expf(m_s[w][g] - mx);
      den = fmaf(l_s[w][g], cw, den);
      num = fmaf(acc_s[w][g][d], cw, num);
    }
    out[(qrow + g) * D + d] = __float2bfloat16_rn(num / fmaxf(den, 1e-20f));
  }
}

template <int DL>
void launch(const dim3& grid, cudaStream_t stream, const void* q,
            const void* k, const void* v, const void* sk, const void* sv,
            const void* tbl, const void* lengths, void* out, int C, int H,
            int Hkv, int NB, int bs, int T, float scale) {
  kvq_spec_verify_attn_kernel<DL><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(tbl),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), C,
      H, Hkv, NB, bs, T, scale);
}

}  // namespace

extern "C" int kvq_spec_verify_attn_launch(
    const void* q, const void* k, const void* v, const void* sk,
    const void* sv, const void* tbl, const void* lengths, void* out, int B,
    int C, int H, int Hkv, int NB, int bs, int T, int D, float scale,
    void* stream) {
  const int G = Hkv > 0 ? H / Hkv : 0;
  if (G < 1 || G > GM || (D != 64 && D != 128) || NB < 1 || bs < 1 ||
      T < 1 || C < 1 || C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const dim3 grid(B, Hkv, C);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 128)
      launch<4>(grid, st, q, k, v, sk, sv, tbl, lengths, out, C, H, Hkv, NB,
                bs, T, scale);
    else
      launch<2>(grid, st, q, k, v, sk, sv, tbl, lengths, out, C, H, Hkv, NB,
                bs, T, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
