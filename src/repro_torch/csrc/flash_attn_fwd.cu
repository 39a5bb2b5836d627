// Causal / sliding-window GQA flash-attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py
// (flash_attn_fwd / _kernel). q (B, Sq, H, D), k/v (B, Skv, Hkv, D), out
// (B, Sq, H, D), all bf16 and contiguous; query head h reads KV head
// h / (H / Hkv). The TPU kernel's math, kept here:
//
//   s    = (q . k) * scale                  scale = D^-0.5 rounded to f32
//   s    = masked ? -1e30 : s               mask: q row >= s_q, key >= s_kv,
//                                           causal key > pos, window
//                                           pos - key >= window, where
//                                           pos = q_off + row (a rank's
//                                           query rows at their global
//                                           positions; 0 elsewhere)
//   online softmax over key tiles: m = max(m, max s), p = masked ? 0 :
//   exp(s - m), l = l * exp(m_old - m) + sum p, acc = acc * exp(m_old - m)
//   + bf16(p) . v
//   out  = bf16(acc / max(l, 1e-20))
//
// Both products run on the tensor cores: mma.sync m16n8k16, bf16 x bf16
// with f32 accumulators. QK^T takes the raw bf16 q and k (each product is
// exact in f32) and the summed score is multiplied by scale once
// (__fmul_rn), where the plain version pre-scales q in f32. exp(s - m) is
// 2^(s log2 e - m log2 e), one FMA and MUFU.EX2 (the correction is exactly
// 1 where the max did not move); P is rounded to bf16 in registers, as the
// plain version rounds it before P.V, and v is bf16, so those products are
// exact too; the division is a multiply by the correctly rounded
// reciprocal. What moves the bf16 output against the plain version is
// mostly the online softmax itself: a probability rounded to bf16 under a
// running max that a later tile raises is not the one the plain version
// rounds under the row's final max, so narrower key tiles put more outputs
// beyond one ulp (measured on the H100: 2.3-3.1% at 32 keys a tile, 1.0-
// 2.3% at 64; chip_smoke.py allows 5%). The exponential's accuracy did not
// move that share (expf and the EX2 form read the same).
//
// What bounds it on the H100: on paper bytes at S 128 (a launch reads and
// writes 9.4 MB, 2.8 us at 3.35 TB/s, against 0.55 us of bf16 MMA at 989
// TF/s), the MMAs from about S 600 (at S 1024, 34.4 GFLOP: 34.8 us). In
// this design neither (tools/flash_ablate.py): at B 8, S 1024 taking out
// the MMAs left the time as it was, and taking out the exponentials, the
// fragment loads, the tile loads or the rescale of the accumulators each
// saved a few percent; the K/V tile loads and barriers alone take about a
// quarter of it, and the tile compute hides about 60% of that. Each warp
// walks one dependent chain a tile (cp.async wait, barrier, ldmatrix,
// MMA, max and shuffles, exp, pack, MMA, barrier), and at 255 registers a
// thread only 8 warps fit an SM, too few to hide it. A deeper cp.async
// ring reads the same; K/V rows by bulk copies on mbarriers, and a wgmma
// version of this loop (no swizzle, MMA and softmax in series), were
// tried and read slower (not kept). Overlapping one tile's softmax with
// the next tile's wgmma, in producer and consumer warpgroups, is what the
// library kernels do.
//
// Design: one CTA of 4 warps per (128-query tile, head, batch row), the
// tiles with the most causal keys first (at D 256 a 64-query tile: see
// below). The TPU kernel's sequential kv
// grid axis becomes a loop inside the CTA. Q and each 32-key K and V tile
// sit in shared memory as bf16, rows padded by 16 bytes so the 8 rows an
// ldmatrix phase reads fall in 8 distinct 4-bank groups; K/V tiles are
// staged by 16-byte cp.async into a ring of STAGES (2) buffers, the next
// tile's copy in flight while this tile's MMAs run (70 KB a CTA at D 128;
// the registers allow two CTAs an SM). Each warp owns 32 query rows,
// two m16 tiles, so every K and V fragment it loads feeds two MMAs: S =
// Q K^T is 4 n-tiles of m16n8k16 a row tile over D / 16 k-steps (Q and K
// by ldmatrix; K's rows are keys, the col-major B operand as it lies), the
// row max and sum are reduced across the 4 lanes that share a row (two
// shuffles), and the S accumulator fragments, exponentiated and packed to
// bf16 pairs, are P's A fragments for P.V directly; V is the B operand by
// ldmatrix.trans. mma.sync and not wgmma: a warp's 16-row fragments hand P
// from the first product to the second in registers in the documented
// layout, with no shared-memory descriptors; wgmma's rate is a later
// kernel's. Key tiles that the causal or window mask removes entirely are
// skipped (they would add exactly nothing), and the mask is evaluated only
// on tiles it cuts. The output goes through the warp's own rows of the Q
// tile to 16-byte stores.
//
// Head dims. D 16 (the reduced configs) is one k-step of QK^T and two
// n-tiles of P.V, with the same loop. D 256 (recurrentgemma-2b) cannot
// keep 32 rows a warp: the O accumulator alone would be 256 f32 registers
// a thread. There a warp owns one m16 tile (MT 1, a 64-query CTA): O is
// 128 registers, Q and the K/V ring take 101 KB a CTA, two CTAs an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;                 // keys a tile
constexpr int STAGES = 2;              // K/V tiles in the cp.async ring
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// 16-row MMA tiles a warp, and the query rows a CTA, at head dim D
template <int D>
__host__ __device__ constexpr int mt_of() { return D >= 256 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int bq_of() { return 16 * mt_of<D>() * WARPS; }
constexpr int NJ = BK / 8;             // 8-key n-tiles of a score tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(NJ * 4 <= 32, "a lane's mask bits of one m-tile fit a word");

// bf16 row stride of a shared-memory tile: D plus 16 bytes of padding
template <int D>
__host__ __device__ constexpr int ld() { return D + 8; }

// Q, then STAGES K and STAGES V tiles
template <int D>
constexpr int smem_bytes() {
  return (bq_of<D>() + 2 * STAGES * BK) * ld<D>() * 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with ok false the 16 bytes are zero-filled and
// nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b: a 16 x 16 (row), b 16 x 8 (col), bf16; d 16 x 8 f32
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2; -inf-like arguments give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to bf16, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// rows [0, R) of a bf16 matrix with row stride `stride` into a padded
// shared tile; rows >= n are zero (finite: a masked key's p is 0, and
// 0 * v must stay 0)
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int n) {
  constexpr int CH = D / 8;                 // 16-byte chunks a row
  static_assert(R * CH % THREADS == 0 || R * CH < THREADS,
                "whole chunks a thread");
#pragma unroll
  for (int u = 0; u < (R * CH + THREADS - 1) / THREADS; ++u) {
    const int c = threadIdx.x + THREADS * u;
    if (R * CH < THREADS && c >= R * CH) break;
    const int r = c / CH, cc = c % CH;
    const bool ok = r < n;
    cp_async16(dst + r * ld<D>() + 8 * cc,
               src + (size_t)(ok ? r : 0) * stride + 8 * cc, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                      int Hkv, int s_q, int s_kv, int causal, int window,
                      int q_off, float scale) {
  constexpr int LD = ld<D>();
  constexpr int MT = mt_of<D>();
  constexpr int BQ = bq_of<D>();
  constexpr int KS = D / 16;                // k-steps of QK^T
  constexpr int NT = D / 8;                 // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BQ * LD;       // [STAGES][BK][LD]
  __nv_bfloat16* v_s = k_s + STAGES * BK * LD;   // [STAGES][BK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;   // most causal keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;    // fragment row, column pair
  const int q0 = qt * BQ;
  const int wq = 16 * MT * warp;            // this warp's first row
  // this lane's rows: q0 + wq + 16 mt + 8 i + g, index 2 mt + i
  const size_t kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  // key tiles that can hold an unmasked key for some row of this CTA
  // (rows at positions q_off + row)
  const int q_last = q_off + min(q0 + BQ, s_q) - 1;
  int k_end = s_kv;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window) k_begin = max(0, q_off + q0 - window + 1) / BK * BK;

  // K/V tile i goes to buffer i % STAGES in commit group i (Q joins
  // group 0); the first STAGES - 1 tiles are put in flight here
  auto load_kv = [&](int i) {
    const int t0 = k_begin + i * BK;
    if (t0 < k_end) {
      const int st = i % STAGES;
      load_tile<D, BK>(k_s + st * BK * LD, kb + (size_t)t0 * kv_stride,
                       kv_stride, s_kv - t0);
      load_tile<D, BK>(v_s + st * BK * LD, vb + (size_t)t0 * kv_stride,
                       kv_stride, s_kv - t0);
    }
    cp_async_commit();                      // empty past the last tile
  };
  load_tile<D, BQ>(q_s, q + (((size_t)b * Sq + q0) * H + h) * D,
                   (size_t)H * D, s_q - q0);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_kv(i);

  float o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  float m[2 * MT], l[2 * MT];               // l: this lane's part of the sum
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
  }

  for (int it = 0, k0 = k_begin; k0 < k_end; ++it, k0 += BK) {
    const int kn = k0 + BK;
    load_kv(it + STAGES - 1);               // into the buffer freed last
    cp_async_wait<STAGES - 1>();            // tile it (and Q) landed
    __syncthreads();
    const __nv_bfloat16* ks = k_s + (it % STAGES) * BK * LD;
    const __nv_bfloat16* vs = v_s + (it % STAGES) * BK * LD;

    // does the mask cut this tile for some row of the CTA (else no mask
    // is evaluated)
    const bool cut = kn > s_kv || q0 + BQ > s_q ||
                     (causal && kn - 1 > q_off + q0) ||
                     (window && q_off + q0 + BQ - 1 - k0 >= window);

    // S = Q K^T: n-tile j holds keys k0 + 8 j .. + 7; each K fragment
    // feeds both m-tiles
    float s[MT][NJ][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(qa[mt], q_s + (wq + 16 * mt + (lane & 15)) * LD + 16 * kk +
                            8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j) {
        unsigned kf[4];
        ldsm_x4(kf, ks + (16 * j + (lane & 7) + 8 * (lane >> 4)) * LD +
                        16 * kk + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * j], qa[mt], kf[0], kf[1]);
          mma(s[mt][2 * j + 1], qa[mt], kf[2], kf[3]);
        }
      }
    }

    // scale, mask (only where the tile is cut), row max over the 4 lanes
    unsigned okb[MT];                       // bit 4 j + e: element unmasked
    float mx[2 * MT];
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) mx[r] = m[r];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      okb[mt] = FULL;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[mt][j][e], scale);
          if (cut) {
            const int row = q0 + wq + 16 * mt + 8 * (e >> 1) + g;
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int pos = q_off + row;
            const bool ok = row < s_q && key < s_kv &&
                            (!causal || pos >= key) &&
                            (!window || pos - key < window);
            if (!ok) {
              x = NEG;
              okb[mt] &= ~(1u << (4 * j + e));
            }
          }
          s[mt][j][e] = x;
          mx[2 * mt + (e >> 1)] = fmaxf(mx[2 * mt + (e >> 1)], x);
        }
    }
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    }
    // exp(x - m) as 2^(x log2 e - m log2 e), one FMA and MUFU.EX2; the
    // correction is exactly 1 where the max did not move (also while it
    // is still -1e30, where the FMA would not cancel)
    float corr[2 * MT], ml[2 * MT];
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) {
      ml[r] = mx[r] * LOG2E;
      corr[r] = m[r] == mx[r] ? 1.f : exp2_approx(fmaf(m[r], LOG2E, -ml[r]));
      m[r] = mx[r];
    }

    // P = exp(S - m), rounded to bf16 pairs: the A fragments of P.V
    // (k-step kk: keys 16 kk .. + 15, n-tiles 2 kk and 2 kk + 1)
    unsigned pa[MT][NJ / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * mt + (e >> 1);
          p[e] = (okb[mt] >> (4 * j + e)) & 1u
                     ? exp2_approx(fmaf(s[mt][j][e], LOG2E, -ml[r]))
                     : 0.f;
          rs[e >> 1] += p[e];
        }
        pa[mt][j >> 1][2 * (j & 1)] = pack_bf16(p[0], p[1]);      // row g
        pa[mt][j >> 1][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);  // g + 8
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l[2 * mt + i] = fmaf(l[2 * mt + i], corr[2 * mt + i], rs[i]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[mt][n][0] *= corr[2 * mt];
        o[mt][n][1] *= corr[2 * mt];
        o[mt][n][2] *= corr[2 * mt + 1];
        o[mt][n][3] *= corr[2 * mt + 1];
      }
    }

    // O += P V: V rows are keys, the row-major B operand, by .trans; each
    // V fragment feeds both m-tiles
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        unsigned vf[4];
        ldsm_x4_trans(vf, vs + (16 * kk + (lane & 7) +
                                8 * ((lane >> 3) & 1)) * LD +
                              16 * j + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * j], pa[mt][kk], vf[0], vf[1]);
          mma(o[mt][2 * j + 1], pa[mt][kk], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                        // the buffer is free again
  }
  cp_async_wait<0>();                       // Q's group when no tile ran:
  __syncthreads();                          // every lane's copies landed

  // out = acc / max(l, 1e-20) (times the correctly rounded reciprocal),
  // through this warp's rows of the Q tile to 16-byte stores
  constexpr int CH = D / 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    __nv_bfloat16* stage_o = q_s + (wq + 16 * mt) * LD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float den = l[2 * mt + i];
      den += __shfl_xor_sync(FULL, den, 1);
      den += __shfl_xor_sync(FULL, den, 2);
      const float inv = __frcp_rn(fmaxf(den, 1e-20f));
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(stage_o + (8 * i + g) * LD +
                                           8 * n + 2 * t) =
            __floats2bfloat162_rn(__fmul_rn(o[mt][n][2 * i], inv),
                                  __fmul_rn(o[mt][n][2 * i + 1], inv));
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 16 * CH / 32; ++u) {
      const int c = lane + 32 * u;
      const int r = c / CH, cc = c % CH;
      const int row = q0 + wq + 16 * mt + r;
      if (row < s_q)
        *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + row) * H + h) *
                                            D + 8 * cc) =
            *reinterpret_cast<const uint4*>(stage_o + r * LD + 8 * cc);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Hkv, int s_q, int s_kv, int causal,
           int window, int q_off, float scale, cudaStream_t st) {
  constexpr int smem = smem_bytes<D>();
  // raised once, so a call inside a stream capture sets nothing
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  constexpr int BQ = bq_of<D>();
  dim3 grid((unsigned)((s_q + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_attn_fwd_kernel<D><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, H, Hkv, s_q, s_kv, causal, window, q_off, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s_q / s_kv: the true lengths (<= Sq / Skv); rows past s_q are not
// written. q_off >= 0: query row r sits at position q_off + r of the
// keys' sequence for the causal and window masks (a rank's rows under
// sequence-parallel attention). Requires D of 16, 64, 128 or 256, H % Hkv == 0 and 16-byte
// aligned pointers (checked by the Python wrapper). Returns
// cudaGetLastError().
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int H, int Hkv, int D, int s_q,
                                     int s_kv, int causal, int window,
                                     int q_off, float scale, void* stream) {
  if (B < 0 || Hkv < 1 || H % Hkv || s_q < 0 || s_q > Sq || s_kv < 0 ||
      s_kv > Skv || window < 0 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || s_q == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, out, B, Sq, Skv, H, Hkv, s_q, s_kv, causal,
                       window, q_off, scale, st);
  if (D == 64)
    return launch<64>(q, k, v, out, B, Sq, Skv, H, Hkv, s_q, s_kv, causal,
                      window, q_off, scale, st);
  if (D == 256)
    return launch<256>(q, k, v, out, B, Sq, Skv, H, Hkv, s_q, s_kv, causal,
                       window, q_off, scale, st);
  if (D == 16)
    return launch<16>(q, k, v, out, B, Sq, Skv, H, Hkv, s_q, s_kv, causal,
                      window, q_off, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
