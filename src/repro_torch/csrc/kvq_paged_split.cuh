// Split-KV (flash-decoding) attention through a block table over a paged
// int8 or bf16 KV pool, for Hopper (sm_90a). One kernel serves both the
// decode launcher (kvq_paged_decode_attn.cu, one query a slot) and the verify
// launcher (kvq_spec_verify_attn.cu, C queries a slot): C is a runtime
// argument, so both run the same compiled code. The dense decode launcher
// (kvq_decode_attn.cu) runs it with the token address as a compile-time
// policy, kDense: a dense cache (B, Hkv, S, D) is the pool of B blocks of
// bs = S tokens with the table b -> b (T = 1), so token p of slot b and
// KV head kh is row (b * Hkv + kh) * S + p, and no table is read. Only
// that address changes; every load, score, softmax, P.V, ticket and merge
// is the same code, so dense decode equals paged decode of the same K/V
// bit for bit, and the paged instantiations (kDense false) are what they
// were.
//
//   blk(b, p) = tbl[b, p / bs] clamped to [0, NB - 1],  row(p) = p % bs
//   out[b, c, h] = softmax_p( q[b, c, h] . (k[blk, h/G, row] *
//                  s_k[blk, h/G, row]) / sqrt(D), p < len[b, c] )
//                  . (v[blk, h/G, row] * s_v[blk, h/G, row])
//
// q (B, C, H, D) bf16; k / v pools (NB + 1, Hkv, bs, D) int8 (a C8
// cache) or bf16 (C16, unit scales), the last block a write sink that is
// never read; s_k / s_v (NB + 1, Hkv, bs) f32;
// tbl (B, T) int32, entries >= NB unallocated sentinels; lengths (B, C)
// int32, clamped to [0, T * bs]; out (B, C, H, D) bf16; G = H / Hkv, up
// to GMAX (10: recurrentgemma's MQA); D of 16, 64, 128 or 256.
//
// The element type is a template parameter (KV): only the staging (16-byte
// chunks of 16 int8 or 8 bf16 values) and the conversion to f32 differ,
// and both are exact, so a bf16 cache runs the int8 cache's arithmetic on
// its values. The dims a lane owns follow D: DV consecutive dims (4 from
// D 64, D / 16 below) in DG groups for the scores, D / 32 (at least 1,
// lanes past D idle) for P.V; at D 64 and 128 that is the layout the int8
// kernel always had, so those results did not move.
//
// Design.
// - Grid: one CTA per (slot, split, KV head, query chunk). A split is
//   SPLIT token positions, a compile-time constant: it depends on no
//   other slot, on neither B nor T, nor on the card, so a row's result
//   depends only on its own length. A query chunk is up to RMAX query rows
//   (QC = RMAX / G queries with their G heads): the CTA walks its split
//   once for all of them, dequantizing each token once. CTAs whose split
//   starts at or past the chunk's longest length exit at once.
// - Loads: every lane looks up its token's table entry, clamps it to
//   [0, NB - 1] before any address is formed (a sentinel or a parked
//   slot's all-sentinel row reads a real block that the length mask then
//   drops), and issues 16-byte cp.async copies of the token's int8 K and V
//   rows and 4-byte copies of its scales into shared memory. The whole
//   split is put in flight at once, as one commit group; the two CTAs
//   resident on an SM overlap each other's loads (two double-buffered
//   sub-tiles a split measured slower on the H100). At D 256 one CTA fits
//   an SM (its rows and staging take 137-227 KB).
// - Scores: S[r, j] = (q_r . k_j) * s_k[j], q pre-scaled by 1 / sqrt(D).
//   A half-warp takes a token: each lane holds 8 query rows of its D / 16
//   dims (DV x DG) in registers (row i ^ rho in slot i, rho the row the
//   lane ends with), dequantizes its k bytes once, runs one fmaf chain a
//   row, and the 16 lanes' partials are added by a transpose-reduce: 4 shuffle
//   levels, each keeping the lower half of the slots and sending the
//   upper, a fixed balanced tree over the 16 dim slices.
// - Softmax, once per split: one warp a query row (a warp's rows
//   interleaved), the split's max (a butterfly, exact), one expf a token,
//   the sum in a fixed order.
// - P.V: a lane owns D / 32 dims of 8 rows in registers; warp w sums the
//   tokens w, w + 8, ... in order, and the 8 warps' sums are added in warp
//   order.
// - Merge, inside the same launch: the last CTA of each group of NG
//   consecutive splits (an atomic ticket after a __threadfence()) merges
//   the group's split partials (m, l, acc[D]) of each query over exactly
//   its own splits, in split order, and writes out a query whose splits
//   all lie in the group (ceil(len / SPLIT) <= NG); for longer queries it
//   writes a group partial, and the last group merger merges those in
//   group order. Each merge is the warp merge of the earlier kernel: mx =
//   max m; den = sum l * exp(m - mx); num = sum acc * exp(m - mx); out =
//   num / max(den, 1e-20). A thread merges 8 dims of a row and issues the
//   loads of up to 8 splits at once. Two levels keep a merging CTA's read
//   to NG (or ceil(splits / NG)) partials, where one level would read
//   every split of a 32k-token row. A ticket is reset to 0 by the CTA
//   that drew the last number, so the next launch (or graph replay)
//   starts from 0. A chunk whose longest query fits one split skips the
//   workspace and tickets and merges its own partial from shared memory
//   with the same code.
//
// Why a verify query equals decode at its length, bit for bit. Every
// number of query row r is computed by one sequence of IEEE operations
// fixed by r's own length: the splits and the tokens each warp
// takes are fixed positions; the reduction trees do not depend on where
// the row sits among the CTA's rows; a token at or past the row's length
// enters as a score of NEG and a probability of exactly 0, and adding
// 0 * v (v an int8 value) to a sum that is never -0 leaves it unchanged,
// so the tokens that longer queries of the chunk add cost time but change
// no bit; and the merge reads exactly ceil(len / SPLIT) splits of that
// row and finishes at the level that number decides. The arithmetic uses
// explicit fmaf / __fmul_rn / __fadd_rn and IEEE division, so no
// contraction choice of the compiler enters. Decode is this kernel at
// C = 1.
//
// What bounds it on the H100. A resident token is read once as 2 * D int8
// values and two f32 scales (264 bytes at D 128) and feeds 4 * D * G f32
// flops (4096 at G 8): about 15.5 flops a byte, against 67 TF/s / 3.35
// TB/s = 20 for the f32 pipe, so at a long cache the bytes bound it on
// paper; in this design the f32 pipe (int8 conversion, shuffles and
// shared-memory loads on top of the flops) and the chain a CTA walks
// hold it to a fraction of that bound. Verify's C queries multiply the
// flops and not the bytes, so it is bound by operations. At serving sizes
// (a few hundred tokens a slot) latency decides: lengths and table ->
// cp.async -> scores -> softmax -> P.V -> partial -> ticket -> merge.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// internal linkage: each launcher's library keeps its own kernel and its
// own record of the shared-memory attribute (a static of an inline
// function with external linkage would be one object across libraries)
namespace kvq_split {
namespace {

constexpr int SPLIT = 64;          // token positions a CTA owns
constexpr int NG = 16;             // splits merged by one group merger
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TPT = THREADS / SPLIT;  // loads: threads a token
constexpr int HW = THREADS / 16;      // scores: half-warps
constexpr int RMAX = 40;           // query rows a CTA holds (C 5 x G 8,
                                   // C 4 x G 10)
constexpr int GMAX = 10;           // largest GQA group
constexpr int PART = 4;            // f32 a partial row holds beyond acc[D]:
                                   // m, l and 2 of padding
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(THREADS % SPLIT == 0 && SPLIT % HW == 0 && SPLIT % 32 == 0,
              "SPLIT: whole threads a token, tokens a half-warp and a lane");
static_assert(RMAX % 8 == 0 && RMAX >= GMAX, "RMAX: whole row chunks");

// shared-memory layout of one CTA, in bytes, for D dims of ES-byte K/V
// elements and RP rows
template <int D, int ES>
struct Layout {
  static constexpr int KROW = D * ES + 16;     // K/V row, padded (bytes)
  static constexpr int PS = D + PART;          // partial row: acc, m, l
  int rp;                                      // rows, a multiple of 8
  __host__ __device__ explicit Layout(int rp_) : rp(rp_) {}
  __host__ __device__ int kv() const { return 0; }
  __host__ __device__ int sc() const { return 2 * SPLIT * KROW; }
  __host__ __device__ int q() const { return sc() + 2 * SPLIT * 4; }
  __host__ __device__ int s() const { return q() + rp * D * 4; }
  // the scores' region later holds the CTA's own partial (fast path)
  __host__ __device__ int pv() const {
    return s() + rp * (SPLIT > PS ? SPLIT : PS) * 4;
  }
  __host__ __device__ int red() const { return pv() + SPLIT * rp * 4; }
  __host__ __device__ int m() const { return red() + WARPS * 8 * D * 4; }
  __host__ __device__ int l() const { return m() + rp * 4; }
  __host__ __device__ int rlen() const { return l() + rp * 4; }
  __host__ __device__ int bytes() const { return rlen() + rp * 4; }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// int8 byte i of w as an exact f32: with the sign bit flipped the byte is
// b + 128, and 0x4B0000xx is the float 2^23 + xx
__device__ __forceinline__ float i8f(unsigned w, int i) {
  const unsigned x = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7650 | i);
  return __fsub_rn(__uint_as_float(x), 8388736.0f);
}

// bf16 half i (0 low, 1 high) of w as an exact f32
__device__ __forceinline__ float bff(unsigned w, int i) {
  return __uint_as_float(i ? w & 0xFFFF0000u : w << 16);
}

// N consecutive K/V elements at shared address p (N * sizeof(KV) bytes,
// aligned to that) as exact f32
template <typename KV, int N>
__device__ __forceinline__ void load_kv(const unsigned char* p,
                                        float (&f)[N]) {
  if constexpr (std::is_same_v<KV, int8_t>) {
    if constexpr (N == 1) {
      f[0] = static_cast<float>(*reinterpret_cast<const int8_t*>(p));
    } else if constexpr (N == 2) {
      const unsigned w = *reinterpret_cast<const unsigned short*>(p);
      f[0] = i8f(w, 0);
      f[1] = i8f(w, 1);
    } else {
      static_assert(N % 4 == 0, "int8: 1, 2 or whole words");
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const unsigned w = reinterpret_cast<const unsigned*>(p)[q];
#pragma unroll
        for (int i = 0; i < 4; ++i) f[4 * q + i] = i8f(w, i);
      }
    }
  } else {
    if constexpr (N == 1) {
      f[0] = __uint_as_float(
          static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
          << 16);
    } else {
      static_assert(N % 2 == 0, "bf16: 1 or whole words");
      if constexpr (N % 8 == 0) {
#pragma unroll
        for (int q = 0; q < N / 8; ++q) {
          const uint4 w = reinterpret_cast<const uint4*>(p)[q];
          const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) f[8 * q + i] = bff(ws[i / 2], i & 1);
        }
      } else if constexpr (N == 4) {
        const uint2 w = *reinterpret_cast<const uint2*>(p);
        f[0] = bff(w.x, 0);
        f[1] = bff(w.x, 1);
        f[2] = bff(w.y, 0);
        f[3] = bff(w.y, 1);
      } else {
        const unsigned w = *reinterpret_cast<const unsigned*>(p);
        f[0] = bff(w, 0);
        f[1] = bff(w, 1);
      }
    }
  }
}

template <bool kGlobal>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (kGlobal) return __ldcg(p);
  else return *p;
}

template <bool kGlobal>
__device__ __forceinline__ float2 ld2(const float* p) {
  if constexpr (kGlobal) return __ldcg(reinterpret_cast<const float2*>(p));
  else return *reinterpret_cast<const float2*>(p);
}

template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (kGlobal) return __ldcg(reinterpret_cast<const float4*>(p));
  else return *reinterpret_cast<const float4*>(p);
}

// The merge of one query row's partial rows (acc[D], m, l) at p0 + s *
// stride, s in [s_lo, s_hi), for dims 8 de .. 8 de + 7: mx = max m; den =
// sum l * exp(m - mx) and num = sum acc * exp(m - mx) in split order. Up
// to FB splits are loaded at once (one round trip); a longer run takes a
// pass for the max and then batches.
constexpr int FB = 8;

template <bool kGlobal, int D>
__device__ __forceinline__ void merge_row(const float* p0, long long stride,
                                          int s_lo, int s_hi, int de,
                                          float& mx, float& den,
                                          float (&num)[8]) {
  mx = NEG;
  den = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) num[j] = 0.f;
  const bool one = s_hi - s_lo <= FB;
  if (!one)
    for (int s0 = s_lo; s0 < s_hi; s0 += FB) {
      float m[FB];
#pragma unroll
      for (int i = 0; i < FB; ++i)
        m[i] = s0 + i < s_hi ? ld<kGlobal>(p0 + (s0 + i) * stride + D) : NEG;
#pragma unroll
      for (int i = 0; i < FB; ++i) mx = fmaxf(mx, m[i]);
    }
  for (int s0 = s_lo; s0 < s_hi; s0 += FB) {
    float m[FB], l[FB];
    float4 a[FB], b[FB];
#pragma unroll
    for (int i = 0; i < FB; ++i) {     // in-bounds loads, masked after
      const float* p = p0 + min(s0 + i, s_hi - 1) * stride;
      const float2 ml = ld2<kGlobal>(p + D);
      m[i] = s0 + i < s_hi ? ml.x : NEG;
      l[i] = ml.y;
      a[i] = ld4<kGlobal>(p + 8 * de);
      b[i] = ld4<kGlobal>(p + 8 * de + 4);
    }
    if (one) {
#pragma unroll
      for (int i = 0; i < FB; ++i) mx = fmaxf(mx, m[i]);
    }
#pragma unroll
    for (int i = 0; i < FB; ++i) {
      if (s0 + i < s_hi) {
        const float w = expf(__fsub_rn(m[i], mx));
        den = fmaf(l[i], w, den);
        const float x[8] = {a[i].x, a[i].y, a[i].z, a[i].w,
                            b[i].x, b[i].y, b[i].z, b[i].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) num[j] = fmaf(x[j], w, num[j]);
      }
    }
  }
}

// One merge level: emit(r, de, mx, den, num) for every query row r < R
// and dims 8 de .. 8 de + 7 of it, merging splits [s_lo, hi(r)).
template <bool kGlobal, int D, typename Hi, typename Emit>
__device__ __forceinline__ void merge_level(const float* src,
                                            long long stride, int s_lo,
                                            int R, Hi hi, Emit emit) {
  constexpr int PS = D + PART, DE = D / 8;
  for (int e = threadIdx.x; e < R * DE; e += THREADS) {
    const int r = e / DE, de = e % DE;
    float mx, den, num[8];
    merge_row<kGlobal, D>(src + (long long)r * PS, stride, s_lo,
                          max(s_lo, hi(r)), de, mx, den, num);
    emit(r, de, mx, den, num);
  }
}

__device__ __forceinline__ void write_out(__nv_bfloat16* o, float den,
                                          const float (&num)[8]) {
  const float dd = fmaxf(den, 1e-20f);   // a length-0 row: 0 / 1e-20 = 0
  __nv_bfloat16 h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16_rn(__fdiv_rn(num[j], dd));
  *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(h);
}

// Draw a ticket for counter *tk among cnt CTAs after this CTA's global
// writes; true in the CTA that drew the last one (which resets *tk).
__device__ __forceinline__ bool last_of(int* tk, int cnt, int* flag_s) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(tk, 1);
    const bool last = t == cnt - 1;
    if (last) *tk = 0;
    *flag_s = last;
  }
  __syncthreads();
  const bool last = *flag_s != 0;
  if (last) __threadfence();
  return last;
}

template <int D, typename KV, bool kDense>
__global__ void __launch_bounds__(THREADS, D >= 256 ? 1 : 2)
kvq_paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                       const KV* __restrict__ k,
                       const KV* __restrict__ v,
                       const float* __restrict__ sk,
                       const float* __restrict__ sv,
                       const int* __restrict__ tbl,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ ws, int* __restrict__ tickets,
                       int C, int H, int Hkv, int NB, int bs, int T,
                       float scale) {
  constexpr int ES = sizeof(KV);
  using L = Layout<D, ES>;
  constexpr int KROW = L::KROW, PS = L::PS;
  constexpr int CH = D * ES / 16;     // 16-byte chunks a row
  constexpr int DV = D >= 64 ? 4 : D / 16;  // scores: dims a lane's group
  constexpr int DG = D / (16 * DV);   // scores: groups a lane owns
  constexpr int DPV = D >= 32 ? D / 32 : 1;  // P.V: dims a lane owns
  static_assert(D % 16 == 0 && DG >= 1, "D: a multiple of 16");
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag_s;

  const int G = H / Hkv;
  const int QC = RMAX / G;            // queries a chunk
  const int nqc = (C + QC - 1) / QC;
  const int NS = (T * bs + SPLIT - 1) / SPLIT;
  const int NGRP = (NS + NG - 1) / NG;
  const int b = blockIdx.x / NS;
  const int s = blockIdx.x % NS;
  const int kh = blockIdx.y % Hkv;
  const int qc = blockIdx.y / Hkv;
  const int c0 = qc * QC;
  const int nq = min(QC, C - c0);
  const int R = nq * G;
  const int RP = (R + 7) & ~7;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cap = T * bs;
  const int p0 = s * SPLIT;

  // the block of this thread's token: its table entry, loaded beside the
  // lengths (the index is clamped in range; the entry before any
  // address), or under kDense the slot itself (no table)
  const int jl = tid / TPT;                   // token of the split
  const int cs = tid % TPT;                   // chunk slot
  int ent = b;
  if constexpr (!kDense)
    ent = min(max(tbl[(size_t)b * T + min(p0 + jl, cap - 1) / bs], 0),
              NB - 1);
  auto qlen = [&](int c) {
    return max(0, min(lengths[(size_t)b * C + c], cap));
  };
  int maxlen = 0;
  for (int c = 0; c < nq; ++c) maxlen = max(maxlen, qlen(c0 + c));
  const int nact = max(1, (maxlen + SPLIT - 1) / SPLIT);
  if (s >= nact) return;

  const L lay(RP);
  unsigned char* kv_s = smem + lay.kv();
  float* sc_s = reinterpret_cast<float*>(smem + lay.sc());
  float* q_s = reinterpret_cast<float*>(smem + lay.q());
  float* s_s = reinterpret_cast<float*>(smem + lay.s());
  float* pv_s = reinterpret_cast<float*>(smem + lay.pv());
  float* red_s = reinterpret_cast<float*>(smem + lay.red());
  float* m_s = reinterpret_cast<float*>(smem + lay.m());
  float* l_s = reinterpret_cast<float*>(smem + lay.l());
  int* rlen_s = reinterpret_cast<int*>(smem + lay.rlen());

  // ---- put the whole split in flight
  const int n_tok = min(SPLIT, maxlen - p0);
  if (jl < n_tok) {
    // dense: row (b * Hkv + kh) * S + p, p < cap = S
    const size_t tok = ((size_t)ent * Hkv + kh) * bs +
                       (kDense ? p0 + jl : (p0 + jl) % bs);
#pragma unroll
    for (int u = 0; u < (2 * CH + TPT - 1) / TPT; ++u) {
      const int c = cs + TPT * u;                  // 0 .. 2 CH - 1
      if (c < CH)
        cp_async16(kv_s + jl * KROW + 16 * c, kb + tok * D * ES + 16 * c);
      else if (c < 2 * CH)
        cp_async16(kv_s + (SPLIT + jl) * KROW + 16 * (c - CH),
                   vb + tok * D * ES + 16 * (c - CH));
    }
    if (cs == 0) cp_async4(sc_s + jl, sk + tok);
    if (cs == 1) cp_async4(sc_s + SPLIT + jl, sv + tok);
  }
  cp_async_commit();

  // ---- the chunk's query rows, pre-scaled, and their lengths
  for (int e = tid; e < RP * (D / 8); e += THREADS) {
    const int r = e / (D / 8);
    const int d8 = (e % (D / 8)) * 8;
    float x[8];
    if (r < R) {
      const size_t row =
          ((size_t)b * C + c0 + r / G) * H + (size_t)kh * G + r % G;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = __fmul_rn(__bfloat162float(q[row * D + d8 + i]), scale);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    float* dst = q_s + r * D + d8;
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(x[4], x[5], x[6], x[7]);
  }
  for (int r = tid; r < RP; r += THREADS)
    rlen_s[r] = r < R ? qlen(c0 + r / G) : 0;

  // ---- scores: half-warp hw takes tokens hw, hw + HW, ...; lane hl owns
  // dims 16 DV g + DV hl .. + DV - 1 (g < DG; 64 g + 4 hl .. + 3 from D
  // 64) and holds row rc + (i ^ rho) of the
  // chunk in slot i, so that each level of the transpose-reduce keeps its
  // lower slots and sends the upper ones
  {
    const int hw = tid >> 4;
    const int hl = tid & 15;
    const int rho = 4 * (hl & 1) + 2 * ((hl >> 1) & 1) + ((hl >> 2) & 1);
    cp_async_wait_all();
    __syncthreads();                          // the split landed
    for (int rc = 0; rc < RP; rc += 8) {
      float qf[8][DV * DG];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          const float* src = q_s + (rc + (r ^ rho)) * D + 16 * DV * g +
                             DV * hl;
          if constexpr (DV == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            qf[r][4 * g] = x.x;
            qf[r][4 * g + 1] = x.y;
            qf[r][4 * g + 2] = x.z;
            qf[r][4 * g + 3] = x.w;
          } else {
#pragma unroll
            for (int i = 0; i < DV; ++i) qf[r][DV * g + i] = src[i];
          }
        }
#pragma unroll
      for (int u = 0; u < SPLIT / HW; ++u) {
        const int j = hw + HW * u;
        float kf[DV * DG];
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          float f[DV];
          load_kv<KV, DV>(kv_s + j * KROW + (16 * DV * g + DV * hl) * ES, f);
#pragma unroll
          for (int i = 0; i < DV; ++i) kf[DV * g + i] = f[i];
        }
        float P[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          P[r] = 0.f;
#pragma unroll
          for (int i = 0; i < DV * DG; ++i)
            P[r] = fmaf(qf[r][i], kf[i], P[r]);
        }
        // transpose-reduce over the half-warp's 16 dim slices: slot i
        // holds row i ^ rho, so the partner across lane bit b sends
        // exactly the rows this lane keeps; each row is added as
        // (slice pairs) in the same balanced tree whatever its slot
        float A[4], Bv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          A[i] = __fadd_rn(P[i], __shfl_xor_sync(FULL, P[4 + i], 1));
#pragma unroll
        for (int i = 0; i < 2; ++i)
          Bv[i] = __fadd_rn(A[i], __shfl_xor_sync(FULL, A[2 + i], 2));
        float sc = __fadd_rn(Bv[0], __shfl_xor_sync(FULL, Bv[1], 4));
        sc = __fadd_rn(sc, __shfl_xor_sync(FULL, sc, 8));
        if (hl < 8) {
          const int r = rc + rho;
          const bool ok = p0 + j < rlen_s[r];
          s_s[r * SPLIT + j] = ok ? __fmul_rn(sc, sc_s[j]) : NEG;
        }
      }
    }
  }
  __syncthreads();

  // ---- softmax over the split: warp w takes rows w, w + 8, ..., their
  // independent chains interleaved
  {
    constexpr int RW = (RMAX + WARPS - 1) / WARPS;   // rows a warp holds
    constexpr int NJ = SPLIT / 32;
    float x[RW][NJ], mt[RW], ls[RW];
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      const int r = warp + WARPS * k;
      const int len = r < RP ? rlen_s[r] : 0;
      mt[k] = NEG;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = lane + 32 * i;
        x[k][i] = p0 + j < len ? s_s[r * SPLIT + j] : NEG;
        mt[k] = fmaxf(mt[k], x[k][i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int k = 0; k < RW; ++k)
        mt[k] = fmaxf(mt[k], __shfl_xor_sync(FULL, mt[k], off));
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      const int r = warp + WARPS * k;
      const int len = r < RP ? rlen_s[r] : 0;
      ls[k] = 0.f;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = lane + 32 * i;
        const bool ok = p0 + j < len;
        const float e = ok ? expf(__fsub_rn(x[k][i], mt[k])) : 0.f;
        ls[k] = __fadd_rn(ls[k], e);
        if (r < RP) pv_s[j * RP + r] = ok ? __fmul_rn(e, sc_s[SPLIT + j]) : 0.f;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int k = 0; k < RW; ++k)
        ls[k] = __fadd_rn(ls[k], __shfl_xor_sync(FULL, ls[k], off));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        const int r = warp + WARPS * k;
        if (r < RP) {
          m_s[r] = mt[k];
          l_s[r] = ls[k];
        }
      }
    }
  }
  __syncthreads();

  // ---- P.V: lane owns dims lane * DPV .. (lanes at or past D / DPV idle
  // at D 16); warp w sums tokens w, w + 8, ...; the warps' sums are added
  // in warp order. The CTA's partial goes to the workspace, or to the
  // scores' region when it is the only split.
  const bool pv_lane = lane * DPV < D;
  const int CG = C * G;
  const size_t slot0 = (size_t)(b * Hkv + kh) * (NS + NGRP);
  float* wsb = ws + slot0 * CG * PS + (size_t)c0 * G * PS;  // slot 0, row 0
  const long long s_stride = (long long)CG * PS;
  float* part = nact == 1 ? s_s : wsb + s * s_stride;
  for (int rc = 0; rc < RP; rc += 8) {
    float acc[8][DPV];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < DPV; ++i) acc[r][i] = 0.f;
    for (int j = warp; j < (pv_lane ? n_tok : 0); j += WARPS) {
      const float4 pa = *reinterpret_cast<const float4*>(pv_s + j * RP + rc);
      const float4 pb =
          *reinterpret_cast<const float4*>(pv_s + j * RP + rc + 4);
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vf[DPV];
      load_kv<KV, DPV>(kv_s + (SPLIT + j) * KROW + lane * DPV * ES, vf);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int i = 0; i < DPV; ++i)
          acc[r][i] = fmaf(pr[r], vf[i], acc[r][i]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* dst = red_s + (warp * 8 + r) * D + lane * DPV;
      if (!pv_lane) continue;
      if constexpr (DPV % 4 == 0) {
#pragma unroll
        for (int i = 0; i < DPV; i += 4)
          *reinterpret_cast<float4*>(dst + i) = make_float4(
              acc[r][i], acc[r][i + 1], acc[r][i + 2], acc[r][i + 3]);
      } else if constexpr (DPV == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[r][0], acc[r][1]);
      } else {
        dst[0] = acc[r][0];
      }
    }
    __syncthreads();
    for (int e = tid; e < 8 * (D / 4); e += THREADS) {
      const int r = e / (D / 4);
      const int d4 = (e % (D / 4)) * 4;
      float4 a = *reinterpret_cast<const float4*>(red_s + r * D + d4);
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        const float4 x =
            *reinterpret_cast<const float4*>(red_s + (w * 8 + r) * D + d4);
        a.x = __fadd_rn(a.x, x.x);
        a.y = __fadd_rn(a.y, x.y);
        a.z = __fadd_rn(a.z, x.z);
        a.w = __fadd_rn(a.w, x.w);
      }
      if (rc + r < R)
        *reinterpret_cast<float4*>(part + (rc + r) * PS + d4) = a;
    }
    __syncthreads();                          // red_s free again
  }
  for (int r = tid; r < R; r += THREADS) {
    part[r * PS + D] = m_s[r];
    part[r * PS + D + 1] = l_s[r];
  }

  // ---- merge. Level 1: the splits of group gi; a row whose splits all
  // lie in group 0 is finished here, a longer one leaves a group partial
  auto n_splits = [&](int r) { return (rlen_s[r] + SPLIT - 1) / SPLIT; };
  auto out_at = [&](int r, int de) {
    return out + (((size_t)b * C + c0 + r / G) * H + (size_t)kh * G + r % G)
                 * D + 8 * de;
  };
  auto level1 = [&](auto global_tag, const float* src, long long stride,
                    int gi, float* grp) {
    merge_level<decltype(global_tag)::value, D>(
        src, stride, gi * NG, R,
        [&](int r) { return min(n_splits(r), gi * NG + NG); },
        [&](int r, int de, float mx, float den, const float (&num)[8]) {
          const int n = n_splits(r);
          if (n <= gi * NG && !(gi == 0 && n == 0)) return;
          if (n <= NG) {
            write_out(out_at(r, de), den, num);
          } else {
            float* o = grp + (long long)r * PS;
            *reinterpret_cast<float4*>(o + 8 * de) =
                make_float4(num[0], num[1], num[2], num[3]);
            *reinterpret_cast<float4*>(o + 8 * de + 4) =
                make_float4(num[4], num[5], num[6], num[7]);
            if (de == 0) {
              o[D] = mx;
              o[D + 1] = den;
            }
          }
        });
  };

  if (nact == 1) {                            // the chunk fits one split
    __syncthreads();
    level1(std::false_type{}, part, 0, 0, nullptr);
    return;
  }

  int* tk = tickets + (size_t)(b * Hkv + kh) * nqc * (NGRP + 1) +
            (size_t)qc * (NGRP + 1);
  const int gi = s / NG;
  if (!last_of(tk + gi, min(NG, nact - gi * NG), &flag_s)) return;
  level1(std::true_type{}, wsb, s_stride, gi, wsb + (NS + gi) * s_stride);
  const int ngrp = (nact + NG - 1) / NG;
  if (ngrp == 1 || !last_of(tk + NGRP, ngrp, &flag_s)) return;
  // level 2: the group partials of the rows longer than one group
  merge_level<true, D>(
      wsb + NS * s_stride, s_stride, 0, R,
      [&](int r) {
        const int n = n_splits(r);
        return n > NG ? (n + NG - 1) / NG : 0;
      },
      [&](int r, int de, float mx, float den, const float (&num)[8]) {
        if (n_splits(r) > NG) write_out(out_at(r, de), den, num);
      });
}

// Shapes the kernel takes (D 16, 64, 128 or 256, G <= GMAX, bs >= 1,
// 32-bit pool and table indices, a grid in range).
bool valid(int B, int C, int H, int Hkv, int D, int T, int bs, int NB) {
  const int G = Hkv > 0 ? H / Hkv : 0;
  if (B < 0 || G < 1 || G > GMAX || G * Hkv != H ||
      (D != 16 && D != 64 && D != 128 && D != 256) || NB < 1 || bs < 1 ||
      T < 1 || C < 1)
    return false;
  const long long nqc = (C + RMAX / G - 1) / (RMAX / G);
  const long long NS = ((long long)T * bs + SPLIT - 1) / SPLIT;
  return (long long)(NB + 1) * Hkv * bs < (1LL << 31) &&
         (long long)T * bs < (1LL << 31) && NS * B < (1LL << 31) &&
         nqc * Hkv <= 65535;
}

// The scratch of a launch: f32 partials (B, Hkv, NS + NGRP, C, G, D +
// PART), a row each of the NS splits and NGRP groups of a (slot, KV
// head) for every query row; int32 tickets, NGRP + 1 a (slot, KV head,
// query chunk).
void scratch(int B, int C, int H, int Hkv, int D, int T, int bs,
             long long* ws, long long* tickets) {
  const long long G = H / Hkv, nqc = (C + RMAX / G - 1) / (RMAX / G);
  const long long NS = ((long long)T * bs + SPLIT - 1) / SPLIT;
  const long long NGRP = (NS + NG - 1) / NG;
  *ws = (long long)B * Hkv * (NS + NGRP) * C * G * (D + PART);
  *tickets = (long long)B * Hkv * nqc * (NGRP + 1);
}

// One instantiation of the kernel: raise its shared-memory attribute to
// smem (once to the largest size asked for, so a call inside a stream
// capture sets nothing after the first eager one) and launch it.
template <int D, typename KV, bool kDense>
int launch_one(dim3 grid, int smem, cudaStream_t st, const void* q,
               const void* k, const void* v, const void* sk, const void* sv,
               const void* tbl, const void* lengths, void* out, void* ws,
               void* tickets, int C, int H, int Hkv, int NB, int bs, int T,
               float scale) {
  static int set = 0;
  if (smem > set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kvq_paged_split_kernel<D, KV, kDense>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    set = smem;
  }
  kvq_paged_split_kernel<D, KV, kDense><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(tbl),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), C, H, Hkv, NB,
      bs, T, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDense>
int launch_d(int es, dim3 grid, int rp, cudaStream_t st, const void* q,
             const void* k, const void* v, const void* sk, const void* sv,
             const void* tbl, const void* lengths, void* out, void* ws,
             void* tickets, int C, int H, int Hkv, int NB, int bs, int T,
             float scale) {
  if (es == 1)
    return launch_one<D, int8_t, kDense>(
        grid, Layout<D, 1>(rp).bytes(), st, q, k, v, sk, sv, tbl, lengths,
        out, ws, tickets, C, H, Hkv, NB, bs, T, scale);
  return launch_one<D, __nv_bfloat16, kDense>(
      grid, Layout<D, 2>(rp).bytes(), st, q, k, v, sk, sv, tbl, lengths, out,
      ws, tickets, C, H, Hkv, NB, bs, T, scale);
}

// Launch for q / out of (B, C, H, D); ws_len f32 of workspace and tk_len
// int32 tickets, at least what scratch() asks for (tickets zero before
// the first launch; every launch leaves them zero). kv_bytes: 1 for int8
// K/V pools, 2 for bf16. kDense: k / v / s_k / s_v are a dense cache (B,
// Hkv, S, D), passed as T = 1, bs = S, NB = B, and tbl is not read.
template <bool kDense>
int launch(const void* q, const void* k, const void* v, const void* sk,
           const void* sv, const void* tbl, const void* lengths, void* out,
           void* ws, long long ws_len, void* tickets, long long tk_len,
           int B, int C, int H, int Hkv, int NB, int bs, int T, int D,
           int kv_bytes, float scale, void* stream) {
  if (!valid(B, C, H, Hkv, D, T, bs, NB) || (kv_bytes != 1 && kv_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  long long ws_need, tk_need;
  scratch(B, C, H, Hkv, D, T, bs, &ws_need, &tk_need);
  if (ws_len < ws_need || tk_len < tk_need)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const int G = H / Hkv;
  const int QC = RMAX / G;
  const long long nqc = (C + QC - 1) / QC;
  const long long NS = ((long long)T * bs + SPLIT - 1) / SPLIT;
  const int rp = ((C < QC ? C : QC) * G + 7) & ~7;
  const dim3 grid((unsigned)(NS * B), (unsigned)(nqc * Hkv));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KVQ_ARGS                                                           \
  kv_bytes, grid, rp, st, q, k, v, sk, sv, tbl, lengths, out, ws, tickets, \
      C, H, Hkv, NB, bs, T, scale
  switch (D) {
    case 16: return launch_d<16, kDense>(KVQ_ARGS);
    case 64: return launch_d<64, kDense>(KVQ_ARGS);
    case 128: return launch_d<128, kDense>(KVQ_ARGS);
    default: return launch_d<256, kDense>(KVQ_ARGS);
  }
#undef KVQ_ARGS
}

}  // namespace
}  // namespace kvq_split

// The token positions of a split (the wrapper's SPLIT).
extern "C" int kvq_paged_split_tokens(void) { return kvq_split::SPLIT; }

// The scratch a launch of these shapes needs: *ws f32 elements of
// workspace and *tickets int32 counters. cudaErrorInvalidValue (and
// nothing written) for shapes the launchers refuse.
extern "C" int kvq_paged_split_scratch(int B, int C, int H, int Hkv, int D,
                                       int T, int bs, long long* ws,
                                       long long* tickets) {
  if (!kvq_split::valid(B, C, H, Hkv, D, T, bs, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  kvq_split::scratch(B, C, H, Hkv, D, T, bs, ws, tickets);
  return 0;
}
