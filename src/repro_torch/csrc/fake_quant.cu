// LSQ fake quantization, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quant/kernel.py
// (fake_quant_fwd / _fwd_kernel and fake_quant_bwd / _bwd_kernel):
//
//   forward:  out = rint(clip(x / max(s, 1e-9), qn, qp)) * max(s, 1e-9)
//   backward: v = x / max(s, 1e-9), within = qn <= v <= qp
//             dx = within ? g : 0
//             ds = gscale * sum(g * (within ? rint(v) - v : clip(v, qn, qp)))
//
// all in f32 and cast back to the input's type (bf16 or f32). x is a
// contiguous (E, R, C) view, E = 1 but in mode 3; the scale is one of
//   mode 0: per tensor, s[0];
//   mode 1: per column, s[c] (a weight's output channel, the last axis);
//   mode 2: per row, s[r] (the tied head: embed.w is (vocab, d) and its
//           transpose is what the head multiplies, quantized per vocab
//           entry, so the channel is the row of the stored tensor);
//   mode 3: per column of each leading slice, s[e * C + c] (an MoE expert
//           bank (E, d_in, d_out) with its (E, 1, d_out) scales).
// ds sums over what shares one scale and is multiplied by
// gscale = 1 / sqrt(f32(n * qp)), n = numel / number of scales, which the
// caller computes (quant/ops.py:_fq_bwd on the TPU side).
//
// Numerics. The forward and dx are bitwise equal to the plain PyTorch
// version: a true f32 division (__fdiv_rn, no reciprocal), clamp before
// rounding, rintf (round half to even, as torch.round and jnp.round; never
// roundf), __fmul_rn for the rescale so nothing is contracted into an FMA,
// and round-to-nearest-even casts. ds differs from the plain version only
// by the order of its f32 sums. It is summed in two deterministic passes
// (partials, then a fixed-order sum of the partials; no atomics), so one
// step reproduces from run to run.
//
// What bounds it on the H100: bytes. Each element costs a handful of f32
// operations against 4 bytes moved (bf16 in and out) in the forward and 6
// in the backward (x and g in, dx out), far below the card's ~20 f32
// operations per byte. Design: one pass over the data with 16-byte loads
// and stores (8 bf16 or 4 f32 per thread) wherever the shape and the
// pointers allow, else one element per thread; the forward's scale index
// in 32-bit arithmetic wherever a slice has fewer than 2^32 elements, and
// in mode 3 a grid row of blocks per slice (no division by the slice's
// size).
// The TPU kernel's (256, 512) VMEM tiles become: modes 1 and 3, a block
// (8 warps) per strip of 32 packs
// (256 bf16 columns: a warp reads 512 contiguous bytes of a row) and band
// of rows, its warps on different rows, each thread staging its own packs
// of x and g COL_STAGES groups of COL_UNROLL rows ahead by cp.async (12
// rows in flight with no register holding them); the bands are sized so
// that the grid holds ~2 blocks an SM (one wave) at every weight shape
// (2048 x 256 to 11008 x 2048). Mode 3 is mode 1 with the bands cut
// inside each slice (a band never crosses one; the slices share the
// wave's blocks), and mode 1 is mode 3 at E = 1. The warps' column sums
// meet in shared memory in warp order, one partial per band and column; a
// second pass sums each slice's bands in a fixed order, 8 threads a
// column. Mode 2, one warp
// per row with a shuffle reduction; mode 0, a fixed grid of grid-stride
// blocks, one partial per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 256;
constexpr int COL_WARPS = 8;          // mode 1: warps of a block, rows apart
constexpr int COL_UNROLL = 4;         // mode 1: rows of a thread's group
constexpr int COL_STAGES = 3;         // mode 1: groups in flight (cp.async)
constexpr int COL_BAND = COL_WARPS * COL_UNROLL;  // bands are multiples
constexpr int COL_STRIP = 32 * 8;     // mode 1: a strip's columns in bf16
//                                       packs (sizes the bands, any pack)
constexpr int COL_TARGET_BLOCKS = 264; // mode 1: at most one wave at 2
//                                       blocks an SM (the registers allow 2)
constexpr int FIN_GROUPS = 8;         // mode 1, second pass: threads a column
constexpr int TENSOR_BLOCKS = 1024;   // mode 0: most blocks, one partial each
constexpr float EPS = 1e-9f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// clip that lets NaN through, as jnp.clip and torch.clamp do
__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clamp_scale(float s) {
  return s < EPS ? EPS : s;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// the scale of element i of x (of the block's slice in mode 3)
template <typename I>
__device__ __forceinline__ I scale_index(I i, I C, int mode) {
  return mode == 0 ? 0 : (mode == 2 ? i / C : i % C);
}

// ---------------------------------------------------------------- forward

// n_packs packs of x (of each slice in mode 3, whose grid row
// blockIdx.y is slice e: x, out and s start at the slice's own, and the
// slice is then a mode-1 tensor). I: the index type of the scale lookup
// (unsigned 32-bit when a slice has fewer than 2^32 elements: a 64-bit
// division costs several times more)
template <typename T, int V, typename I>
__global__ void __launch_bounds__(THREADS)
fq_fwd_kernel(const T* __restrict__ x, const float* __restrict__ s,
              T* __restrict__ out, long long n_packs, I C, int mode,
              float qn, float qp) {
  const long long base = (long long)blockIdx.y * n_packs;
  x += base * V;
  out += base * V;
  s += (long long)blockIdx.y * C;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
       p < n_packs; p += (long long)gridDim.x * THREADS) {
    const I i0 = (I)(p * V);
    const Pack<T, V> xv = reinterpret_cast<const Pack<T, V>*>(x)[p];
    Pack<T, V> ov;
    // with C % V == 0 the V elements share one row: one scale index per
    // pack in modes 0 and 2, consecutive ones in modes 1 and 3
    const I si = scale_index<I>(i0, C, mode);
    const bool per_col = mode == 1 || mode == 3;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float sf = clamp_scale(s[per_col ? si + j : si]);
      const float q = rintf(clipf(__fdiv_rn(to_f(xv.v[j]), sf), qn, qp));
      from_f(__fmul_rn(q, sf), &ov.v[j]);
    }
    reinterpret_cast<Pack<T, V>*>(out)[p] = ov;
  }
}

// --------------------------------------------------------------- backward

// one element: writes dx, returns g * d(out)/d(s) before the grad scale
template <typename T>
__device__ __forceinline__ float fq_bwd_elem(T xe, T ge, float sf, float qn,
                                             float qp, T* dx) {
  const float v = __fdiv_rn(to_f(xe), sf);
  const float g = to_f(ge);
  const bool within = (v >= qn) && (v <= qp);
  from_f(within ? g : 0.0f, dx);
  const float dq = within ? __fsub_rn(rintf(v), v) : clipf(v, qn, qp);
  return __fmul_rn(g, dq);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// modes 1 and 3: x is E slices of (R, C), cut into `bands` bands of
// `band` rows each; blockIdx.y = e * bands + b is band b of slice e. The
// block (COL_WARPS warps) covers the strip of 32 * V columns starting at
// blockIdx.x * 32 * V and the slice's rows [b * band, + band); warp w
// takes rows w, w + COL_WARPS, ... of the band in groups of COL_UNROLL,
// and each thread sums its columns in row order; partial[blockIdx.y, c]
// is the band's column sum, the warps' sums added in warp order. With
// 16-byte packs a thread stages its own packs of x and g COL_STAGES groups
// ahead in shared memory by cp.async (no other thread reads them: no
// barrier), else it loads a group into registers.
template <typename T, int V>
__global__ void __launch_bounds__(COL_WARPS * 32, 2)
fq_bwd_col_kernel(const T* __restrict__ x, const float* __restrict__ s,
                  const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ partial, long long R, long long C,
                  long long band, int bands, float qn, float qp) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char col_smem[];
  __shared__ float red[COL_WARPS][32 * V];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long e = blockIdx.y / bands, b = blockIdx.y % bands;
  const long long c0 = ((long long)blockIdx.x * 32 + lane) * V;
  const long long r0 = b * band + warp;
  const long long r1 = b * band + band < R ? b * band + band : R;
  // the slice's own rows and scales (R * C is a multiple of V: packs stay
  // aligned)
  const P* xp = reinterpret_cast<const P*>(x + e * R * C);
  const P* gp = reinterpret_cast<const P*>(g + e * R * C);
  P* dp = reinterpret_cast<P*>(dx + e * R * C);
  s += e * C;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (c0 < C) {
    float sf[V];
#pragma unroll
    for (int j = 0; j < V; ++j) sf[j] = clamp_scale(s[c0 + j]);
    // row u of group q of this warp
    auto row = [&](long long q, int u) {
      return r0 + q * COL_BAND + (long long)u * COL_WARPS;
    };
    auto sum_row = [&](const P& xv, const P& gv, long long rr) {
      P dv;
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[j] += fq_bwd_elem(xv.v[j], gv.v[j], sf[j], qn, qp, &dv.v[j]);
      dp[(rr * C + c0) / V] = dv;
    };
    const long long groups = r0 < r1 ? (r1 - r0 + COL_BAND - 1) / COL_BAND : 0;
    if constexpr (sizeof(P) == 16) {
      // this thread's slots: st[((stage * COL_UNROLL + u) * 2 + k) * 32]
      P* st = reinterpret_cast<P*>(col_smem) +
              (size_t)warp * COL_STAGES * COL_UNROLL * 2 * 32 + lane;
      auto stage = [&](long long q, int b) {
#pragma unroll
        for (int u = 0; u < COL_UNROLL; ++u) {
          const long long rr = row(q, u);
          if (rr < r1) {
            cp_async16(st + ((b * COL_UNROLL + u) * 2) * 32,
                       xp + (rr * C + c0) / V);
            cp_async16(st + ((b * COL_UNROLL + u) * 2 + 1) * 32,
                       gp + (rr * C + c0) / V);
          }
        }
      };
#pragma unroll
      for (int b = 0; b < COL_STAGES - 1; ++b) {
        if (b < groups) stage(b, b);
        cp_async_commit();
      }
      for (long long q = 0; q < groups; ++q) {
        const long long nq = q + COL_STAGES - 1;
        if (nq < groups) stage(nq, (int)(nq % COL_STAGES));
        cp_async_commit();
        cp_async_wait<COL_STAGES - 1>();  // group q landed
        const int b = (int)(q % COL_STAGES);
#pragma unroll
        for (int u = 0; u < COL_UNROLL; ++u) {
          const long long rr = row(q, u);
          if (rr < r1)
            sum_row(st[((b * COL_UNROLL + u) * 2) * 32],
                    st[((b * COL_UNROLL + u) * 2 + 1) * 32], rr);
        }
      }
    } else {
      for (long long q = 0; q < groups; ++q) {
        P xv[COL_UNROLL], gv[COL_UNROLL];
#pragma unroll
        for (int u = 0; u < COL_UNROLL; ++u) {
          const long long rr = row(q, u);
          if (rr < r1) {
            xv[u] = xp[(rr * C + c0) / V];
            gv[u] = gp[(rr * C + c0) / V];
          }
        }
#pragma unroll
        for (int u = 0; u < COL_UNROLL; ++u) {
          const long long rr = row(q, u);
          if (rr < r1) sum_row(xv[u], gv[u], rr);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) red[warp][lane * V + j] = acc[j];
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * V; i += blockDim.x) {
    const long long c = (long long)blockIdx.x * 32 * V + i;
    if (c < C) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < COL_WARPS; ++w) t += red[w][i];
      partial[(long long)blockIdx.y * C + c] = t;
    }
  }
}

// the staging ring of a mode-1 block with 16-byte packs, in bytes
constexpr int COL_SMEM = COL_WARPS * COL_STAGES * COL_UNROLL * 2 * 32 * 16;

// modes 1 and 3, second pass: ds[e, c] = gscale * the sum over slice
// e's bands (blockIdx.y = e); thread group q of a column sums bands q,
// q + FIN_GROUPS, ... in order, then the groups' sums are added in group
// order
__global__ void __launch_bounds__(32 * FIN_GROUPS)
fq_bwd_col_finish(const float* __restrict__ partial, float* __restrict__ ds,
                  long long C, int bands, float gscale) {
  __shared__ float red[FIN_GROUPS][32];
  const int cl = threadIdx.x & 31, q = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * 32 + cl;
  partial += (long long)blockIdx.y * bands * C;
  ds += (long long)blockIdx.y * C;
  float acc = 0.0f;
  if (c < C)
    for (int b = q; b < bands; b += FIN_GROUPS)
      acc += partial[(long long)b * C + c];
  red[q][cl] = acc;
  __syncthreads();
  if (q == 0 && c < C) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < FIN_GROUPS; ++i) t += red[i][cl];
    ds[c] = __fmul_rn(t, gscale);
  }
}

// mode 2: one warp per row; ds[r] = gscale * the row's sum
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
fq_bwd_row_kernel(const T* __restrict__ x, const float* __restrict__ s,
                  const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ ds, long long R, long long C, float qn,
                  float qp, float gscale) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (r >= R) return;
  const float sf = clamp_scale(s[r]);
  const long long packs = C / V;
  const long long base = r * packs;
  float acc = 0.0f;
  for (long long q = lane; q < packs; q += 32) {
    const Pack<T, V> xv = reinterpret_cast<const Pack<T, V>*>(x)[base + q];
    const Pack<T, V> gv = reinterpret_cast<const Pack<T, V>*>(g)[base + q];
    Pack<T, V> dv;
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc += fq_bwd_elem(xv.v[j], gv.v[j], sf, qn, qp, &dv.v[j]);
    reinterpret_cast<Pack<T, V>*>(dx)[base + q] = dv;
  }
  acc = warp_sum(acc);
  if (lane == 0) ds[r] = __fmul_rn(acc, gscale);
}

// block sum of one float per thread, in a fixed order; valid in thread 0
__device__ float block_sum(float v) {
  __shared__ float warps[THREADS / 32];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) t += warps[w];
  return t;
}

// mode 0: a grid of exactly n_blocks grid-stride blocks, one partial each
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
fq_bwd_tensor_kernel(const T* __restrict__ x, const float* __restrict__ s,
                     const T* __restrict__ g, T* __restrict__ dx,
                     float* __restrict__ partial, long long n_packs,
                     float qn, float qp) {
  const float sf = clamp_scale(s[0]);
  float acc = 0.0f;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
       p < n_packs; p += (long long)gridDim.x * THREADS) {
    const Pack<T, V> xv = reinterpret_cast<const Pack<T, V>*>(x)[p];
    const Pack<T, V> gv = reinterpret_cast<const Pack<T, V>*>(g)[p];
    Pack<T, V> dv;
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc += fq_bwd_elem(xv.v[j], gv.v[j], sf, qn, qp, &dv.v[j]);
    reinterpret_cast<Pack<T, V>*>(dx)[p] = dv;
  }
  const float t = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = t;
}

// mode 0, second pass: one block sums the partials in a fixed order
__global__ void __launch_bounds__(THREADS)
fq_bwd_tensor_finish(const float* __restrict__ partial,
                     float* __restrict__ ds, int n_blocks, float gscale) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_blocks; i += THREADS) acc += partial[i];
  const float t = block_sum(acc);
  if (threadIdx.x == 0) ds[0] = __fmul_rn(t, gscale);
}

// ---------------------------------------------------------------- launch

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte packs when the shape and every pointer allow it
int pack_width(int elem_bytes, long long C,
               std::initializer_list<const void*> ptrs) {
  const int V = 16 / elem_bytes;
  if (C % V) return 1;
  for (const void* p : ptrs)
    if (!aligned16(p)) return 1;
  return V;
}

// mode 0's grid: one block per 256 threads of 8-element loads, at most
// TENSOR_BLOCKS (each strides over the rest)
long long tensor_blocks(long long n) {
  const long long want = (n + THREADS * 8 - 1) / (THREADS * 8);
  return want < 1 ? 1 : (want > TENSOR_BLOCKS ? TENSOR_BLOCKS : want);
}

// the rows of a band of a slice in modes 1 and 3 (a multiple of
// COL_BAND): as many bands a slice as keep the E slices' bf16 strips'
// blocks within COL_TARGET_BLOCKS (one wave), at least one a slice and
// COL_BAND rows each. A function of E, R and C only, so the workspace is
// too.
long long col_band(long long E, long long R, long long C) {
  const long long strips = (C + COL_STRIP - 1) / COL_STRIP;
  long long bands = COL_TARGET_BLOCKS / (strips * E);
  const long long most = (R + COL_BAND - 1) / COL_BAND;
  bands = bands < most ? bands : most;
  if (bands < 1) bands = 1;
  const long long rows = (R + bands - 1) / bands;
  return (rows + COL_BAND - 1) / COL_BAND * COL_BAND;
}

// bands a slice
long long col_bands(long long E, long long R, long long C) {
  return R > 0 ? (R + col_band(E, R, C) - 1) / col_band(E, R, C) : 0;
}

// f32 partials the backward writes before its second pass
long long bwd_workspace(long long E, long long R, long long C, int mode) {
  if (mode == 1 || mode == 3) return E * col_bands(E, R, C) * C;
  if (mode == 0) return tensor_blocks(R * C);
  return 0;
}

int grid_for(long long work) {
  const long long want = (work + THREADS - 1) / THREADS;
  return (int)(want < 132LL * 64 ? (want > 0 ? want : 1) : 132LL * 64);
}

// mode 3: a grid row of blocks per slice, the whole grid no larger than
// one slice-less launch over the same elements
template <typename T, int V>
void fwd(const void* x, const void* s, void* out, long long E, long long R,
         long long C, int mode, float qn, float qp, cudaStream_t st) {
  const long long slice = R * C / V;            // packs a grid row covers
  const int rows = mode == 3 ? (int)E : 1;
  const long long packs = mode == 3 ? slice : E * slice;
  int per_row = grid_for(E * slice) / rows;
  if (per_row < 1) per_row = 1;
  const dim3 grid((unsigned)per_row, (unsigned)rows);
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(s);
  T* op = static_cast<T*>(out);
  if (packs * V <= 0xffffffffLL)
    fq_fwd_kernel<T, V, unsigned><<<grid, THREADS, 0, st>>>(
        xp, sp, op, packs, (unsigned)C, mode, qn, qp);
  else
    fq_fwd_kernel<T, V, long long><<<grid, THREADS, 0, st>>>(
        xp, sp, op, packs, C, mode, qn, qp);
}

template <typename T, int V>
void bwd(const void* x, const void* s, const void* g, void* dx,
         float* partial, float* ds, long long E, long long R, long long C,
         int mode, float qn, float qp, float gscale, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const float* sp = static_cast<const float*>(s);
  T* dp = static_cast<T*>(dx);
  if (mode == 1 || mode == 3) {
    const long long band = col_band(E, R, C);
    const int bands = (int)col_bands(E, R, C);
    const long long cols = 32LL * V;
    dim3 grid((unsigned)((C + cols - 1) / cols), (unsigned)(E * bands));
    const int smem = sizeof(Pack<T, V>) == 16 ? COL_SMEM : 0;
    if (smem > 48 * 1024) {
      static bool smem_set = false;       // once per instantiation
      if (!smem_set) {
        if (cudaFuncSetAttribute(fq_bwd_col_kernel<T, V>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem) != cudaSuccess)
          return;                         // the launcher reports the error
        smem_set = true;
      }
    }
    fq_bwd_col_kernel<T, V><<<grid, COL_WARPS * 32, smem, st>>>(
        xp, sp, gp, dp, partial, R, C, band, bands, qn, qp);
    fq_bwd_col_finish<<<dim3((unsigned)((C + 31) / 32), (unsigned)E),
                        32 * FIN_GROUPS, 0, st>>>(partial, ds, C, bands,
                                                  gscale);
  } else if (mode == 2) {
    const long long rows_per_block = THREADS / 32;
    fq_bwd_row_kernel<T, V><<<(unsigned)((R + rows_per_block - 1) /
                                         rows_per_block),
                              THREADS, 0, st>>>(xp, sp, gp, dp, ds, R, C, qn,
                                                qp, gscale);
  } else {
    const int n_partial = (int)tensor_blocks(R * C);
    fq_bwd_tensor_kernel<T, V><<<n_partial, THREADS, 0, st>>>(
        xp, sp, gp, dp, partial, R * C / V, qn, qp);
    fq_bwd_tensor_finish<<<1, THREADS, 0, st>>>(partial, ds, n_partial,
                                                gscale);
  }
}

}  // namespace

namespace {

// the shapes and modes a launcher takes: E slices of (R, C), E = 1 but in
// mode 3 (whose grid holds E rows of blocks a band, at most 65535 in all)
bool valid_shape(long long E, long long R, long long C, int mode, int dtype,
                 int bits) {
  return E >= 1 && E <= 4096 && R >= 0 && C >= 1 && mode >= 0 &&
         mode <= 3 && (mode == 3 || E == 1) && bits >= 2 && bits <= 16 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// x: E slices of (R, C) rows (E = 1 but in mode 3). dtype: 0 = f32,
// 1 = bf16. mode as above. Returns cudaGetLastError().
extern "C" int fake_quant_fwd_launch(const void* x, const void* s, void* out,
                                     long long E, long long R, long long C,
                                     int mode, int dtype, int bits,
                                     void* stream) {
  if (!valid_shape(E, R, C, mode, dtype, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = E * R * C;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const float qn = -(float)(1 << (bits - 1));
  const float qp = (float)((1 << (bits - 1)) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (pack_width(2, C, {x, out}) == 8)
      fwd<__nv_bfloat16, 8>(x, s, out, E, R, C, mode, qn, qp, st);
    else
      fwd<__nv_bfloat16, 1>(x, s, out, E, R, C, mode, qn, qp, st);
  } else {
    if (pack_width(4, C, {x, out}) == 4)
      fwd<float, 4>(x, s, out, E, R, C, mode, qn, qp, st);
    else
      fwd<float, 1>(x, s, out, E, R, C, mode, qn, qp, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's workspace, in f32 elements (0 in mode 2).
extern "C" long long fake_quant_bwd_workspace(long long E, long long R,
                                              long long C, int mode) {
  return bwd_workspace(E, R, C, mode);
}

// partial: partial_len f32, at least fake_quant_bwd_workspace(R, C, mode),
// else cudaErrorInvalidValue. ds: the scales' count of f32, gscale applied.
extern "C" int fake_quant_bwd_launch(const void* x, const void* s,
                                     const void* g, void* dx, void* partial,
                                     void* ds, long long E, long long R,
                                     long long C, int mode, int dtype,
                                     int bits, float gscale,
                                     long long partial_len, void* stream) {
  if (!valid_shape(E, R, C, mode, dtype, bits) ||
      partial_len < bwd_workspace(E, R, C, mode))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const float qn = -(float)(1 << (bits - 1));
  const float qp = (float)((1 << (bits - 1)) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* dsp = static_cast<float*>(ds);
  if (dtype == 1) {
    if (pack_width(2, C, {x, g, dx}) == 8)
      bwd<__nv_bfloat16, 8>(x, s, g, dx, pp, dsp, E, R, C, mode, qn, qp,
                            gscale, st);
    else
      bwd<__nv_bfloat16, 1>(x, s, g, dx, pp, dsp, E, R, C, mode, qn, qp,
                            gscale, st);
  } else {
    if (pack_width(4, C, {x, g, dx}) == 4)
      bwd<float, 4>(x, s, g, dx, pp, dsp, E, R, C, mode, qn, qp, gscale, st);
    else
      bwd<float, 1>(x, s, g, dx, pp, dsp, E, R, C, mode, qn, qp, gscale, st);
  }
  return static_cast<int>(cudaGetLastError());
}
