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
// contiguous (R, C) view; the scale is one of
//   mode 0: per tensor, s[0];
//   mode 1: per column, s[c] (a weight's output channel, the last axis);
//   mode 2: per row, s[r] (the tied head: embed.w is (vocab, d) and its
//           transpose is what the head multiplies, quantized per vocab
//           entry, so the channel is the row of the stored tensor).
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
// pointers allow, else one element per thread. The TPU kernel's (256, 512)
// VMEM tiles become: mode 1, blocks of 64 rows by 128 * VEC columns, one
// thread per VEC columns walking the rows (a warp reads 512 contiguous
// bytes per row), partials per 64-row tile; mode 2, one warp per row with
// a shuffle reduction; mode 0, a fixed grid of grid-stride blocks, one
// partial per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 256;
constexpr int COL_THREADS = 128;      // mode 1: threads per block
constexpr int ROW_TILE = 64;          // mode 1: rows summed into one partial
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

__device__ __forceinline__ long long scale_index(long long i, long long C,
                                                 int mode) {
  return mode == 0 ? 0 : (mode == 1 ? i % C : i / C);
}

// ---------------------------------------------------------------- forward

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
fq_fwd_kernel(const T* __restrict__ x, const float* __restrict__ s,
              T* __restrict__ out, long long n_packs, long long C, int mode,
              float qn, float qp) {
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
       p < n_packs; p += (long long)gridDim.x * THREADS) {
    const long long i0 = p * V;
    const Pack<T, V> xv = reinterpret_cast<const Pack<T, V>*>(x)[p];
    Pack<T, V> ov;
    // with C % V == 0 the V elements share one row: one scale index per
    // pack in modes 0 and 2, consecutive ones in mode 1
    const long long si = scale_index(i0, C, mode);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float sf = clamp_scale(s[mode == 1 ? si + j : si]);
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

// mode 1: block (COL_THREADS) covers COL_THREADS * V columns of ROW_TILE
// rows; partial[tile, c] is the tile's column sum
template <typename T, int V>
__global__ void __launch_bounds__(COL_THREADS)
fq_bwd_col_kernel(const T* __restrict__ x, const float* __restrict__ s,
                  const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ partial, long long R, long long C,
                  float qn, float qp) {
  const long long c0 =
      ((long long)blockIdx.x * COL_THREADS + threadIdx.x) * V;
  if (c0 >= C) return;
  const long long r0 = (long long)blockIdx.y * ROW_TILE;
  const long long r1 = r0 + ROW_TILE < R ? r0 + ROW_TILE : R;
  float sf[V], acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sf[j] = clamp_scale(s[c0 + j]);
    acc[j] = 0.0f;
  }
  for (long long r = r0; r < r1; ++r) {
    const long long p = (r * C + c0) / V;
    const Pack<T, V> xv = reinterpret_cast<const Pack<T, V>*>(x)[p];
    const Pack<T, V> gv = reinterpret_cast<const Pack<T, V>*>(g)[p];
    Pack<T, V> dv;
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc[j] += fq_bwd_elem(xv.v[j], gv.v[j], sf[j], qn, qp, &dv.v[j]);
    reinterpret_cast<Pack<T, V>*>(dx)[p] = dv;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) partial[blockIdx.y * C + c0 + j] = acc[j];
}

// mode 1, second pass: ds[c] = gscale * sum over tiles, in tile order
__global__ void __launch_bounds__(THREADS)
fq_bwd_col_finish(const float* __restrict__ partial, float* __restrict__ ds,
                  long long C, int n_tiles, float gscale) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  float acc = 0.0f;
  for (int t = 0; t < n_tiles; ++t) acc += partial[(long long)t * C + c];
  ds[c] = __fmul_rn(acc, gscale);
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

// f32 partials the backward writes before its second pass
long long bwd_workspace(long long R, long long C, int mode) {
  if (mode == 1) return (R + ROW_TILE - 1) / ROW_TILE * C;
  if (mode == 0) return tensor_blocks(R * C);
  return 0;
}

int grid_for(long long work) {
  const long long want = (work + THREADS - 1) / THREADS;
  return (int)(want < 132LL * 64 ? (want > 0 ? want : 1) : 132LL * 64);
}

template <typename T, int V>
void fwd(const void* x, const void* s, void* out, long long n, long long C,
         int mode, float qn, float qp, cudaStream_t st) {
  const long long packs = n / V;
  fq_fwd_kernel<T, V><<<grid_for(packs), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<T*>(out), packs, C, mode, qn, qp);
}

template <typename T, int V>
void bwd(const void* x, const void* s, const void* g, void* dx,
         float* partial, float* ds, long long R, long long C, int mode,
         float qn, float qp, float gscale, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const float* sp = static_cast<const float*>(s);
  T* dp = static_cast<T*>(dx);
  if (mode == 1) {
    const int tiles = (int)((R + ROW_TILE - 1) / ROW_TILE);
    const long long cols = (long long)COL_THREADS * V;
    dim3 grid((unsigned)((C + cols - 1) / cols), (unsigned)tiles);
    fq_bwd_col_kernel<T, V><<<grid, COL_THREADS, 0, st>>>(
        xp, sp, gp, dp, partial, R, C, qn, qp);
    fq_bwd_col_finish<<<(unsigned)((C + THREADS - 1) / THREADS), THREADS, 0,
                        st>>>(partial, ds, C, tiles, gscale);
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

// dtype: 0 = f32, 1 = bf16. mode as above. Returns cudaGetLastError().
extern "C" int fake_quant_fwd_launch(const void* x, const void* s, void* out,
                                     long long R, long long C, int mode,
                                     int dtype, int bits, void* stream) {
  if (R < 0 || C < 1 || mode < 0 || mode > 2 || bits < 2 || bits > 16 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = R * C;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const float qn = -(float)(1 << (bits - 1));
  const float qp = (float)((1 << (bits - 1)) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (pack_width(2, C, {x, out}) == 8)
      fwd<__nv_bfloat16, 8>(x, s, out, n, C, mode, qn, qp, st);
    else
      fwd<__nv_bfloat16, 1>(x, s, out, n, C, mode, qn, qp, st);
  } else {
    if (pack_width(4, C, {x, out}) == 4)
      fwd<float, 4>(x, s, out, n, C, mode, qn, qp, st);
    else
      fwd<float, 1>(x, s, out, n, C, mode, qn, qp, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's workspace, in f32 elements (0 in mode 2).
extern "C" long long fake_quant_bwd_workspace(long long R, long long C,
                                              int mode) {
  return bwd_workspace(R, C, mode);
}

// partial: partial_len f32, at least fake_quant_bwd_workspace(R, C, mode),
// else cudaErrorInvalidValue. ds: the scales' count of f32, gscale applied.
extern "C" int fake_quant_bwd_launch(const void* x, const void* s,
                                     const void* g, void* dx, void* partial,
                                     void* ds, long long R, long long C,
                                     int mode, int dtype, int bits,
                                     float gscale, long long partial_len,
                                     void* stream) {
  if (R < 0 || C < 1 || mode < 0 || mode > 2 || bits < 2 || bits > 16 ||
      (dtype != 0 && dtype != 1) || partial_len < bwd_workspace(R, C, mode))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  const float qn = -(float)(1 << (bits - 1));
  const float qp = (float)((1 << (bits - 1)) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* dsp = static_cast<float*>(ds);
  if (dtype == 1) {
    if (pack_width(2, C, {x, g, dx}) == 8)
      bwd<__nv_bfloat16, 8>(x, s, g, dx, pp, dsp, R, C, mode, qn, qp, gscale,
                            st);
    else
      bwd<__nv_bfloat16, 1>(x, s, g, dx, pp, dsp, R, C, mode, qn, qp, gscale,
                            st);
  } else {
    if (pack_width(4, C, {x, g, dx}) == 4)
      bwd<float, 4>(x, s, g, dx, pp, dsp, R, C, mode, qn, qp, gscale,
                    st);
    else
      bwd<float, 1>(x, s, g, dx, pp, dsp, R, C, mode, qn, qp, gscale,
                    st);
  }
  return static_cast<int>(cudaGetLastError());
}
