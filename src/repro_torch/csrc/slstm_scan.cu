// sLSTM recurrence (scalar memory) over a sequence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm_scan/kernel.py
// (slstm_scan / _kernel). gx (B, T, 4d) in bf16 or f32, r_h (d, 4d) in
// bf16 or f32, h and c carried in f32; hs (B, T, d) is written in gx's
// dtype. The TPU kernel's math, kept here:
//
//   g_t = f32(gx_t) + h_{t-1} . f32(r_h)        gates (i, f, z, o): the
//                                               four d-wide column blocks
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(z)
//   h_t = sigmoid(o) * tanh(c_t)
//
// The h . r_h product is computed here, in f32 FMAs; it differs from the
// plain version (torch's matmul) only in the order of its f32 sums.
//
// What bounds it on the H100: at B 8, d 768 a step is 8 x 768 x 3072
// multiply-adds (about 19 M) against r_h (4.7 MB in bf16, resident in the
// 50 MB L2 after the first step), so one step is bound by the f32 pipe
// and L2 rather than by memory; the T steps are sequential, so the
// per-step launch and barrier latency sets a floor the work bound does not
// count.
//
// Design (the simple one): one launch per time step, looped on the host
// on the caller's stream, so the kernel boundary publishes h for the next
// step. h lives in a ping-pong buffer (2, B, d) in global memory, c in
// place. A block owns 32 hidden indices j (one per lane) for up to 8 batch
// rows, and with them the four gate columns {j, d+j, 2d+j, 3d+j}: it
// updates its own c_j and h_j, so no gate is exchanged between blocks.
// The block's 8 warps split the reduction over h's d entries (warp w takes
// rows w, w+8, ...), stage their partial sums in shared memory, and the
// partials are added in warp order (a fixed order: the result does not
// depend on the launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BB = 8;                  // batch rows per block
constexpr int JT = 32;                 // hidden indices per block
constexpr int WARPS = 8;               // reduction split over h's entries
constexpr int THREADS = WARPS * 32;    // == BB * JT: one (b, j) per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <typename TG, typename TR>
__global__ void __launch_bounds__(THREADS)
    slstm_step_kernel(const TG* __restrict__ gx, const TR* __restrict__ rh,
                      const float* __restrict__ h_in,
                      float* __restrict__ h_out, float* __restrict__ c,
                      TG* __restrict__ hs, int B, int T, int d, int t) {
  extern __shared__ __align__(16) float smem[];
  float* h_sh = smem;                          // [BB][d]
  float* part = smem + BB * d;                 // [WARPS][4][BB][JT]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * JT, b0 = blockIdx.y * BB;
  const int nb = min(BB, B - b0);
  for (int i = threadIdx.x; i < BB * d; i += THREADS) {
    const int b = i / d;
    h_sh[i] = b < nb ? h_in[(size_t)b0 * d + i] : 0.0f;
  }
  __syncthreads();

  const int j = j0 + lane;
  const size_t d4 = 4 * (size_t)d;
  float acc[4][BB];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int b = 0; b < BB; ++b) acc[k][b] = 0.0f;
  if (j < d) {
    for (int m = warp; m < d; m += WARPS) {
      const TR* row = rh + (size_t)m * d4 + j;
      float r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = to_f32(row[(size_t)k * d]);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const float hb = h_sh[b * d + m];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k][b] = fmaf(hb, r[k], acc[k][b]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int b = 0; b < BB; ++b)
      part[((warp * 4 + k) * BB + b) * JT + lane] = acc[k][b];
  __syncthreads();

  // finalize: thread (b = warp, j = j0 + lane) owns c[b][j] and h[b][j]
  const int b = warp;
  if (b >= nb || j >= d) return;
  const size_t row_bt = (size_t)(b0 + b) * T + t;
  float g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      s = __fadd_rn(s, part[((w * 4 + k) * BB + b) * JT + lane]);
    g[k] = __fadd_rn(to_f32(gx[row_bt * d4 + (size_t)k * d + j]), s);
  }
  const size_t o = (size_t)(b0 + b) * d + j;
  const float cn = __fadd_rn(__fmul_rn(sigmoid(g[1]), c[o]),
                             __fmul_rn(sigmoid(g[0]), tanhf(g[2])));
  const float hn = __fmul_rn(sigmoid(g[3]), tanhf(cn));
  c[o] = cn;
  h_out[o] = hn;
  store(hn, hs + row_bt * d + j);
}

template <typename TG, typename TR>
int run(const void* gx, const void* rh, float* hbuf, float* c, void* hs,
        int B, int T, int d, cudaStream_t st) {
  // the shared-memory limit is raised once, to the largest size taken
  // (never inside a stream capture after the first call)
  static int smem_set = 0;
  const int smem = (int)((BB * d + WARPS * 4 * BB * JT) * sizeof(float));
  cudaError_t e;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(slstm_step_kernel<TG, TR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((unsigned)((d + JT - 1) / JT), (unsigned)((B + BB - 1) / BB));
  const size_t stride = (size_t)B * d;
  for (int t = 0; t < T; ++t) {
    slstm_step_kernel<TG, TR><<<grid, THREADS, smem, st>>>(
        static_cast<const TG*>(gx), static_cast<const TR*>(rh),
        hbuf + (t & 1) * stride, hbuf + ((t + 1) & 1) * stride, c,
        static_cast<TG*>(hs), B, T, d, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hbuf: (2, B, d) f32 with h0 in its first half; c: (B, d) f32 holding c0.
// After T steps h_T is in hbuf's half T % 2 and c_T in c. gx_bf16 / rh_bf16
// select bf16 (1) or f32 (0) operands; hs has gx's dtype. Requires
// 4 * (8 * d + 8192) bytes of shared memory per block (d <= 6144) and
// contiguous tensors (checked by the Python wrapper). Returns the first
// CUDA error, or 0.
extern "C" int slstm_scan_launch(const void* gx, const void* rh, void* hbuf,
                                 void* c, void* hs, int B, int T, int d,
                                 int gx_bf16, int rh_bf16, void* stream) {
  if (B < 0 || T < 0 || d < 1 || d > 6144)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(hbuf);
  float* cc = static_cast<float*>(c);
  if (gx_bf16 && rh_bf16)
    return run<__nv_bfloat16, __nv_bfloat16>(gx, rh, h, cc, hs, B, T, d, st);
  if (gx_bf16)
    return run<__nv_bfloat16, float>(gx, rh, h, cc, hs, B, T, d, st);
  if (rh_bf16)
    return run<float, __nv_bfloat16>(gx, rh, h, cc, hs, B, T, d, st);
  return run<float, float>(gx, rh, h, cc, hs, B, T, d, st);
}
