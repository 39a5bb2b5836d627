// Packed-int4-weight x int8-activation matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/w4a8/kernel.py
// (w4a8_matmul / _kernel / _unpack_nibbles):
//
//   y[m, n] = bf16( ((float)acc[m, n] * s_x[m]) * s_w[n] (+ b[n]) )
//   acc[m, n] = sum_k x_q[m, k] * w[n, k]                  (int32, exact)
//
// x_q (M, K) int8 row-major; w_packed (N, K/2) uint8, two int4 per byte
// along K, low nibble = even k; s_x (M) f32; s_w (N) f32; b (N) f32 or
// null; y (M, N) bf16.
//
// What bounds it on the H100: on the serving path M is the slot count at
// decode (<= 8) and one prefill batch at admission, so the work is a
// weight-streaming GEMV — each packed weight byte is used by M rows only,
// far below the ~590 int8 operations per byte at which the tensor cores,
// not HBM (3.35 TB/s), would be the limit. The packed weights are the
// bytes that count.
//
// Design: the TPU kernel tiles (256, 256, 512) for the MXU and pads M to
// 256; here nothing is padded. One warp owns NC output columns and walks
// the whole K axis: each lane loads 16 bytes (32 weights) of a column per
// step, so a warp reads 512 contiguous bytes of a weight row per load.
// Nibbles are sign-extended in registers (__vsub4 on the xor-biased
// bytes) and reordered into k order (__byte_perm), then __dp4a multiplies
// four int8 x int8 pairs into an int32 sum. The unpacked weights stay in
// registers for all MT activation rows of the block, and each activation
// word is reused by the warp's NC columns. Blocks tile N by WARPS * NC
// columns and M by MT rows. The epilogue applies the scales in the
// reference's order with __fmul_rn / __fadd_rn (never contracted into an
// FMA), so the result is bitwise equal to the plain PyTorch version.
//
// Requirements (checked by the Python wrapper): K % 32 == 0, x and w
// 16-byte aligned, every tensor contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // warps per block
constexpr int NC = 4;                    // output columns per warp
constexpr int MT = 8;                    // activation rows per block
constexpr int COLS_PER_BLOCK = WARPS * NC;
static_assert(MT * NC == 32, "one output per lane after the reduction");

// 8 packed int4 (one 32-bit word, k0..k7) -> two words of 4 int8 in k order
__device__ __forceinline__ void unpack8(uint32_t w, int& a, int& b) {
  uint32_t lo = w & 0x0F0F0F0Fu;          // k0, k2, k4, k6
  uint32_t hi = (w >> 4) & 0x0F0F0F0Fu;   // k1, k3, k5, k7
  // sign-extend each nibble to a byte: (v ^ 8) - 8, per byte, no borrow
  lo = __vsub4(lo ^ 0x08080808u, 0x08080808u);
  hi = __vsub4(hi ^ 0x08080808u, 0x08080808u);
  a = (int)__byte_perm(lo, hi, 0x5140);   // k0, k1, k2, k3
  b = (int)__byte_perm(lo, hi, 0x7362);   // k4, k5, k6, k7
}

__global__ void __launch_bounds__(WARPS * 32)
w4a8_matmul_kernel(const int8_t* __restrict__ x,
                   const uint8_t* __restrict__ w,
                   const float* __restrict__ sx,
                   const float* __restrict__ sw,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out,
                   int M, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * WARPS + warp) * NC;
  const int m0 = blockIdx.y * MT;
  const int nchunks = K >> 5;             // 32 k: 16 bytes of w, 32 of x
  const size_t wrow = (size_t)(K >> 1);

  int acc[MT][NC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0;

  for (int c = lane; c < nchunks; c += 32) {
    int wk[NC][8];                        // wk[j][t]: k = 4t .. 4t+3
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int n = n0 + j;
      if (n < N) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            w + (size_t)n * wrow + (size_t)c * 16);
        unpack8(v.x, wk[j][0], wk[j][1]);
        unpack8(v.y, wk[j][2], wk[j][3]);
        unpack8(v.z, wk[j][4], wk[j][5]);
        unpack8(v.w, wk[j][6], wk[j][7]);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) wk[j][t] = 0;
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + i;
      if (m < M) {
        const int4* xp = reinterpret_cast<const int4*>(
            x + (size_t)m * K + (size_t)c * 32);
        const int4 x0 = xp[0];
        const int4 x1 = xp[1];
        const int xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int t = 0; t < 8; ++t)
            acc[i][j] = __dp4a(wk[j][t], xs[t], acc[i][j]);
      }
    }
  }

  // every lane ends with the full sums; lane (i * NC + j) stores (i, j)
  int mine = 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      int v = acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
      if (lane == i * NC + j) mine = v;
    }
  const int m = m0 + lane / NC;
  const int n = n0 + lane % NC;
  if (m < M && n < N) {
    float y = __fmul_rn(__fmul_rn(__int2float_rn(mine), sx[m]), sw[n]);
    if (bias != nullptr) y = __fadd_rn(y, bias[n]);
    out[(size_t)m * N + n] = __float2bfloat16_rn(y);
  }
}

}  // namespace

extern "C" int w4a8_matmul_launch(const void* x, const void* w,
                                  const void* sx, const void* sw,
                                  const void* bias, void* out, int M, int N,
                                  int K, void* stream) {
  if (M > 0 && N > 0) {
    const dim3 grid((N + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK,
                    (M + MT - 1) / MT);
    w4a8_matmul_kernel<<<grid, WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(sx), static_cast<const float*>(sw),
        static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
