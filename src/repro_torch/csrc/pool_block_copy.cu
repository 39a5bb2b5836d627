// In-place copy of whole pool blocks of a layer-stacked paged KV leaf, for
// Hopper (sm_90a): the copy-on-write clone of the prefix-shared cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kvq_attn/kernel.py
// (pool_block_copy / _copy_kernel):
//
//   x[r, dst[i]] <- x[r, src[i]]   for every layer r and pair i, dst[i] < NB
//
// x is viewed as (rep, NB + 1, X) bytes with a row stride of `rep_stride`
// bytes, the last block a write sink; src / dst (n) int32 block ids. Pairs
// whose dst lies outside [0, NB) are padding and write nothing; src is
// clamped to [0, NB - 1] as in the reference. Blocks not named in dst are
// never touched. The copy is bitwise (it moves bytes).
//
// What bounds it on the H100: bytes, X read and X written per (layer,
// pair), with no arithmetic.
//
// Design: the TPU grid (rep, n) DMAs one block per step into an aliased
// output. Here one CUDA block per (pair, layer) copies the X bytes with
// 16-byte vector loads and stores when X and the addresses allow (the int8
// payload and the f32 scale blocks both do at the engine's sizes), byte by
// byte otherwise. The TPU's rule that padding pairs self-copy src[0] exists
// for its static grid; here a padding pair's CUDA block simply returns.
// Pairs never race: the engine's dst blocks are fresh and never a src.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pool_block_copy_kernel(uint8_t* __restrict__ x, const int* __restrict__ src,
                       const int* __restrict__ dst, long long rep_stride,
                       long long X, int NB) {
  const int i = blockIdx.x;
  const int r = blockIdx.y;
  const int d = dst[i];
  if (d < 0 || d >= NB) return;                   // padding pair
  const int s = min(max(src[i], 0), NB - 1);
  const uint8_t* from = x + r * rep_stride + (long long)s * X;
  uint8_t* to = x + r * rep_stride + (long long)d * X;
  const bool vec = (X % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(from) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(to) % 16 == 0);
  if (vec) {
    const int4* f = reinterpret_cast<const int4*>(from);
    int4* t = reinterpret_cast<int4*>(to);
    for (long long j = threadIdx.x; j < X / 16; j += THREADS) t[j] = f[j];
  } else {
    for (long long j = threadIdx.x; j < X; j += THREADS) to[j] = from[j];
  }
}

}  // namespace

extern "C" int pool_block_copy_launch(void* x, const void* src,
                                      const void* dst, int n, int rep,
                                      long long rep_stride, long long X,
                                      int NB, void* stream) {
  if (n < 0 || rep < 0 || X < 0 || NB < 1 || rep > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && rep > 0 && X > 0) {
    const dim3 grid(n, rep);
    pool_block_copy_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(x), static_cast<const int*>(src),
        static_cast<const int*>(dst), rep_stride, X, NB);
  }
  return static_cast<int>(cudaGetLastError());
}
