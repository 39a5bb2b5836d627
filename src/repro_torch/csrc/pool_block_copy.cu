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
//
// A second launcher, pool_block_copy_multi_launch, clones the pairs in
// every layer of up to four leaves (the engine's k_q, v_q, s_k, s_v) in
// one launch. A COW of one block at qwen2.5-3b's pool reads and writes
// 36 layers x (2 x 16 KB + 2 x 512 B), 1.2 MB each way, 0.73 us at
// 3.35 TB/s, while a launch of this size is mostly fixed cost: four
// launches a COW paid it four times. On the H100 that cost grows with
// the CUDA blocks a launch schedules, about 9 ns a block beyond a few
// hundred (tools/copy_ablate.py: the same copy cut into 1440, 360 and 144
// blocks took 14.1, 4.8 and 3.8 us, an empty kernel of 360 blocks 4.4),
// so one CUDA block copies a pair's block of every leaf in one layer:
// 36 blocks of 256 threads a pair at the serve shape. Each thread issues
// the loads of all its 16-byte vectors (up to VPT a leaf) before its
// first store, so a block waits for memory once, not once a vector. A
// leaf whose block bytes or addresses do not allow 16-byte vectors is
// copied byte by byte after the others. The leaves share rep and NB (the
// wrapper checks); each has its own base, layer stride and block bytes,
// passed by value.

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

constexpr int MAX_LEAVES = 4;
constexpr int VPT = 4;          // 16-byte vectors a thread holds per leaf

struct Leaves {
  uint8_t* x[MAX_LEAVES];
  long long stride[MAX_LEAVES];   // bytes between layers
  long long X[MAX_LEAVES];        // bytes of one block
};

// blockIdx.x = pair, blockIdx.y = layer: the pair's block in every leaf.
__global__ void __launch_bounds__(THREADS)
pool_block_copy_multi_kernel(const Leaves L, int n_leaves,
                             const int* __restrict__ pairs, int n, int NB) {
  const int i = blockIdx.x;
  const int d = pairs[n + i];
  if (d < 0 || d >= NB) return;                   // padding pair
  const int s = min(max(pairs[i], 0), NB - 1);
  const int4* from[MAX_LEAVES];
  int4* to[MAX_LEAVES];
  long long nv[MAX_LEAVES];       // 16-byte vectors; 0: copied by bytes
  long long most = 0;
#pragma unroll
  for (int l = 0; l < MAX_LEAVES; ++l) {
    nv[l] = 0;
    if (l >= n_leaves) continue;
    const long long layer = (long long)blockIdx.y * L.stride[l];
    const uint8_t* f = L.x[l] + layer + (long long)s * L.X[l];
    uint8_t* t = L.x[l] + layer + (long long)d * L.X[l];
    from[l] = reinterpret_cast<const int4*>(f);
    to[l] = reinterpret_cast<int4*>(t);
    if (L.X[l] % 16 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(t) % 16 == 0)
      nv[l] = L.X[l] / 16;
    most = max(most, nv[l]);
  }
  for (long long j0 = threadIdx.x; j0 < most; j0 += VPT * THREADS) {
    int4 v[MAX_LEAVES][VPT];
#pragma unroll
    for (int l = 0; l < MAX_LEAVES; ++l)
#pragma unroll
      for (int k = 0; k < VPT; ++k)
        if (j0 + k * THREADS < nv[l]) v[l][k] = from[l][j0 + k * THREADS];
#pragma unroll
    for (int l = 0; l < MAX_LEAVES; ++l)
#pragma unroll
      for (int k = 0; k < VPT; ++k)
        if (j0 + k * THREADS < nv[l]) to[l][j0 + k * THREADS] = v[l][k];
  }
#pragma unroll
  for (int l = 0; l < MAX_LEAVES; ++l) {
    if (l >= n_leaves || nv[l]) continue;
    const uint8_t* f = reinterpret_cast<const uint8_t*>(from[l]);
    uint8_t* t = reinterpret_cast<uint8_t*>(to[l]);
    for (long long j = threadIdx.x; j < L.X[l]; j += THREADS) t[j] = f[j];
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

// Leaf l: base x<l>, layer stride stride<l> bytes, block X<l> bytes; leaves
// past n_leaves are ignored. pairs: (2, n) int32, src ids then dst ids;
// dst outside [0, NB) is padding, src is clamped to [0, NB - 1]. All
// leaves hold rep layers of NB + 1 blocks. Returns the launch's CUDA error,
// or 0.
extern "C" int pool_block_copy_multi_launch(
    void* x0, long long stride0, long long X0, void* x1, long long stride1,
    long long X1, void* x2, long long stride2, long long X2, void* x3,
    long long stride3, long long X3, int n_leaves, const void* pairs, int n,
    int rep, int NB, void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || n < 0 || rep < 0 ||
      rep > 65535 || NB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  void* xs[MAX_LEAVES] = {x0, x1, x2, x3};
  const long long strides[MAX_LEAVES] = {stride0, stride1, stride2, stride3};
  const long long Xs[MAX_LEAVES] = {X0, X1, X2, X3};
  Leaves L = {};
  for (int l = 0; l < n_leaves; ++l) {
    if (Xs[l] < 0 || strides[l] < 0 || !xs[l])
      return static_cast<int>(cudaErrorInvalidValue);
    L.x[l] = static_cast<uint8_t*>(xs[l]);
    L.stride[l] = strides[l];
    L.X[l] = Xs[l];
  }
  if (n > 0 && rep > 0) {
    const dim3 grid(n, rep);
    pool_block_copy_multi_kernel<<<grid, THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        L, n_leaves, static_cast<const int*>(pairs), n, NB);
  }
  return static_cast<int>(cudaGetLastError());
}
