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
// Two carries, a template constant (kGx) of both routes, so the f32 code
// is unchanged by the other:
//   f32 (kGx false): the math above, h carried in f32 (the TPU kernel's);
//   gx  (kGx true):  the reference model's cell (src/repro/models/
//       recurrent.py:_slstm_cell), h carried in gx's dtype:
//         rh  = rnd(h_{t-1} . r_h)     the f32 sum rounded once
//         g_t = rnd(gx_t + rh)         added in f32, rounded again
//         c_t, h_t in f32 as above, then h_t = rnd(h_t)
//       with rnd round-to-nearest-even to gx's dtype (__float2bfloat16_rn).
//       The carried h goes through the same f32 buffer (hbuf) as in the
//       f32 carry, holding bf16 values: exact, and the h exchange code is
//       the same for both. With f32 gx rnd is the identity and the launcher
//       runs the f32 carry, the same function.
//
// What bounds it on the H100: at B 8, d 768 a step is 8 x 768 x 3072
// multiply-adds (about 19 M, 0.56 us at 67 TF/s f32) against r_h (4.7 MB
// in bf16). The T steps are sequential, so what the bound does not count
// sets the time: per step, the hand-over of h between the CTAs and, if
// r_h is not kept on chip, re-reading it.
//
// Two routes, chosen by the launcher (`plan_resident`):
//
// 1. Resident (the TPU kernel's design: r_h pinned on chip for the whole
//    sequence). One cooperative launch runs all T steps. CTA i owns the
//    hidden indices [i * per, (i + 1) * per) with their four gate columns
//    {j, d+j, 2d+j, 3d+j} and keeps those columns of r_h in shared memory,
//    in r_h's dtype (bf16 -> f32 is exact), for the whole call. Sizing
//    rule: per = ceil(d / SMs), grid = ceil(d / per) CTAs of 512 threads,
//    one an SM (d 768 on 132 SMs: per 6, 128 CTAs, 36 KB of bf16 r_h and
//    24 KB of h each). Each step, per batch tile of 8 rows: the CTA reads
//    h_{t-1} from a ping-pong buffer in global memory (through L2: __ldcg);
//    two warps compute one hidden index's 4 x 8 gate sums, each over half
//    of h's entries, and 8 indices are worked at once; the first warp
//    applies the gates to its own c_j / h_j and writes h_t into the other
//    half of the buffer and hs; then all CTAs meet at a grid barrier, a
//    counter in a scratch int the wrapper zeroes before the launch
//    (release: the block's writes, __syncthreads, red.release.gpu on the
//    counter; acquire: ld.acquire.gpu on it). A spin that outlasts 2^26
//    polls traps, so a fault shows as a CUDA error and not as a hang. The
//    cooperative launch refuses a grid that cannot be co-resident.
//    Taken when the slice and one tile of h fit a block's opt-in shared
//    memory and the grid is co-resident: on an H100 d up to 1694 with
//    bf16 r_h, 1200 with f32 (xlstm-125m's d 768, every reduced config).
// 2. Step (for d beyond the resident route's shared memory, up to 6144):
//    one launch per time step, the kernel boundary publishing h. A block
//    owns 32 hidden indices for up to 8 batch rows; its 8 warps split the
//    reduction over h's entries (warp w takes rows w, w+8, ...) and the
//    partials are added in warp order. r_h is read from L2 each step.
//
// Sum order. Each (b, column) sum is fixed by the route alone, never by
// B, the batch tile or the grid, so hs is bitwise the same from call to
// call and a batch row is bitwise the same alone and in a batch. Resident:
// lane l of the warp for half q sums m = 32q + l, 32q + l + 64, ... with
// fmaf from 0; each warp's 32 partials are added pairwise across the lane
// bits 4, 3, 2, 1, 0 in that order (`reduce_scatter32`); then half 0's sum
// plus half 1's, then gx plus that. Step: as stated above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BB = 8;                  // batch rows per tile (both routes)
constexpr int JT = 32;                 // step route: hidden indices a block
constexpr int WARPS = 8;               // warps a block (both routes)
constexpr int THREADS = WARPS * 32;    // step route: one (b, j) a thread
constexpr int SLOTS = 8;               // resident: indices a CTA works at once
constexpr int RTHREADS = 2 * SLOTS * 32;   // two warps (m halves) an index
constexpr int MAX_D = 6144;            // the step route's shared memory
constexpr int BAR_INTS = 1;            // the resident route's scratch
constexpr long long SPIN_LIMIT = 1LL << 26;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// x rounded to T and back to f32 (the identity for f32)
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A gate's pre-activation from gx_t and the complete h . r_h sum s
template <bool kGx, typename TG>
__device__ __forceinline__ float preact(float gx, float s) {
  return kGx ? rnd<TG>(__fadd_rn(gx, rnd<TG>(s))) : __fadd_rn(gx, s);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// c_t and h_t from the four gate pre-activations and c_{t-1}
__device__ __forceinline__ void cell(float gi, float gf, float gz, float go,
                                     float& c, float& h) {
  c = __fadd_rn(__fmul_rn(sigmoid(gf), c), __fmul_rn(sigmoid(gi), tanhf(gz)));
  h = __fmul_rn(sigmoid(go), tanhf(c));
}

// ---------------------------------------------------------------- step route

template <typename TG, typename TR, bool kGx>
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
    g[k] = preact<kGx, TG>(to_f32(gx[row_bt * d4 + (size_t)k * d + j]), s);
  }
  const size_t o = (size_t)(b0 + b) * d + j;
  float cn = c[o], hn;
  cell(g[0], g[1], g[2], g[3], cn, hn);
  if (kGx) hn = rnd<TG>(hn);
  c[o] = cn;
  h_out[o] = hn;
  store(hn, hs + row_bt * d + j);
}

// ------------------------------------------------------------ resident route

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// All CTAs of the cooperative grid meet here; the counter grows by the
// grid size at every barrier, and `target` is the count that ends this one.
__device__ __forceinline__ void grid_barrier(int* bar, int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    // release: cumulative over the block's writes ordered by the barrier
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;"
                 :: "l"(bar) : "memory");
    long long polls = 0;
    while (ld_acquire(bar) < target)
      if (++polls > SPIN_LIMIT) __trap();
  }
  __syncthreads();
}

// One batch tile of h_{t-1} (n of its BB * d floats; the rest zero) from
// global memory through L2 into shared memory, HV loads in flight a thread
__device__ __forceinline__ void load_h(float* h_sh, const float* h, int n,
                                       int d) {
  constexpr int HV = 8;
  if ((d & 3) == 0) {                  // rows start 16-byte aligned
    const float4* h4 = reinterpret_cast<const float4*>(h);
    float4* s4 = reinterpret_cast<float4*>(h_sh);
    const int n4 = n >> 2, all4 = (BB * d) >> 2;
    for (int i0 = threadIdx.x; i0 < all4; i0 += HV * RTHREADS) {
      float4 v[HV];
#pragma unroll
      for (int u = 0; u < HV; ++u) {
        const int i = i0 + u * RTHREADS;
        v[u] = i < n4 ? __ldcg(h4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < HV; ++u)
        if (i0 + u * RTHREADS < all4) s4[i0 + u * RTHREADS] = v[u];
    }
    return;
  }
  for (int i0 = threadIdx.x; i0 < BB * d; i0 += HV * RTHREADS) {
    float v[HV];
#pragma unroll
    for (int u = 0; u < HV; ++u) {
      const int i = i0 + u * RTHREADS;
      v[u] = i < n ? __ldcg(h + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < HV; ++u)
      if (i0 + u * RTHREADS < BB * d) h_sh[i0 + u * RTHREADS] = v[u];
  }
}

// The four gate weights of (hidden index jl of the slice, row m)
__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&r)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  r[0] = __uint_as_float(v.x << 16);
  r[1] = __uint_as_float(v.x & 0xffff0000u);
  r[2] = __uint_as_float(v.y << 16);
  r[3] = __uint_as_float(v.y & 0xffff0000u);
}

// One level of `reduce_scatter32`: lanes that differ in bit H exchange
// halves of v[0, 2H) and add, keeping the half their bit selects.
template <int H>
__device__ __forceinline__ void exchange_add(float (&v)[32], int lane) {
  const bool hi = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = hi ? v[i + H] : v[i];
    const float send = hi ? v[i] : v[i + H];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, H));
  }
}

// v[a] holds this lane's partial of accumulator a (a = k * 8 + b). Returns
// the sum over the warp's 32 lanes of accumulator `lane`: halves are
// exchanged and added across lane bit 4, then 3, 2, 1, 0 (31 shuffles).
// Each level is a template constant, so v stays in registers.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  exchange_add<16>(v, lane);
  exchange_add<8>(v, lane);
  exchange_add<4>(v, lane);
  exchange_add<2>(v, lane);
  exchange_add<1>(v, lane);
  return v[0];
}

template <typename TG, typename TR, bool kGx>
__global__ void __launch_bounds__(RTHREADS, 1)
    slstm_resident_kernel(const TG* __restrict__ gx,
                          const TR* __restrict__ rh, float* hbuf,
                          float* c, TG* __restrict__ hs, int* bar, int B,
                          int T, int d, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* h_sh = reinterpret_cast<float*>(smem_raw);            // [BB][d]
  float* part = h_sh + BB * d;                 // [2 rounds][SLOTS][32]
  TR* r_sh = reinterpret_cast<TR*>(part + 2 * SLOTS * 32);
  //                                                     [per][d][4 gates]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp % SLOTS, hf = warp / SLOTS;   // hf: the m half
  const int j0 = blockIdx.x * per;
  const int nj = min(per, d - j0);
  const int rounds = (nj + SLOTS - 1) / SLOTS;
  const size_t d4 = 4 * (size_t)d;
  for (int i = threadIdx.x; i < nj * 4 * d; i += RTHREADS) {
    const int jl = i % nj, q = i / nj, k = q & 3, m = q >> 2;
    r_sh[((size_t)jl * d + m) * 4 + k] =
        rh[(size_t)m * d4 + (size_t)k * d + j0 + jl];
  }
  const size_t half = (size_t)B * d;
  const int kk = lane >> 3, bl = lane & 7;   // this lane's (gate, row)
  // The warps of half 0 finish each hidden index; their assignments run
  // in the order (t, tile b0, index jl). The gx and c an assignment needs
  // are read one assignment ahead (for the next step's first one, before
  // the grid barrier); where the next assignment is this one a step on
  // (B <= 8, at most SLOTS indices a CTA), c stays in a register.
  auto fetch_gx = [&](int t_, int b0_, int jl_) {
    return bl < min(BB, B - b0_)
               ? to_f32(gx[((size_t)(b0_ + bl) * T + t_) * d4 +
                           (size_t)kk * d + j0 + jl_])
               : 0.0f;
  };
  auto fetch_c = [&](int b0_, int jl_) {
    return lane < min(BB, B - b0_)
               ? __ldcg(c + (size_t)(b0_ + lane) * d + j0 + jl_)
               : 0.0f;
  };
  const bool finisher = hf == 0 && slot < nj;
  float gx_next = 0.0f, c_next = 0.0f;
  if (finisher) {
    gx_next = fetch_gx(0, 0, slot);
    c_next = fetch_c(0, slot);
  }
  for (int t = 0; t < T; ++t) {
    const float* h_in = hbuf + (t & 1) * half;
    float* h_out = hbuf + ((t + 1) & 1) * half;
    for (int b0 = 0; b0 < B; b0 += BB) {
      const int nb = min(BB, B - b0);
      __syncthreads();               // r_sh written; the last tile read
      load_h(h_sh, h_in + (size_t)b0 * d, nb * d, d);
      __syncthreads();
      for (int k = 0; k < rounds; ++k) {
        const int jl = slot + k * SLOTS, j = j0 + jl;
        float* pk = part + ((k & 1) * SLOTS + slot) * 32;
        float s = 0.0f, gxv = 0.0f, cn = 0.0f;
        bool again = false;
        if (jl < nj) {
          if (hf == 0) {
            gxv = gx_next;
            cn = c_next;
            int tn = t, bn = b0, jn = jl + SLOTS;  // the next assignment
            if (jn >= nj) {
              jn = slot;
              bn += BB;
              if (bn >= B) bn = 0, ++tn;
            }
            again = tn == t + 1 && bn == b0 && jn == jl;
            if (tn < T) gx_next = fetch_gx(tn, bn, jn);
            if (tn < T && !again) c_next = fetch_c(bn, jn);
          }
          float acc[32];
#pragma unroll
          for (int a = 0; a < 32; ++a) acc[a] = 0.0f;
          const TR* rj = r_sh + (size_t)jl * d * 4;
#pragma unroll 4
          for (int m = hf * 32 + lane; m < d; m += 64) {
            float r[4];
            load4(rj + (size_t)m * 4, r);
#pragma unroll
            for (int b = 0; b < BB; ++b) {
              const float hb = h_sh[b * d + m];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[q * 8 + b] = fmaf(hb, r[q], acc[q * 8 + b]);
            }
          }
          s = reduce_scatter32(acc, lane);
          if (hf == 1) pk[lane] = s;
        }
        __syncthreads();             // half 1's sums in part[k & 1]
        if (jl < nj && hf == 0) {
          const float g = preact<kGx, TG>(gxv, __fadd_rn(s, pk[lane]));
          const float gi = __shfl_sync(FULL, g, bl);
          const float gf = __shfl_sync(FULL, g, 8 + bl);
          const float gz = __shfl_sync(FULL, g, 16 + bl);
          const float go = __shfl_sync(FULL, g, 24 + bl);
          if (lane < nb) {
            const size_t o = (size_t)(b0 + lane) * d + j;
            float hn;
            cell(gi, gf, gz, go, cn, hn);
            if (kGx) hn = rnd<TG>(hn);
            c[o] = cn;
            h_out[o] = hn;
            store(hn, hs + ((size_t)(b0 + lane) * T + t) * d + j);
          }
          if (again) c_next = cn;
        }
      }
    }
    if (t + 1 < T) grid_barrier(bar, (t + 1) * gridDim.x);
  }
}

// ------------------------------------------------------------------ launcher

struct Plan {
  int grid, per, smem;
};

// The resident route's grid and shared memory for d, or 0 if it does not
// fit this device (see the sizing rule at the top); sets the kernel's
// shared-memory limit to the device's opt-in maximum once.
template <typename TG, typename TR, bool kGx>
int plan_resident(int d, Plan* p) {
  static int smem_set = 0;
  int dev, sms, max_smem;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess && max_smem > smem_set) {
    e = cudaFuncSetAttribute(slstm_resident_kernel<TG, TR, kGx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
    if (e == cudaSuccess) smem_set = max_smem;
  }
  if (e != cudaSuccess) return -static_cast<int>(e);
  p->per = (d + sms - 1) / sms;
  p->grid = (d + p->per - 1) / p->per;
  const size_t smem = sizeof(float) * (BB * (size_t)d + 2 * SLOTS * 32) +
                      sizeof(TR) * 4 * (size_t)p->per * d;
  if (smem > (size_t)max_smem) return 0;
  p->smem = static_cast<int>(smem);
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, slstm_resident_kernel<TG, TR, kGx>, RTHREADS, p->smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return occ * sms >= p->grid ? 1 : 0;
}

template <typename TG, typename TR, bool kGx>
int run_resident(const void* gx, const void* rh, float* hbuf, float* c,
                 void* hs, int* bar, int B, int T, int d, cudaStream_t st) {
  Plan p;
  const int fits = plan_resident<TG, TR, kGx>(d, &p);
  if (fits < 0) return -fits;
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  const TG* gx_ = static_cast<const TG*>(gx);
  const TR* rh_ = static_cast<const TR*>(rh);
  TG* hs_ = static_cast<TG*>(hs);
  void* args[] = {&gx_, &rh_, &hbuf, &c, &hs_, &bar, &B, &T, &d, &p.per};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(slstm_resident_kernel<TG, TR, kGx>),
      dim3(p.grid), dim3(RTHREADS), args, p.smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG, typename TR, bool kGx>
int run_steps(const void* gx, const void* rh, float* hbuf, float* c,
              void* hs, int B, int T, int d, cudaStream_t st) {
  // the shared-memory limit is raised once, to the largest size taken
  // (never inside a stream capture after the first call)
  static int smem_set = 0;
  const int smem = (int)((BB * d + WARPS * 4 * BB * JT) * sizeof(float));
  cudaError_t e;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(slstm_step_kernel<TG, TR, kGx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((unsigned)((d + JT - 1) / JT), (unsigned)((B + BB - 1) / BB));
  const size_t stride = (size_t)B * d;
  for (int t = 0; t < T; ++t) {
    slstm_step_kernel<TG, TR, kGx><<<grid, THREADS, smem, st>>>(
        static_cast<const TG*>(gx), static_cast<const TR*>(rh),
        hbuf + (t & 1) * stride, hbuf + ((t + 1) & 1) * stride, c,
        static_cast<TG*>(hs), B, T, d, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TG, typename TR, bool kGx>
int route_for(int d) {
  Plan p;
  const int fits = plan_resident<TG, TR, kGx>(d, &p);
  return fits < 0 ? fits : (fits ? 1 : 2);
}

template <typename TG, typename TR, bool kGx>
int run(const void* gx, const void* rh, float* hbuf, float* c, void* hs,
        int* bar, int B, int T, int d, int route, cudaStream_t st) {
  if (route == 0) {
    route = route_for<TG, TR, kGx>(d);
    if (route < 0) return -route;
  }
  if (route == 1)
    return run_resident<TG, TR, kGx>(gx, rh, hbuf, c, hs, bar, B, T, d, st);
  return run_steps<TG, TR, kGx>(gx, rh, hbuf, c, hs, B, T, d, st);
}

using bf16 = __nv_bfloat16;

}  // namespace

// The route the launcher takes for d when asked for none: 1 resident,
// 2 step, or a negated CUDA error. Depends on the current device.
// carry_gx as for the launcher.
extern "C" int slstm_scan_route(int d, int gx_bf16, int rh_bf16,
                                int carry_gx) {
  if (d < 1 || d > MAX_D || carry_gx < 0 || carry_gx > 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  const bool gxc = carry_gx && gx_bf16;
  if (gx_bf16 && rh_bf16)
    return gxc ? route_for<bf16, bf16, true>(d)
               : route_for<bf16, bf16, false>(d);
  if (gx_bf16)
    return gxc ? route_for<bf16, float, true>(d)
               : route_for<bf16, float, false>(d);
  if (rh_bf16) return route_for<float, bf16, false>(d);
  return route_for<float, float, false>(d);
}

// hbuf: (2, B, d) f32 with h0 in its first half; c: (B, d) f32 holding c0.
// After T steps h_T is in hbuf's half T % 2 and c_T in c. gx_bf16 / rh_bf16
// select bf16 (1) or f32 (0) operands; hs has gx's dtype. carry_gx: 1
// the gx carry (hbuf then holds values of gx's dtype: pass h0 rounded to
// it), 0 the f32 carry. bar: bar_len
// int32, zeroed on the stream before the call (the resident route's grid
// barrier counts in bar[0]); a shorter one is refused. route: 0 the rule
// above, 1 resident (refused where it does not fit), 2 step. Requires
// d <= 6144 and contiguous tensors (checked by the Python wrapper).
// Returns the first CUDA error, or 0.
extern "C" int slstm_scan_launch(const void* gx, const void* rh, void* hbuf,
                                 void* c, void* hs, void* bar, int bar_len,
                                 int B, int T, int d, int gx_bf16,
                                 int rh_bf16, int carry_gx, int route,
                                 void* stream) {
  if (B < 0 || T < 0 || d < 1 || d > MAX_D || bar_len < BAR_INTS ||
      carry_gx < 0 || carry_gx > 1 || route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(hbuf);
  float* cc = static_cast<float*>(c);
  int* b = static_cast<int*>(bar);
  const bool gxc = carry_gx && gx_bf16;
  if (gx_bf16 && rh_bf16)
    return gxc ? run<bf16, bf16, true>(gx, rh, h, cc, hs, b, B, T, d, route,
                                       st)
               : run<bf16, bf16, false>(gx, rh, h, cc, hs, b, B, T, d,
                                        route, st);
  if (gx_bf16)
    return gxc ? run<bf16, float, true>(gx, rh, h, cc, hs, b, B, T, d,
                                        route, st)
               : run<bf16, float, false>(gx, rh, h, cc, hs, b, B, T, d,
                                         route, st);
  if (rh_bf16)
    return run<float, bf16, false>(gx, rh, h, cc, hs, b, B, T, d, route,
                                   st);
  return run<float, float, false>(gx, rh, h, cc, hs, b, B, T, d, route, st);
}
