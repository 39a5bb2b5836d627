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
// Two routes, picked by M in the launcher. The integer sums are exact in
// any order, so every route, split of K and tile shape gives the same
// int32 accumulator, and the epilogue applies the scales in the
// reference's order with __fmul_rn / __fadd_rn (never contracted into an
// FMA): both routes are bitwise equal to each other and to the plain
// PyTorch version, and a row's output does not depend on the rows beside
// it.
//
// Decode route (M < PREFILL_MIN_M: the decode slots, the draft, the spec
// verify wave). What bounds it on the H100 is HBM: each packed weight
// byte serves M rows only, so the weights are streamed. A CTA (8 warps)
// owns 32 output columns and x rows in tiles of 4, and streams its slice
// of K through shared memory by cp.async in rounds of 32 chunks of 32 k,
// two rounds in flight (the next lands while this one is summed): the
// loads in flight hold no registers, so three CTAs fit an SM. x goes
// through L1 (cp.async.ca): every CTA reads the same few KB of x, and
// through L2 alone (.cg) those lines were a hot spot all SMs queued on
// (tools/w4a8_ablate.py: gate 12.7 -> 8.3 us, the head 119 -> 62 us at
// M 4). A warp owns 4 columns; its lanes take a 32-k chunk (16 bytes of
// a weight row) each, keep the chunk's x words in registers and reuse
// them for the 4 columns; the warp's 16 sums meet by a transpose-reduce
// across its lanes. A long K (down, K = 11008) is split across the CTAs
// of a thread-block cluster, the partials reduced through its distributed
// shared memory, each CTA finishing a share of the outputs. Splitting the
// short K of k and v over more SMs read slower on the card (a few us of
// latency whatever the split), so it is not done. No scratch, no
// atomics: the call is capturable in a CUDA graph. Nibbles are moved to
// the high half of a byte (16 times the weight: no sign extension to
// compute; the sums are shifted back by 4 at the end, exactly) and put in
// k order (__byte_perm); __dp4a multiplies four pairs into an int32 sum.
//
// Tensor-core route (M >= PREFILL_MIN_M: admission waves, long
// tail-waves). At M = 512 the work is 2 M N K int8 operations over
// ~M K + N K / 2 bytes, above the card's ~590 operations a byte, so the
// int8 tensor cores (mma.sync m16n8k32 s8.s8.s32) do it. A CTA computes a
// 128 x 128 tile of y over its k-steps of 64; 8 warps of 64 x 32. x and
// the packed w tiles arrive by cp.async in a ring of MM_STAGES. Each warp
// reads its B fragments straight from the packed tile and unpacks them in
// registers: the k order inside a 64-k step is permuted, identically for
// A and B, so that a thread's two fragments of B come from one 8-byte
// load of packed nibbles and its A fragments from one 16-byte load per
// row (both bank-conflict-free without padding); integer sums do not
// care which k meets which slot as long as A and B agree. Rows past M
// and columns past N are neither loaded nor stored (mma rows and columns
// do not mix); the K tail of a 32-multiple is zero-filled. Where the
// tiles are too few for the card (q, k, v, o and down at M = 512) the
// k-steps are split across a cluster as in the decode route, the sums
// meeting in the CTAs' rings. The MMAs and the fragment loads and
// unpacking that feed them, not the bytes, hold the route: taking them out
// halves gate's time at M = 512 (tools/w4a8_ablate.py; PERF.md), and
// the route reaches a fraction of what mma.sync alone sustains on the
// card (tools/mma_rate.py); wgmma with a warp-specialised pipeline is the
// next step.
//
// Accumulator-out mode (the row-parallel linear of tensor-parallel
// serving): both routes can write the exact int32 sums acc (M, N) with no
// epilogue (w4a8_accumulate_launch). The ranks add their partial sums of
// a K slice (an exact integer all-reduce), and w4a8_epilogue_launch
// applies the scales to the total in the order above, once: so the
// result is bitwise the whole-K product's. The kernels are the same code
// with the store templated on the output type.
//
// Requirements (checked by the Python wrapper): K % 32 == 0, K <= MAX_K,
// x and w 16-byte aligned, every tensor contiguous.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// The route threshold: M below it streams weights, M at or above it runs
// the tensor cores. On an H100 80GB HBM3 at 700 W (tools/quant_times.py
// --routes; PERF.md) a layer's seven linears took 103.4 us by the decode
// route at M = 20 against 105.6 by the tensor cores, and 117.3 against
// 105.6 at M = 24: the spec verify wave (M = 20) streams.
constexpr int PREFILL_MIN_M = 24;

constexpr int UNPACK_SHIFT = 4;          // weights are unpacked 16x
constexpr int MAX_K = 1 << 16;           // 16 |acc| <= 16 K 128 8 <= 2^30

// ---------------------------------------------------------- decode route

constexpr int GV_WARPS = 8;              // warps per CTA
constexpr int GV_NC = 4;                 // output columns per warp
constexpr int GV_MT = 4;                 // x rows per CTA (grid.y tiles M)
constexpr int GV_COLS = GV_WARPS * GV_NC;
constexpr int GV_ROUND = 32;             // 32-k chunks a staging round (a
//                                          lane each), two rounds in flight
constexpr int GV_SPLIT_CHUNKS = 128;     // split K past this many chunks
constexpr int GV_MAX_SPLIT = 8;          // portable cluster size
static_assert(GV_MT * GV_NC == 16, "the transpose-reduce takes 16 sums");

// -------------------------------------------------------- tensor-core route

constexpr int MM_BM = 128, MM_BN = 128, MM_BK = 64;
constexpr int MM_STAGES = 4;
constexpr int MM_THREADS = 256;          // 8 warps: 2 along M x 4 along N
constexpr int MM_WM = 64, MM_WN = 32;    // a warp's tile
constexpr int MM_MI = MM_WM / 16, MM_NI = MM_WN / 8;
constexpr int MM_X_STAGE = MM_BM * MM_BK;          // bytes of x a stage
constexpr int MM_W_STAGE = MM_BN * MM_BK / 2;      // bytes of packed w
constexpr int MM_ACC = MM_MI * MM_NI * 4;          // int32 sums a thread
constexpr int MM_RING = MM_STAGES * (MM_X_STAGE + MM_W_STAGE);
constexpr int MM_RED = MM_ACC * MM_THREADS * 4;    // a tile's sums, bytes
// the ring, reused after the last k-step for the split-K merge
constexpr int MM_SMEM = MM_RING > MM_RED ? MM_RING : MM_RED;
constexpr int MM_MIN_KSTEPS = 4;         // least k-steps a split is worth
constexpr int MM_SPLIT_SLOTS = 132;      // split tiles up to one CTA an SM

// 8 packed int4 (one 32-bit word, k0..k7) -> two words of 4 int8 in k
// order, each byte 16 times its weight: the nibble moved to the byte's high
// half is its two's-complement value times 16, with no sign extension to
// compute. Sums over these come out exactly 16 times the true ones
// (|16 acc| < 2^31 for K <= MAX_K) and are shifted back by UNPACK_SHIFT.
__device__ __forceinline__ void unpack8(uint32_t w, int& a, int& b) {
  const uint32_t lo = (w << 4) & 0xF0F0F0F0u;   // k0, k2, k4, k6
  const uint32_t hi = w & 0xF0F0F0F0u;          // k1, k3, k5, k7
  a = (int)__byte_perm(lo, hi, 0x5140);         // k0, k1, k2, k3
  b = (int)__byte_perm(lo, hi, 0x7362);         // k4, k5, k6, k7
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// the same through L1: x, which every CTA of an SM reads (a line fetched
// once from L2 serves them all; through L2 alone the few lines of x are a
// hot spot that all 132 SMs queue on)
__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem,
                                              int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// y = bf16(((f32)acc * s_x[m]) * s_w[n] (+ b[n])), each step rounded
// alone; acc16 is 16 acc (see unpack8)
__device__ __forceinline__ __nv_bfloat16 scale_out(int acc16, float sx,
                                                   float sw, bool has_bias,
                                                   float b) {
  const int acc = acc16 >> UNPACK_SHIFT;
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if (has_bias) y = __fadd_rn(y, b);
  return __float2bfloat16_rn(y);
}

// the scales (and bias) of output (m, n), read before the main loop so that
// the epilogue waits on no load; zero past M or N
struct Scales {
  float sx, sw, b;
};

__device__ __forceinline__ Scales load_scales(const float* __restrict__ sx,
                                              const float* __restrict__ sw,
                                              const float* bias, int m, int n,
                                              int M, int N) {
  Scales r = {0.0f, 0.0f, 0.0f};
  if (sx != nullptr && m < M && n < N) {
    r.sx = sx[m];
    r.sw = sw[n];
    if (bias != nullptr) r.b = bias[n];
  }
  return r;
}

// one output: bf16 through the epilogue, or the int32 sum itself
__device__ __forceinline__ void put(__nv_bfloat16* o, int acc16,
                                    const Scales& sc, bool has_bias) {
  *o = scale_out(acc16, sc.sx, sc.sw, has_bias, sc.b);
}

__device__ __forceinline__ void put(int32_t* o, int acc16, const Scales&,
                                    bool) {
  *o = acc16 >> UNPACK_SHIFT;
}

// ------------------------------------------------------------ decode route

// One level of the transpose-reduce: lanes with bit `off` set keep the
// upper half of v, the others the lower half, each adding its partner's.
template <int HALF>
__device__ __forceinline__ void tr_level(int* v, int lane, int off) {
  const bool upper = (lane & off) != 0;
#pragma unroll
  for (int t = 0; t < HALF; ++t) {
    const int keep = upper ? v[HALF + t] : v[t];
    const int send = upper ? v[t] : v[HALF + t];
    v[t] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, off);
  }
}

// Sums v[0..15] of the 32 lanes by a transpose-reduce (16 shuffles, not
// 16 x 5): after it lanes 2i and 2i + 1 hold the total of v[i].
__device__ __forceinline__ int transpose_reduce16(int (&v)[16], int lane) {
  tr_level<8>(v, lane, 16);
  tr_level<4>(v, lane, 8);
  tr_level<2>(v, lane, 4);
  tr_level<1>(v, lane, 2);
  return v[0] + __shfl_xor_sync(0xFFFFFFFFu, v[0], 1);
}

// Stage round [r0, r0 + rc) of the slice into buffer `buf`: the packed
// weights of the tile's `cols` columns (one 16-byte chunk of a weight row
// per cp.async, streamed past L1) and the x rows (through L1).
__device__ __forceinline__ void gv_stage(uint4 (*xs)[GV_MT][GV_ROUND],
                                         uint4 (*ws)[GV_ROUND],
                                         const int8_t* __restrict__ x,
                                         const uint8_t* __restrict__ w,
                                         int K, size_t wrow, int m0, int rows,
                                         int nt0, int cols, int r0, int rc) {
  for (int e = threadIdx.x; e < cols * GV_ROUND; e += GV_WARPS * 32) {
    const int n = e / GV_ROUND, c = e % GV_ROUND;
    if (c < rc)
      cp_async16(&ws[n][c],
                 w + (size_t)(nt0 + n) * wrow + (size_t)(r0 + c) * 16, 16);
  }
  for (int e = threadIdx.x; e < rows * GV_ROUND * 2; e += GV_WARPS * 32) {
    const int h = e & 1, i = e / (2 * GV_ROUND), c = (e >> 1) % GV_ROUND;
    if (c < rc)
      cp_async16_ca(&xs[h][i][c],
                    x + (size_t)(m0 + i) * K + (size_t)(r0 + c) * 32 + h * 16,
                    16);
  }
}

// grid (tiles * splits, ceil(M / GV_MT)), clusters of (splits, 1, 1): the
// CTAs of a cluster own one tile of GV_COLS columns and split its K in
// ch-chunk slices. A slice streams through two buffers GV_ROUND chunks at
// a time, the next round landing while this one is summed: x rows as
// xs[h][i][c] (half h of chunk c of row i), the packed weights of the
// tile's columns as ws[col][c].
// OutT: __nv_bfloat16 (y) or int32_t (acc, sx and sw null).
template <typename OutT>
__global__ void __launch_bounds__(GV_WARPS * 32, 3)
w4a8_gemv_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, OutT* __restrict__ out,
                 int M, int N, int K, int splits, int ch) {
  __shared__ uint4 xs[2][2][GV_MT][GV_ROUND];
  __shared__ uint4 ws[2][GV_COLS][GV_ROUND];
  __shared__ int part[GV_WARPS * 16];     // this CTA's sums, for the merge
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x / splits;
  const int rank = blockIdx.x % splits;   // the CTA's rank in its cluster
  const int nt0 = tile * GV_COLS;
  const int m0 = blockIdx.y * GV_MT;
  const int rows = min(GV_MT, M - m0);
  const int cols = min(GV_COLS, N - nt0);
  const int nchunks = K >> 5;
  const int c0 = min(rank * ch, nchunks);
  const int c1 = min(c0 + ch, nchunks);
  const int rounds = (c1 - c0 + GV_ROUND - 1) / GV_ROUND;
  const size_t wrow = (size_t)(K >> 1);
  // the output this thread finishes: without a split, even lane 2i of a
  // warp finishes its sum i; with one, thread o < 128 with o % splits ==
  // rank finishes output o of the CTA (sum o % 16 of warp o / 16)
  int om = M, on = N;
  const bool finishes =
      splits == 1
          ? (lane & 1) == 0
          : threadIdx.x < GV_WARPS * 16 && threadIdx.x % splits == rank;
  if (finishes) {
    const int o = splits == 1 ? warp * 16 + (lane >> 1) : threadIdx.x;
    om = m0 + (o & 15) / GV_NC;
    on = nt0 + (o >> 4) * GV_NC + (o & 15) % GV_NC;
  }

  for (int r = 0; r < 2 && r < rounds; ++r) {
    const int r0 = c0 + r * GV_ROUND;
    gv_stage(xs[r], ws[r], x, w, K, wrow, m0, rows, nt0, cols, r0,
             min(GV_ROUND, c1 - r0));
    cp_async_commit();
  }
  const Scales sc = load_scales(sx, sw, bias, om, on, M, N);

  int acc[GV_MT][GV_NC];
#pragma unroll
  for (int i = 0; i < GV_MT; ++i)
#pragma unroll
    for (int j = 0; j < GV_NC; ++j) acc[i][j] = 0;

  for (int r = 0; r < rounds; ++r) {
    const int b = r & 1, r0 = c0 + r * GV_ROUND;
    if (r + 1 < rounds)
      cp_async_wait<1>();                 // round r landed, r + 1 may not
    else
      cp_async_wait<0>();
    __syncthreads();
    const int c = lane;                   // one chunk a lane a round
    if (c < min(GV_ROUND, c1 - r0)) {
      int xw[GV_MT][8];
#pragma unroll
      for (int i = 0; i < GV_MT; ++i)
        if (i < rows) {
          const uint4 xa = xs[b][0][i][c], xb = xs[b][1][i][c];
          xw[i][0] = (int)xa.x; xw[i][1] = (int)xa.y;
          xw[i][2] = (int)xa.z; xw[i][3] = (int)xa.w;
          xw[i][4] = (int)xb.x; xw[i][5] = (int)xb.y;
          xw[i][6] = (int)xb.z; xw[i][7] = (int)xb.w;
        }
#pragma unroll
      for (int j = 0; j < GV_NC; ++j) {
        // columns past N hold stale bytes: their sums are never stored
        const uint4 p = ws[b][warp * GV_NC + j][c];
        int wk[8];                        // wk[t]: k = 4t .. 4t+3
        unpack8(p.x, wk[0], wk[1]);
        unpack8(p.y, wk[2], wk[3]);
        unpack8(p.z, wk[4], wk[5]);
        unpack8(p.w, wk[6], wk[7]);
#pragma unroll
        for (int i = 0; i < GV_MT; ++i)
          if (i < rows)
#pragma unroll
            for (int t = 0; t < 8; ++t)
              acc[i][j] = __dp4a(wk[t], xw[i][t], acc[i][j]);
      }
    }
    if (r + 2 < rounds) {
      __syncthreads();                    // buffer b is read
      const int n0 = c0 + (r + 2) * GV_ROUND;
      gv_stage(xs[b], ws[b], x, w, K, wrow, m0, rows, nt0, cols, n0,
               min(GV_ROUND, c1 - n0));
      cp_async_commit();
    }
  }

  // sum v = (row i, column j) at index 4i + j over the warp's lanes
  int v[16];
#pragma unroll
  for (int i = 0; i < GV_MT; ++i)
#pragma unroll
    for (int j = 0; j < GV_NC; ++j) v[i * GV_NC + j] = acc[i][j];
  const int mine = transpose_reduce16(v, lane);
  if (splits == 1) {
    if (om < M && on < N)
      put(out + (size_t)om * N + on, mine, sc, bias != nullptr);
    return;
  }
  // the cluster's merge: CTA r finishes the outputs o with o % splits == r,
  // summing every CTA's partial (exact integers, any order)
  if ((lane & 1) == 0) part[warp * 16 + (lane >> 1)] = mine;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (om < M && on < N) {
    int s = 0;
    for (int r = 0; r < splits; ++r)
      s += cluster.map_shared_rank(part, r)[threadIdx.x];
    put(out + (size_t)om * N + on, s, sc, bias != nullptr);
  }
  cluster.sync();                         // no CTA leaves while read
}

// ------------------------------------------------------- tensor-core route

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, int b0,
                                       int b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// one k-step's tiles into ring slot `slot`: x rows [m0, m0 + 128) x 64 k
// (512 16-byte chunks), packed w rows [n0, n0 + 128) x 32 bytes (256)
__device__ __forceinline__ void mm_load(uint8_t* xs, uint8_t* ws, int slot,
                                        int kt, const int8_t* __restrict__ x,
                                        const uint8_t* __restrict__ w, int M,
                                        int N, int K, int m0, int n0) {
  uint8_t* xd = xs + slot * MM_X_STAGE;
  uint8_t* wd = ws + slot * MM_W_STAGE;
  const int kb = kt * MM_BK;
#pragma unroll
  for (int e = threadIdx.x; e < MM_BM * 4; e += MM_THREADS) {
    const int r = e >> 2, q = e & 3;
    if (m0 + r < M) {
      const bool in = kb + q * 16 < K;
      cp_async16_ca(xd + r * MM_BK + q * 16,
                    in ? (const void*)(x + (size_t)(m0 + r) * K + kb + q * 16)
                       : (const void*)x,
                    in ? 16 : 0);
    }
  }
  {
    const int r = threadIdx.x >> 1, q = threadIdx.x & 1;
    if (n0 + r < N) {
      const bool in = kb + q * 32 < K;
      cp_async16(wd + r * (MM_BK / 2) + q * 16,
                 in ? (const void*)(w + (size_t)(n0 + r) * (K >> 1) +
                                    kb / 2 + q * 16)
                    : (const void*)w,
                 in ? 16 : 0);
    }
  }
}

// One 64-k step of a warp's 64 x 32 tile from ring slot (xt, wt), for
// its first MT m16 tiles. A: rows g and g + 8 of each m16 tile, bytes 16t
// .. 16t + 15 of the step (words 0, 1 feed the first k32 MMA, words 2, 3
// the second); B: column g of each n8 tile, packed bytes 8t .. 8t + 7 =
// k 16t .. 16t + 15, the same k as the A words (b[j][0..1] feed the first
// MMA, b[j][2..3] the second). All accumulators' first MMAs go before
// their second, so no MMA waits on the one before it.
template <int MT>
__device__ __forceinline__ void mm_step(int (&acc)[MM_MI][MM_NI][4],
                                        const uint8_t* xt, const uint8_t* wt,
                                        int mrow, int wn, int g, int t) {
  uint4 alo[MT], ahi[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    alo[i] = *reinterpret_cast<const uint4*>(
        xt + (mrow + i * 16 + g) * MM_BK + t * 16);
    ahi[i] = *reinterpret_cast<const uint4*>(
        xt + (mrow + i * 16 + g + 8) * MM_BK + t * 16);
  }
  int b[MM_NI][4];
#pragma unroll
  for (int j = 0; j < MM_NI; ++j) {
    const uint2 p = *reinterpret_cast<const uint2*>(
        wt + (wn * MM_WN + j * 8 + g) * (MM_BK / 2) + t * 8);
    unpack8(p.x, b[j][0], b[j][1]);
    unpack8(p.y, b[j][2], b[j][3]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MM_NI; ++j)
      mma_s8(acc[i][j], alo[i].x, ahi[i].x, alo[i].y, ahi[i].y, b[j][0],
             b[j][1]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MM_NI; ++j)
      mma_s8(acc[i][j], alo[i].z, ahi[i].z, alo[i].w, ahi[i].w, b[j][2],
             b[j][3]);
}

// the same for a warp with 1 .. MM_MI - 1 m16 tiles below M (the last
// rows of a ragged M)
__device__ __forceinline__ void mm_step_partial(
    int (&acc)[MM_MI][MM_NI][4], const uint8_t* xt, const uint8_t* wt,
    int mrow, int wn, int g, int t, int mtiles) {
  if (mtiles == 1)
    mm_step<1>(acc, xt, wt, mrow, wn, g, t);
  else if (mtiles == 2)
    mm_step<2>(acc, xt, wt, mrow, wn, g, t);
  else
    mm_step<3>(acc, xt, wt, mrow, wn, g, t);
}

// y[m, n .. n + 1] from the sums of two neighbouring columns (the C
// fragment's pairs); the sums themselves in accumulator-out mode
__device__ __forceinline__ void mm_store(int a0, int a1, int m, int n,
                                         const float* __restrict__ sx,
                                         const float* __restrict__ sw,
                                         const float* bias,
                                         int32_t* __restrict__ out, int M,
                                         int N) {
  if (m >= M || n >= N) return;
  int32_t* o = out + (size_t)m * N + n;
  const int v0 = a0 >> UNPACK_SHIFT, v1 = a1 >> UNPACK_SHIFT;
  if (n + 1 >= N) {
    o[0] = v0;
  } else if ((N & 1) == 0) {
    *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
  } else {
    o[0] = v0;
    o[1] = v1;
  }
}

__device__ __forceinline__ void mm_store(int a0, int a1, int m, int n,
                                         const float* __restrict__ sx,
                                         const float* __restrict__ sw,
                                         const float* bias,
                                         __nv_bfloat16* __restrict__ out,
                                         int M, int N) {
  if (m >= M || n >= N) return;
  const bool hb = bias != nullptr;
  const __nv_bfloat16 y0 =
      scale_out(a0, sx[m], sw[n], hb, hb ? bias[n] : 0.0f);
  __nv_bfloat16* o = out + (size_t)m * N + n;
  if (n + 1 >= N) {
    o[0] = y0;
    return;
  }
  const __nv_bfloat16 y1 =
      scale_out(a1, sx[m], sw[n + 1], hb, hb ? bias[n + 1] : 0.0f);
  if ((N & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(y0, y1);
  } else {
    o[0] = y0;
    o[1] = y1;
  }
}

// grid (ceil(N / 128) * splits, ceil(M / 128)), clusters of (splits, 1, 1):
// the CTAs of a cluster own one 128 x 128 tile and split its k-steps,
// kch each; their int32 sums meet through distributed shared memory
template <typename OutT>
__global__ void __launch_bounds__(MM_THREADS, 2)
w4a8_mma_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ sx, const float* __restrict__ sw,
                const float* __restrict__ bias, OutT* __restrict__ out,
                int M, int N, int K, int splits, int kch) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xs = smem;                               // [stage][128][64]
  uint8_t* ws = smem + MM_STAGES * MM_X_STAGE;      // [stage][128][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % splits;   // the CTA's rank in its cluster
  const int m0 = blockIdx.y * MM_BM, n0 = (blockIdx.x / splits) * MM_BN;
  const int KT = (K + MM_BK - 1) / MM_BK;
  const int k0 = min(rank * kch, KT);
  const int nk = min(k0 + kch, KT) - k0;            // this CTA's k-steps
  const int mrow = wm * MM_WM;                      // the warp's first row
  // m16 tiles of this warp that hold a row below M (warp-uniform)
  const int mtiles = max(0, min(MM_MI, (M - m0 - mrow + 15) / 16));

#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < nk) mm_load(xs, ws, s, k0 + s, x, w, M, N, K, m0, n0);
    cp_async_commit();
  }

  int acc[MM_MI][MM_NI][4];
#pragma unroll
  for (int i = 0; i < MM_MI; ++i)
#pragma unroll
    for (int j = 0; j < MM_NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();                  // slot kt landed; slot kt - 1 free
    {
      const int kn = kt + MM_STAGES - 1;
      if (kn < nk)
        mm_load(xs, ws, kn % MM_STAGES, k0 + kn, x, w, M, N, K, m0, n0);
      cp_async_commit();
    }
    const uint8_t* xt = xs + (kt % MM_STAGES) * MM_X_STAGE;
    const uint8_t* wt = ws + (kt % MM_STAGES) * MM_W_STAGE;
    // one branch for the whole step: a warp whose 64 rows all lie below M
    // (every warp of a full M tile) runs the MMAs without a test each
    if (mtiles == MM_MI)
      mm_step<MM_MI>(acc, xt, wt, mrow, wn, g, t);
    else if (mtiles > 0)
      mm_step_partial(acc, xt, wt, mrow, wn, g, t, mtiles);
  }
  cp_async_wait<0>();

  // C fragment: e 0, 1 at row g, columns 2t, 2t + 1; e 2, 3 at row g + 8
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < MM_MI; ++i) {
      if (i >= mtiles) break;
#pragma unroll
      for (int j = 0; j < MM_NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mm_store(acc[i][j][2 * h], acc[i][j][2 * h + 1],
                   m0 + mrow + i * 16 + g + 8 * h,
                   n0 + wn * MM_WN + j * 8 + 2 * t, sx, sw, bias, out, M, N);
    }
    return;
  }
  // the cluster's merge: every CTA parks its sums in its ring as
  // red[e][thread]; CTA r finishes the pairs e / 2 with e / 2 % splits ==
  // r of every thread position, summing all CTAs' (exact integers)
  int* red = reinterpret_cast<int*>(smem);
  __syncthreads();                        // the ring's last reads are done
#pragma unroll
  for (int i = 0; i < MM_MI; ++i)
#pragma unroll
    for (int j = 0; j < MM_NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((i * MM_NI + j) * 4 + e) * MM_THREADS + threadIdx.x] =
            acc[i][j][e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int pr = rank; pr < MM_ACC / 2; pr += splits) {
    const int i = pr / (2 * MM_NI), j = (pr / 2) % MM_NI, h = pr % 2;
    int a0 = 0, a1 = 0;
    for (int r = 0; r < splits; ++r) {
      const int* rr = cluster.map_shared_rank(red, r);
      a0 += rr[(2 * pr) * MM_THREADS + threadIdx.x];
      a1 += rr[(2 * pr + 1) * MM_THREADS + threadIdx.x];
    }
    if (i < mtiles)
      mm_store(a0, a1, m0 + mrow + i * 16 + g + 8 * h,
               n0 + wn * MM_WN + j * 8 + 2 * t, sx, sw, bias, out, M, N);
  }
  cluster.sync();                         // no CTA leaves while read
}

// ---------------------------------------------------------------- launch

// The tensor-core route's split of K: one CTA an SM where the tiles are
// fewer (q, k, v, o and down at M = 512 take 2 to 8), at most a cluster
// of GV_MAX_SPLIT, no share under MM_MIN_KSTEPS k-steps. Splitting
// further, or to two CTAs an SM, read slower on the card (the merge of a
// 64 KB tile a CTA).
int mm_splits(int tiles, int KT) {
  int s = MM_SPLIT_SLOTS / tiles;
  s = min(s, GV_MAX_SPLIT);
  s = min(s, KT / MM_MIN_KSTEPS);
  return max(s, 1);
}

template <typename OutT>
cudaError_t launch_gemv(const int8_t* x, const uint8_t* w, const float* sx,
                        const float* sw, const float* bias, OutT* out, int M,
                        int N, int K, cudaStream_t st) {
  const int nchunks = K >> 5;
  const int tiles = (N + GV_COLS - 1) / GV_COLS;
  // split only a long K (down); k and v read no faster over more SMs (a
  // few us of latency whatever the split), q and o slower
  const int splits =
      min(GV_MAX_SPLIT, (nchunks + GV_SPLIT_CHUNKS - 1) / GV_SPLIT_CHUNKS);
  const int ch = (nchunks + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * splits),
                     (unsigned)((M + GV_MT - 1) / GV_MT), 1);
  cfg.blockDim = dim3(GV_WARPS * 32, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, w4a8_gemv_kernel<OutT>, x, w, sx, sw, bias,
                            out, M, N, K, splits, ch);
}

template <typename OutT>
cudaError_t launch_mma(const int8_t* x, const uint8_t* w, const float* sx,
                       const float* sw, const float* bias, OutT* out, int M,
                       int N, int K, cudaStream_t st) {
  static bool smem_set = false;         // one flag per OutT
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        w4a8_mma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MM_SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int KT = (K + MM_BK - 1) / MM_BK;
  const int tiles = ((N + MM_BN - 1) / MM_BN) * ((M + MM_BM - 1) / MM_BM);
  const int splits = mm_splits(tiles, KT);
  const int kch = (KT + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((N + MM_BN - 1) / MM_BN) * splits),
                     (unsigned)((M + MM_BM - 1) / MM_BM), 1);
  cfg.blockDim = dim3(MM_THREADS, 1, 1);
  cfg.dynamicSmemBytes = MM_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, w4a8_mma_kernel<OutT>, x, w, sx, sw, bias,
                            out, M, N, K, splits, kch);
}

// ------------------------------------------------------- epilogue kernel

constexpr int EP_THREADS = 256;
constexpr int EP_MAX_BLOCKS = 132 * 8;

// y = bf16(((f32)acc * s_x[m]) * s_w[n] (+ b[n])) over (M, N), each step
// rounded alone: the fused routes' epilogue on an all-reduced acc
__global__ void __launch_bounds__(EP_THREADS)
w4a8_epilogue_kernel(const int32_t* __restrict__ acc,
                     const float* __restrict__ sx,
                     const float* __restrict__ sw,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int M, int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * EP_THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * EP_THREADS) {
    const int m = (int)(i / N), n = (int)(i % N);
    float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), sx[m]), sw[n]);
    if (bias != nullptr) y = __fadd_rn(y, bias[n]);
    out[i] = __float2bfloat16_rn(y);
  }
}

template <typename OutT>
int launch_route(const void* x, const void* w, const void* sx,
                 const void* sw, const void* bias, OutT* out, int M, int N,
                 int K, int route, void* stream) {
  if (K <= 0 || K % 32 || K > MAX_K || route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const bool mma = route == 2 || (route == 0 && M >= PREFILL_MIN_M);
  const auto launch = mma ? launch_mma<OutT> : launch_gemv<OutT>;
  return static_cast<int>(launch(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), out, M, N, K,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// The least M that takes the tensor-core route (below it: the decode
// route).
extern "C" int w4a8_matmul_prefill_min_m() { return PREFILL_MIN_M; }

// route: 0 picks by M (the serving path), 1 forces the decode route, 2 the
// tensor-core route (checks and timing of both at any M). Returns the CUDA
// error of the launch; cudaErrorInvalidValue for K % 32 != 0, K > MAX_K
// (65536) or another route.
extern "C" int w4a8_matmul_launch(const void* x, const void* w,
                                  const void* sx, const void* sw,
                                  const void* bias, void* out, int M, int N,
                                  int K, int route, void* stream) {
  return launch_route(x, w, sx, sw, bias, static_cast<__nv_bfloat16*>(out),
                      M, N, K, route, stream);
}

// Accumulator-out mode: acc (M, N) int32 = x_q (M, K) . w (N, K)^T, exact,
// by the route `route` picks as above; no scales.
extern "C" int w4a8_accumulate_launch(const void* x, const void* w,
                                      void* acc, int M, int N, int K,
                                      int route, void* stream) {
  return launch_route(x, w, nullptr, nullptr, nullptr,
                      static_cast<int32_t*>(acc), M, N, K, route, stream);
}

// The epilogue alone: y (M, N) bf16 from acc (M, N) int32, s_x (M), s_w
// (N) and bias (N) f32 or null.
extern "C" int w4a8_epilogue_launch(const void* acc, const void* sx,
                                    const void* sw, const void* bias,
                                    void* out, int M, int N, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const size_t total = (size_t)M * N;
  const size_t want = (total + EP_THREADS - 1) / EP_THREADS;
  const int blocks = (int)(want < (size_t)EP_MAX_BLOCKS ? want : EP_MAX_BLOCKS);
  w4a8_epilogue_kernel<<<blocks, EP_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}
