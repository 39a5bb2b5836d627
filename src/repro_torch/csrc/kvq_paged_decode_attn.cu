// One-query decode attention through a block table over a paged int8 or
// bf16 KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kvq_attn/kernel.py
// (kvq_paged_decode_attn / _paged_kernel):
//
//   blk(b, p) = tbl[b, p / bs] clamped to [0, NB - 1],  row(p) = p % bs
//   out[b, h] = softmax_p( q[b, h] . (k[blk, h/G, row] * s_k[blk, h/G, row])
//                          / sqrt(D), p < len[b] )
//               . (v[blk, h/G, row] * s_v[blk, h/G, row])
//
// q (B, H, D) bf16; k / v pools (NB + 1, Hkv, bs, D) int8 or bf16, the
// last block a write sink that is never read; s_k / s_v (NB + 1, Hkv, bs) f32
// per-token scales; tbl (B, T) int32 block ids, entries >= NB are
// unallocated sentinels; lengths (B) int32 tokens resident per slot;
// out (B, H, D) bf16; G = H / Hkv.
//
// What bounds it on the H100: bytes at a long cache (264 bytes a resident
// token at D 128 against 4 * D * G f32 flops), latency at serving sizes.
//
// Design: the split-KV kernel of kvq_paged_split.cuh at one query a slot
// (C = 1): one CTA per (slot, SPLIT-token split, KV head) serving the
// whole GQA group, the split's int8 rows staged by cp.async, scores and
// P.V a tile at a time, the splits merged in a fixed order by the last
// CTA of the slot (atomic tickets), all in one launch. kvq_spec_verify_attn
// runs the same compiled kernel at C = k + 1, which is why each of its
// queries equals this kernel at that query's length, bit for bit (see the
// header). A row's result depends only on its own length: the split is a
// constant, so decode is batch-invariant.
//
// kv_bytes: 1 for int8 K/V, 2 for bf16 (a C16 cache, unit scales).
//
// ws / tickets: ws_len f32 of workspace and tk_len int32 counters, at
// least what kvq_paged_split_scratch returns for the shapes (a launch
// with less returns cudaErrorInvalidValue); the tickets zero before the
// first launch and left zero by every launch. Requirements (checked by
// the Python wrapper): D of 16, 64, 128 or 256, G <= 10, bs >= 1, every
// tensor contiguous.

#include "kvq_paged_split.cuh"

extern "C" int kvq_paged_decode_attn_launch(
    const void* q, const void* k, const void* v, const void* sk,
    const void* sv, const void* tbl, const void* lengths, void* out,
    void* ws, long long ws_len, void* tickets, long long tk_len, int B,
    int H, int Hkv, int NB, int bs, int T, int D, int kv_bytes, float scale,
    void* stream) {
  return kvq_split::launch<false>(q, k, v, sk, sv, tbl, lengths, out, ws,
                                  ws_len, tickets, tk_len, B, 1, H, Hkv, NB,
                                  bs, T, D, kv_bytes, scale, stream);
}
