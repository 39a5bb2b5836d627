// Multi-query attention through a block table over a paged int8 or bf16 KV
// pool,
// for the speculative verify-wave, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kvq_attn/kernel.py
// (kvq_spec_verify_attn / _spec_verify_kernel):
//
//   blk(b, p) = tbl[b, p / bs] clamped to [0, NB - 1],  row(p) = p % bs
//   out[b, c, h] = softmax_p( q[b, c, h] . (k[blk, h/G, row] *
//                  s_k[blk, h/G, row]) / sqrt(D), p < len[b, c] )
//                  . (v[blk, h/G, row] * s_v[blk, h/G, row])
//
// q (B, C, H, D) bf16: the C = k + 1 window queries of each slot, whose
// K/V the verify-wave has already committed to the pool; k / v pools
// (NB + 1, Hkv, bs, D) int8 or bf16, the last block a write sink that is never
// read; s_k / s_v (NB + 1, Hkv, bs) f32 per-token scales; tbl (B, T) int32
// block ids, entries >= NB are unallocated sentinels; lengths (B, C) int32
// per-query extents (history + the window through the query itself);
// out (B, C, H, D) bf16; G = H / Hkv.
//
// What bounds it on the H100: as kvq_paged_decode_attn (bytes at a long
// cache, latency at serving sizes); the C queries share one read of the
// slot's tokens, so the flops grow with C and the bytes do not.
//
// Design: the split-KV kernel of kvq_paged_split.cuh, the one
// kvq_paged_decode_attn runs at C = 1. A CTA holds the C * G query rows
// of a slot and KV head (up to 40; more queries take more CTAs) and walks
// each split once for all of them, dequantizing each token once and
// masking each query by its own length, as the TPU kernel does.
//
// The property the engine's exact mode rests on: query c's output is
// bitwise equal to what kvq_paged_decode_attn returns for that query at
// lengths[:, c], so a verified stream equals plain decode. It holds
// because both run the same compiled kernel, and every number of a query
// row is computed by the same IEEE operations whatever the other rows of
// its CTA are (the header states why).
//
// kv_bytes: 1 for int8 K/V, 2 for bf16. ws / tickets as in
// kvq_paged_decode_attn.cu. Requirements (checked by the Python wrapper):
// D of 16, 64, 128 or 256, G <= 10, bs >= 1, every tensor contiguous.

#include "kvq_paged_split.cuh"

extern "C" int kvq_spec_verify_attn_launch(
    const void* q, const void* k, const void* v, const void* sk,
    const void* sv, const void* tbl, const void* lengths, void* out,
    void* ws, long long ws_len, void* tickets, long long tk_len, int B,
    int C, int H, int Hkv, int NB, int bs, int T, int D, int kv_bytes,
    float scale, void* stream) {
  return kvq_split::launch<false>(q, k, v, sk, sv, tbl, lengths, out, ws,
                                  ws_len, tickets, tk_len, B, C, H, Hkv, NB,
                                  bs, T, D, kv_bytes, scale, stream);
}
