// One-query decode attention over a dense int8 or bf16 KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kvq_attn/kernel.py
// (kvq_decode_attn / _kernel):
//
//   out[b, h] = softmax_s( q[b, h] . (k_q[b, h/G, s] * s_k[b, h/G, s])
//                          / sqrt(D), s < len[b] )
//               . (v_q[b, h/G, s] * s_v[b, h/G, s])
//
// q (B, H, D) bf16; k_q / v_q (B, Hkv, S, D) int8 or bf16; s_k / s_v
// (B, Hkv, S)
// f32 per-token scales; lengths (B) int32, clamped to [0, S]; out
// (B, H, D) bf16; G = H / Hkv.
//
// What bounds it on the H100: bytes at a long cache (2 * D int8 values
// and two f32 scales a resident token against 4 * D * G f32 flops),
// latency at serving sizes (a few slots of a few hundred tokens).
//
// Design: the split-KV kernel of kvq_paged_split.cuh at one query a slot
// (C = 1) in its dense mode (kDense): the cache is the pool of B blocks
// of S tokens with the table b -> b, so token p of slot b and KV head kh
// is row (b * Hkv + kh) * S + p and no table is read. One CTA per (slot,
// SPLIT-token split, KV head) serves the whole GQA group, the split's
// int8 rows staged by cp.async, scores and P.V a tile at a time, the
// splits merged in a fixed order by the last CTA of the slot (atomic
// tickets), all in one launch. Since every operation but the address is
// the paged kernel's, a slot's output is bitwise what
// kvq_paged_decode_attn returns for the same K/V scattered into a pool;
// it depends only on the slot's own length (batch-invariant), and an
// empty slot returns zeros.
//
// kv_bytes: 1 for int8 K/V, 2 for bf16 (a C16 cache, unit scales).
//
// ws / tickets: ws_len f32 of workspace and tk_len int32 counters, at
// least what kvq_paged_split_scratch(B, 1, H, Hkv, D, 1, S) returns (a
// launch with less returns cudaErrorInvalidValue); the tickets zero
// before the first launch and left zero by every launch. Requirements
// (checked by the Python wrapper): D of 16, 64, 128 or 256, G <= 10,
// S >= 1,
// every tensor contiguous.

#include "kvq_paged_split.cuh"

extern "C" int kvq_decode_attn_launch(const void* q, const void* k,
                                      const void* v, const void* sk,
                                      const void* sv, const void* lengths,
                                      void* out, void* ws, long long ws_len,
                                      void* tickets, long long tk_len, int B,
                                      int H, int Hkv, int S, int D,
                                      int kv_bytes, float scale,
                                      void* stream) {
  return kvq_split::launch<true>(q, k, v, sk, sv, nullptr, lengths, out, ws,
                                 ws_len, tickets, tk_len, B, 1, H, Hkv,
                                 B > 0 ? B : 1, S, 1, D, kv_bytes, scale,
                                 stream);
}
