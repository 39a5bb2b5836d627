"""Plain PyTorch version of quantized-KV-cache decode attention.

One new query token per sequence attends over an integer-quantized cache.

Shapes:
    q:   (B, H, D)      bf16/fp32
    k_q: (B, Hkv, S, D) int8
    v_q: (B, Hkv, S, D) int8
    s_k, s_v: (B, Hkv, S) fp32 per-token cache scales
    lengths: (B,) int32 valid prefix of the cache
Returns (B, H, D) in q.dtype.
"""
from __future__ import annotations

import torch


def kvq_decode_attn_ref(q, k_q, v_q, s_k, s_v, lengths):
    B, H, D = q.shape
    Hkv, S = k_q.shape[1], k_q.shape[2]
    group = H // Hkv
    qf = q.float().reshape(B, Hkv, group, D)
    k = k_q.float() * s_k[..., None].float()
    v = v_q.float() * s_v[..., None].float()
    scores = torch.einsum("bngd,bnsd->bngs", qf, k) / torch.sqrt(
        torch.tensor(float(D), dtype=torch.float32))
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    p = p * mask
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-20)
    out = torch.einsum("bngs,bnsd->bngd", p, v)
    return out.reshape(B, H, D).to(q.dtype)


# --------------------------------------------------------------------------
# Paged (block-table) variants
#
# A pool leaf of the port carries one block more than the pool holds:
# (NB + 1, Hkv, bs[, D]) per layer, (rep, NB + 1, ...) layer-stacked. Row
# NB is a write sink. The reference scatters with ``mode="drop"``, which
# torch has no counterpart of; here a sentinel destination (a table entry
# or a padding pair at NB) is clamped to NB and lands in the sink, so no
# boolean mask (and no host sync through ``nonzero`` on CUDA) is needed.
# Reads clamp sentinels to NB - 1 as the reference does, so the sink is
# never read as data.
# --------------------------------------------------------------------------

def pool_blocks(pool: torch.Tensor, axis: int = 0) -> int:
    """Real blocks of a pool leaf (its sink block excluded)."""
    return pool.shape[axis] - 1


def gather_paged_kv(pool: torch.Tensor,
                    block_tbl: torch.Tensor) -> torch.Tensor:
    """Slot-contiguous view gathered out of a block pool.

    pool (NB + 1, Hkv, bs, ...) K/V values (trailing D) or scales (no D);
    block_tbl (B, T) int32, entries >= NB are sentinels, clamped to NB - 1
    and masked by ``lengths`` downstream (entry i covers absolute token
    positions [i * bs, (i + 1) * bs)). Returns (B, Hkv, T * bs, ...).
    """
    nb = pool_blocks(pool)
    g = pool[torch.clamp(block_tbl.long(), 0, nb - 1)]  # (B,T,Hkv,bs,...)
    g = g.movedim(2, 1)                                 # (B,Hkv,T,bs,...)
    return g.reshape(g.shape[:2] + (g.shape[2] * g.shape[3],)
                     + g.shape[4:])


def kvq_paged_decode_attn_ref(q, k_pool, v_pool, s_k, s_v, block_tbl,
                              lengths):
    """Block-table decode attention: gather, then the dense plain version.

    q (B,H,D); k_pool/v_pool (NB+1,Hkv,bs,D) int8; s_k/s_v (NB+1,Hkv,bs)
    fp32; block_tbl (B,T) int32; lengths (B,) int32 tokens per slot.
    """
    return kvq_decode_attn_ref(
        q, gather_paged_kv(k_pool, block_tbl),
        gather_paged_kv(v_pool, block_tbl),
        gather_paged_kv(s_k, block_tbl),
        gather_paged_kv(s_v, block_tbl), lengths)


def gather_dequant_paged_kv_ref(pool, s_pool, block_tbl) -> torch.Tensor:
    """Dequantized history gather: (n, Hkv, T * bs, D) f32, one f32
    multiply per element."""
    return (gather_paged_kv(pool, block_tbl).float()
            * gather_paged_kv(s_pool, block_tbl)[..., None].float())


def copy_pool_blocks_ref(pool: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor) -> torch.Tensor:
    """Copy-on-write block clone, in place: ``pool[:, dst[i]] =
    pool[:, src[i]]`` on a layer-stacked leaf (rep, NB + 1, ...).

    ``dst`` entries >= NB are padding: they land in the sink block. ``src``
    is clamped to NB - 1 so a padding pair's gather stays in range.
    Returns ``pool``.
    """
    nb = pool_blocks(pool, axis=1)
    vals = pool[:, torch.clamp(src.long(), 0, nb - 1)]
    pool[:, torch.clamp(dst.long(), 0, nb)] = vals
    return pool


def copy_pool_blocks_multi_ref(leaves, pairs: torch.Tensor) -> list:
    """:func:`copy_pool_blocks_ref` on each leaf of ``leaves`` (the COW of
    every pool leaf at once), in place. pairs (2, n) int32: the src ids,
    then the dst ids. Returns ``leaves`` as a list."""
    for leaf in leaves:
        copy_pool_blocks_ref(leaf, pairs[0], pairs[1])
    return list(leaves)


def chunk_commit_ids(block_tbl: torch.Tensor, offset: torch.Tensor,
                     chunk_len: torch.Tensor, window: int, page_size: int,
                     num_blocks: int):
    """Per-row (pool block, in-block offset) destinations for a batched
    tail-prefill commit with per-row write offsets.

    block_tbl (n, T) int32 (truncated to the walked prefix); offset (n,)
    absolute position of each row's first window token; chunk_len (n,)
    real tokens of the ``window``-wide window. Returns (blk, off), both
    (n, window): position j of row i lands at ``pool[blk[i, j], :,
    off[i, j]]``; positions at or beyond ``chunk_len`` (and padding rows,
    whose ``chunk_len`` is 0) point at the ``num_blocks`` sink.
    """
    T = block_tbl.shape[1]
    j = torch.arange(window, device=block_tbl.device)[None]
    abs_pos = offset.long()[:, None] + j                        # (n, C)
    blk = torch.gather(block_tbl.long(), 1,
                       torch.clamp_max(abs_pos // page_size, T - 1))
    blk = torch.where(j < chunk_len.long()[:, None],
                      torch.clamp(blk, 0, num_blocks),
                      torch.full_like(blk, num_blocks))
    return blk, abs_pos % page_size


def scatter_chunk_kv(pool: torch.Tensor, vals: torch.Tensor,
                     blk: torch.Tensor, off: torch.Tensor) -> None:
    """Batched scatter commit of prefill windows into one layer's pool,
    in place. pool (NB + 1, Hkv, bs, ...); vals (n, C, Hkv, ...) sequence
    major; blk/off (n, C) from :func:`chunk_commit_ids` (sentinels point
    at the sink). The two index tensors bracket the head slice, so the
    indexed shape is (n, C, Hkv, ...) and ``vals`` lines up as is."""
    pool[blk, :, off] = vals.to(pool.dtype)


def kvq_spec_verify_attn_ref(q, k_pool, v_pool, s_k, s_v, block_tbl,
                             lengths):
    """Multi-query block-table attention for the speculative verify-wave.

    q (B, C, H, D): C window queries per slot, whose K/V are already
    committed to the pool; k_pool/v_pool (NB+1,Hkv,bs,D) int8; s_k/s_v
    (NB+1,Hkv,bs) fp32; block_tbl (B,T) int32; lengths (B, C): query c of
    slot b reads positions ``< lengths[b, c]``. A loop over c of
    :func:`kvq_paged_decode_attn_ref` at ``lengths[:, c]``, so each query
    equals the plain paged decode of that query by construction (a
    batched einsum over C could change torch's GEMM blocking and with it
    the last bits). Returns (B, C, H, D) in q.dtype.
    """
    return torch.stack(
        [kvq_paged_decode_attn_ref(q[:, c], k_pool, v_pool, s_k, s_v,
                                   block_tbl, lengths[:, c])
         for c in range(q.shape[1])], dim=1)
