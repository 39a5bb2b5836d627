"""Wrappers for the quantized-KV kernels of the dense and paged caches.

``kvq_decode_attn``, ``kvq_paged_decode_attn``, ``kvq_spec_verify_attn``,
``gather_dequant_paged_kv`` and ``copy_pool_blocks`` launch their CUDA
kernels (``csrc/<name>.cu``)
for CUDA tensors and run the plain versions (``ref.py``) for CPU tensors.
``gather_dequant_paged_kv_pair`` gathers a layer's K and V through one
table in one launch of the gather kernel (counted as its launch).
``copy_pool_blocks_multi`` clones COW pairs in up to ``MAX_COPY_LEAVES``
leaves in one launch of the copy source's second launcher (the engine's
COW: all four pool leaves at once), with its own count.
Each checks its inputs and counts its launches in ``.launches``.
``commit_chunk_kv`` is a plain scatter on every device, as in the
reference. Paged pool leaves carry a trailing sink block (see ``ref.py``).

The dense decode, paged decode and verify kernels share one split-KV
design (``csrc/kvq_paged_split.cuh``): a CTA per (slot, split of
``SPLIT`` token positions, KV head, chunk of query rows), the splits
merged inside the launch through an f32 workspace and atomic tickets.
The dense launcher runs it with the table taken away (the cache is the
pool of B blocks of S tokens, table b -> b), so dense decode is bitwise
paged decode of the same K/V. The source sizes that scratch
(``kvq_paged_split_scratch``) and its three launchers refuse a shorter
one. Workspace and tickets are kept per device and shared by the three
launchers (tickets zeroed once; every launch leaves them zero), so a
call allocates nothing beyond its output and can be captured in a CUDA
graph; launches of these three kernels on one device must therefore not
run concurrently on two streams.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.kvq_attn.ref import (chunk_commit_ids,
                                              copy_pool_blocks_multi_ref,
                                              copy_pool_blocks_ref,
                                              gather_dequant_paged_kv_ref,
                                              kvq_decode_attn_ref,
                                              kvq_paged_decode_attn_ref,
                                              kvq_spec_verify_attn_ref,
                                              pool_blocks, scatter_chunk_kv)
from repro_torch.kernels.checks import check_aligned, check_tensor

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the split-KV launchers' scratch: ws, ws_len, tickets, tk_len
_SCR = (_P, _L, _P, _L)
# the paged launchers' pointers and scratch: q .. out, then _SCR
_PAGED = (_P,) * 8 + _SCR
# C signatures of the launchers: pointers and the stream as c_void_p
_ARGTYPES = {
    "kvq_decode_attn": (_P,) * 7 + _SCR + (_I,) * 6 + (ctypes.c_float, _P),
    "kvq_paged_decode_attn": _PAGED + (_I,) * 8 + (ctypes.c_float, _P),
    "kvq_spec_verify_attn": _PAGED + (_I,) * 9 + (ctypes.c_float, _P),
    "gather_dequant_paged_kv": (_P,) * 4 + (_I,) * 7 + (_P,),
    "gather_dequant_paged_kv2": (_P,) * 7 + (_I,) * 7 + (_P,),
    "pool_block_copy": (_P,) * 3 + (_I,) * 2 + (ctypes.c_longlong,) * 2
    + (_I, _P),
    # four (base, layer stride, block bytes) leaves, n_leaves, pairs, n,
    # rep, NB, stream
    "pool_block_copy_multi": (_P, _L, _L) * 4 + (_I, _P) + (_I,) * 3
    + (_P,),
}
MAX_COPY_LEAVES = 4
MAX_GROUP = 10      # query heads per KV head the kernel holds on chip
HEAD_DIMS = (16, 64, 128, 256)
# K/V element types the kernels read (int8: a C8 cache; bf16: C16), and
# their element bytes, the launchers' kv_bytes
KV_DTYPES = {torch.int8: 1, torch.bfloat16: 2}
SPLIT = 64          # token positions a CTA of the split-KV kernels owns
#                     (csrc/kvq_paged_split.cuh; checked at load)


# launchers that live in another launcher's source
_SOURCE = {"gather_dequant_paged_kv2": "gather_dequant_paged_kv",
           "pool_block_copy_multi": "pool_block_copy"}


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    """The C launcher ``<name>_launch`` of its ``csrc/`` source (built at
    first use)."""
    from repro_torch.kernels.build import load
    lib = load(_SOURCE.get(name, name))
    if name in _PAGED_SPLIT and lib.kvq_paged_split_tokens() != SPLIT:
        raise RuntimeError(f"{name} was built with a split of "
                           f"{lib.kvq_paged_split_tokens()} tokens, "
                           f"SPLIT here is {SPLIT}")
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(_ARGTYPES[name])
    fn.restype = ctypes.c_int
    return fn


_PAGED_SPLIT = ("kvq_decode_attn", "kvq_paged_decode_attn",
                "kvq_spec_verify_attn")
_SCRATCH = {}       # device index -> (f32 workspace, zeroed int32 tickets)
_RETIRED = []       # outgrown scratch, held for the life of the process:
#                     a CUDA graph captured before it was outgrown may
#                     still replay into it


@functools.lru_cache(maxsize=256)
def _scratch_need(B: int, C: int, H: int, Hkv: int, D: int, T: int,
                  bs: int):
    """(f32 workspace, int32 tickets) that a split-KV launch of these
    shapes needs, as the kernel source computes them
    (``kvq_paged_split_scratch``; the three launchers compile the same
    header, so the paged decode launcher's library answers for all; the
    dense launcher asks at T = 1, bs = S)."""
    from repro_torch.kernels.build import load
    _fn("kvq_paged_decode_attn")        # built, loaded, its split checked
    get = load("kvq_paged_decode_attn").kvq_paged_split_scratch
    get.argtypes = [_I] * 7 + [ctypes.POINTER(_L)] * 2
    get.restype = _I
    ws, tk = _L(), _L()
    _raise_on(get(B, C, H, Hkv, D, T, bs, ctypes.byref(ws),
                  ctypes.byref(tk)), "kvq_paged_split_scratch")
    return ws.value, tk.value


def _scratch(dev: torch.device, ws_n: int, tk_n: int):
    """Workspace and tickets on ``dev`` of at least ``ws_n`` and ``tk_n``
    elements; grown (outside any stream capture) the first time a call
    needs more."""
    cur = _SCRATCH.get(dev.index)
    if cur is None or cur[0].numel() < ws_n or cur[1].numel() < tk_n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the split-KV attention kernels need more "
                               "scratch than a call before the capture "
                               "allocated; run the call once uncaptured")
        old_ws, old_tk = cur if cur is not None else (None, None)
        ws_n = max(ws_n, 0 if old_ws is None else 2 * old_ws.numel())
        tk_n = max(tk_n, 1024, 0 if old_tk is None else 2 * old_tk.numel())
        if cur is not None:
            _RETIRED.append(cur)
        cur = (torch.empty(ws_n, dtype=torch.float32, device=dev),
               torch.zeros(tk_n, dtype=torch.int32, device=dev))
        _SCRATCH[dev.index] = cur
    return cur


def _kv_dtype(name: str, k, v) -> int:
    """The launchers' kv_bytes for K/V of one supported dtype, else
    raise."""
    if k.dtype not in KV_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"{name} takes int8 or bf16 K/V of one dtype; got "
                         f"{k.dtype} and {v.dtype}")
    return KV_DTYPES[k.dtype]


def _check_heads(H: int, Hkv: int, D: int) -> None:
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"the kernel needs H % Hkv == 0 and H // Hkv <= "
                         f"{MAX_GROUP}; got H={H}, Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel needs D in {HEAD_DIMS}; got D={D}")


def _paged_split_call(name, q, k_pool, v_pool, s_k, s_v, block_tbl,
                      lengths, C, dims) -> torch.Tensor:
    """Launch one of the two split-KV kernels on checked inputs (C None:
    the decode launcher, one query a slot)."""
    B, H, Hkv, NB1, bs, T, D = dims
    dev = q.device
    ws, tk = _scratch(dev, *_scratch_need(B, C or 1, H, Hkv, D, T, bs))
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=dev)
    shape = (B, H, Hkv) if C is None else (B, C, H, Hkv)
    err = _fn(name)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), s_k.data_ptr(),
        s_v.data_ptr(), block_tbl.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ws.data_ptr(), ws.numel(), tk.data_ptr(),
        tk.numel(), *shape, NB1 - 1, bs, T, D, KV_DTYPES[k_pool.dtype],
        D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    return out


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _cuda_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {t.device}")


def kvq_decode_attn(q, k_q, v_q, s_k, s_v, lengths) -> torch.Tensor:
    """Decode attention over a quantized (int8) or bf16 cache.

    q (B,H,D); k_q/v_q (B,Hkv,S,D) int8 or bf16; s_k/s_v (B,Hkv,S) fp32;
    lengths (B,) int32. CPU tensors run the plain version. CUDA tensors
    launch the kernel, which takes a bf16 q, H % Hkv == 0 with at most
    10 query heads per KV head, and D of 16, 64, 128 or 256; anything
    else raises.
    On CUDA a slot's output is bitwise :func:`kvq_paged_decode_attn` of
    the same K/V in a pool, and depends only on its own length.
    """
    if q.device.type == "cpu":
        return kvq_decode_attn_ref(q, k_q, v_q, s_k, s_v, lengths)
    _cuda_only("kvq_decode_attn", q)
    B, H, D = q.shape
    Hkv, S = k_q.shape[1], k_q.shape[2]
    dev = q.device
    _check_heads(H, Hkv, D)
    kv_bytes = _kv_dtype("kvq_decode_attn", k_q, v_q)
    check_tensor("q", q, torch.bfloat16, (B, H, D), dev)
    check_tensor("k_q", k_q, k_q.dtype, (B, Hkv, S, D), dev)
    check_tensor("v_q", v_q, k_q.dtype, (B, Hkv, S, D), dev)
    check_tensor("s_k", s_k, torch.float32, (B, Hkv, S), dev)
    check_tensor("s_v", s_v, torch.float32, (B, Hkv, S), dev)
    check_tensor("lengths", lengths, torch.int32, (B,), dev)
    check_aligned("k_q", k_q)
    check_aligned("v_q", v_q)
    ws, tk = _scratch(dev, *_scratch_need(B, 1, H, Hkv, D, 1, S))
    out = torch.empty((B, H, D), dtype=torch.bfloat16, device=dev)
    err = _fn("kvq_decode_attn")(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), s_k.data_ptr(),
        s_v.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
        ws.numel(), tk.data_ptr(), tk.numel(), B, H, Hkv, S, D, kv_bytes,
        D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "kvq_decode_attn")
    kvq_decode_attn.launches += 1
    return out


kvq_decode_attn.launches = 0


def kvq_paged_decode_attn(q, k_pool, v_pool, s_k, s_v, block_tbl,
                          lengths) -> torch.Tensor:
    """Decode attention through a block table over a paged pool.

    q (B,H,D); k_pool/v_pool (NB+1,Hkv,bs,D) int8 or bf16 with the sink
    block;
    s_k/s_v (NB+1,Hkv,bs) fp32; block_tbl (B,T) int32, entries >= NB are
    sentinels (the kernel clamps them to NB-1 itself); lengths (B,) int32.
    CPU tensors run the plain version. CUDA tensors launch the kernel,
    which takes a bf16 q, H % Hkv == 0 with at most 10 query heads per KV
    head and D of 16, 64, 128 or 256; anything else raises.
    """
    if q.device.type == "cpu":
        return kvq_paged_decode_attn_ref(q, k_pool, v_pool, s_k, s_v,
                                         block_tbl, lengths)
    _cuda_only("kvq_paged_decode_attn", q)
    B, H, D = q.shape
    NB1, Hkv, bs = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    T = block_tbl.shape[1]
    dev = q.device
    _check_heads(H, Hkv, D)
    if NB1 < 2 or T < 1:
        raise ValueError(f"the kernel needs a pool of >= 1 block plus the "
                         f"sink and a table of >= 1 entry; got "
                         f"{NB1} blocks, T={T}")
    check_tensor("q", q, torch.bfloat16, (B, H, D), dev)
    _kv_dtype("kvq_paged_decode_attn", k_pool, v_pool)
    check_tensor("k_pool", k_pool, k_pool.dtype, (NB1, Hkv, bs, D), dev)
    check_tensor("v_pool", v_pool, k_pool.dtype, (NB1, Hkv, bs, D), dev)
    check_tensor("s_k", s_k, torch.float32, (NB1, Hkv, bs), dev)
    check_tensor("s_v", s_v, torch.float32, (NB1, Hkv, bs), dev)
    check_tensor("block_tbl", block_tbl, torch.int32, (B, T), dev)
    check_tensor("lengths", lengths, torch.int32, (B,), dev)
    check_aligned("k_pool", k_pool)
    check_aligned("v_pool", v_pool)
    out = _paged_split_call("kvq_paged_decode_attn", q, k_pool, v_pool, s_k,
                            s_v, block_tbl, lengths, None,
                            (B, H, Hkv, NB1, bs, T, D))
    kvq_paged_decode_attn.launches += 1
    return out


kvq_paged_decode_attn.launches = 0


def kvq_spec_verify_attn(q, k_pool, v_pool, s_k, s_v, block_tbl,
                         lengths) -> torch.Tensor:
    """The verify-wave's attention: C queries per slot through the block
    table, each over its own extent.

    q (B,C,H,D); k_pool/v_pool (NB+1,Hkv,bs,D) int8 or bf16 with the
    sink block;
    s_k/s_v (NB+1,Hkv,bs) fp32; block_tbl (B,T) int32, entries >= NB are
    sentinels (the kernel clamps them to NB-1 itself); lengths (B,C)
    int32. Query c of slot b equals :func:`kvq_paged_decode_attn` of that
    query at ``lengths[:, c]``, bitwise on CUDA. CPU tensors run the
    plain version. CUDA tensors launch the kernel, which takes a bf16 q,
    H % Hkv == 0 with at most 10 query heads per KV head and D of 16, 64,
    128 or 256; anything else raises.
    """
    if q.device.type == "cpu":
        return kvq_spec_verify_attn_ref(q, k_pool, v_pool, s_k, s_v,
                                        block_tbl, lengths)
    _cuda_only("kvq_spec_verify_attn", q)
    B, C, H, D = q.shape
    NB1, Hkv, bs = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    T = block_tbl.shape[1]
    dev = q.device
    _check_heads(H, Hkv, D)
    if NB1 < 2 or T < 1 or C < 1:
        raise ValueError(f"the kernel needs a pool of >= 1 block plus the "
                         f"sink, a table of >= 1 entry and C >= 1; got "
                         f"{NB1} blocks, T={T}, C={C}")
    check_tensor("q", q, torch.bfloat16, (B, C, H, D), dev)
    _kv_dtype("kvq_spec_verify_attn", k_pool, v_pool)
    check_tensor("k_pool", k_pool, k_pool.dtype, (NB1, Hkv, bs, D), dev)
    check_tensor("v_pool", v_pool, k_pool.dtype, (NB1, Hkv, bs, D), dev)
    check_tensor("s_k", s_k, torch.float32, (NB1, Hkv, bs), dev)
    check_tensor("s_v", s_v, torch.float32, (NB1, Hkv, bs), dev)
    check_tensor("block_tbl", block_tbl, torch.int32, (B, T), dev)
    check_tensor("lengths", lengths, torch.int32, (B, C), dev)
    check_aligned("k_pool", k_pool)
    check_aligned("v_pool", v_pool)
    out = _paged_split_call("kvq_spec_verify_attn", q, k_pool, v_pool, s_k,
                            s_v, block_tbl, lengths, C,
                            (B, H, Hkv, NB1, bs, T, D))
    kvq_spec_verify_attn.launches += 1
    return out


kvq_spec_verify_attn.launches = 0


def gather_dequant_paged_kv(pool, s_pool, block_tbl) -> torch.Tensor:
    """Dequantized history gather for the batched tail-wave.

    pool (NB+1,Hkv,bs,D) int8 or bf16 with the sink block; s_pool
    (NB+1,Hkv,bs) fp32; block_tbl (n,T) int32 (sentinels clamped to
    NB-1). Returns (n,Hkv,T*bs,D) f32, bitwise equal to the plain
    version. CPU tensors run the plain version; CUDA tensors launch the
    kernel (D % 16 == 0).
    """
    if pool.device.type == "cpu":
        return gather_dequant_paged_kv_ref(pool, s_pool, block_tbl)
    out = _gather_out(pool, s_pool, block_tbl)
    err = _fn("gather_dequant_paged_kv")(
        pool.data_ptr(), s_pool.data_ptr(), block_tbl.data_ptr(),
        out.data_ptr(), *_gather_dims(pool, block_tbl),
        torch.cuda.current_stream(pool.device).cuda_stream)
    _raise_on(err, "gather_dequant_paged_kv")
    gather_dequant_paged_kv.launches += 1
    return out


def gather_dequant_paged_kv_pair(k_pool, s_k, v_pool, s_v, block_tbl):
    """:func:`gather_dequant_paged_kv` of a layer's K and V leaves through
    one table: (kh, vh), each bitwise what the one-leaf call returns. CUDA
    tensors run one launch of the gather kernel for both."""
    if k_pool.device.type == "cpu":
        return (gather_dequant_paged_kv_ref(k_pool, s_k, block_tbl),
                gather_dequant_paged_kv_ref(v_pool, s_v, block_tbl))
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"K and V pools differ in shape: "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    kh = _gather_out(k_pool, s_k, block_tbl)
    vh = _gather_out(v_pool, s_v, block_tbl)
    err = _fn("gather_dequant_paged_kv2")(
        k_pool.data_ptr(), s_k.data_ptr(), v_pool.data_ptr(),
        s_v.data_ptr(), block_tbl.data_ptr(), kh.data_ptr(), vh.data_ptr(),
        *_gather_dims(k_pool, block_tbl),
        torch.cuda.current_stream(k_pool.device).cuda_stream)
    _raise_on(err, "gather_dequant_paged_kv")
    gather_dequant_paged_kv.launches += 1
    return kh, vh


def _gather_dims(pool, block_tbl):
    """The gather launchers' (n, Hkv, NB, bs, T, D, kv_bytes)."""
    NB1, Hkv, bs, D = pool.shape
    n, T = block_tbl.shape
    return n, Hkv, NB1 - 1, bs, T, D, KV_DTYPES[pool.dtype]


def _gather_out(pool, s_pool, block_tbl) -> torch.Tensor:
    """Check one leaf's gather inputs; its (n,Hkv,T*bs,D) f32 output."""
    _cuda_only("gather_dequant_paged_kv", pool)
    NB1, Hkv, bs, D = pool.shape
    n, T = block_tbl.shape
    dev = pool.device
    if D % 16 or NB1 < 2 or T < 1:
        raise ValueError(f"the kernel needs D % 16 == 0, a pool of >= 1 "
                         f"block plus the sink and T >= 1; got D={D}, "
                         f"{NB1} blocks, T={T}")
    if pool.dtype not in KV_DTYPES:
        raise ValueError(f"the kernel takes int8 or bf16 pools; got "
                         f"{pool.dtype}")
    check_tensor("pool", pool, pool.dtype, (NB1, Hkv, bs, D), dev)
    check_tensor("s_pool", s_pool, torch.float32, (NB1, Hkv, bs), dev)
    check_tensor("block_tbl", block_tbl, torch.int32, (n, T), dev)
    check_aligned("pool", pool)
    return torch.empty((n, Hkv, T * bs, D), dtype=torch.float32, device=dev)


gather_dequant_paged_kv.launches = 0


def copy_pool_blocks(pool, src, dst) -> torch.Tensor:
    """Copy-on-write block clone, in place, over a layer-stacked leaf.

    pool (rep, NB+1, ...) int8 payload or fp32 scales with the sink block;
    src/dst (n,) int32 block-id pairs, ``dst`` entries >= NB are padding
    and write nothing. Returns ``pool``. CPU tensors run the plain
    version; CUDA tensors launch the kernel, which copies whole blocks
    (every dim after the block axis contiguous).
    """
    if pool.device.type == "cpu":
        return copy_pool_blocks_ref(pool, src, dst)
    _cuda_only("copy_pool_blocks", pool)
    dev = pool.device
    (n,) = src.shape
    dims = _copy_leaf_dims(pool)
    check_tensor("src", src, torch.int32, (n,), dev)
    check_tensor("dst", dst, torch.int32, (n,), dev)
    rep, nb1 = pool.shape[0], pool.shape[1]
    err = _fn("pool_block_copy")(
        pool.data_ptr(), src.data_ptr(), dst.data_ptr(), n, rep, *dims,
        nb1 - 1,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "pool_block_copy")
    copy_pool_blocks.launches += 1
    return pool


copy_pool_blocks.launches = 0


def _copy_leaf_dims(pool) -> tuple:
    """Check one layer-stacked leaf for the copy kernel; its (layer
    stride, block) in bytes."""
    if pool.shape[1] < 2:
        raise ValueError("the kernel needs a pool of >= 1 block plus the "
                         "sink")
    if not pool[0].is_contiguous() or pool.stride(0) < pool[0].numel():
        raise ValueError("pool must hold each layer's blocks contiguously")
    es = pool.element_size()
    return pool.stride(0) * es, pool[0, 0].numel() * es


def copy_pool_blocks_multi(leaves, pairs) -> list:
    """Copy-on-write block clone, in place, over up to
    ``MAX_COPY_LEAVES`` layer-stacked leaves at once (the engine passes
    its four pool leaves): ``leaf[:, dst[i]] = leaf[:, src[i]]`` in every
    leaf.

    leaves: int8 payloads or fp32 scales (rep, NB+1, ...) with the sink
    block, all with the same rep and NB + 1; pairs (2, n) int32, the src
    ids then the dst ids, ``dst`` entries >= NB padding. Returns the
    leaves as a list. CPU tensors run the plain version; CUDA tensors
    launch the kernel once, with each leaf checked as
    :func:`copy_pool_blocks` checks its one.
    """
    leaves = list(leaves)
    if not 1 <= len(leaves) <= MAX_COPY_LEAVES:
        raise ValueError(f"the kernel takes 1 to {MAX_COPY_LEAVES} leaves, "
                         f"got {len(leaves)}")
    if pairs.device.type == "cpu" and all(
            leaf.device.type == "cpu" for leaf in leaves):
        return copy_pool_blocks_multi_ref(leaves, pairs)
    _cuda_only("copy_pool_blocks_multi", leaves[0])
    dev = leaves[0].device
    rep, nb1 = leaves[0].shape[:2]
    descs = []
    for j, leaf in enumerate(leaves):
        if leaf.device != dev:
            raise ValueError(f"leaf {j} is on {leaf.device}, expected {dev}")
        if tuple(leaf.shape[:2]) != (rep, nb1):
            raise ValueError(f"every leaf needs {rep} layers of {nb1} "
                             f"blocks; leaf {j} has shape "
                             f"{tuple(leaf.shape)}")
        descs += [leaf.data_ptr(), *_copy_leaf_dims(leaf)]
    descs += [None, 0, 0] * (MAX_COPY_LEAVES - len(leaves))
    n = pairs.shape[-1]
    check_tensor("pairs", pairs, torch.int32, (2, n), dev)
    err = _fn("pool_block_copy_multi")(
        *descs, len(leaves), pairs.data_ptr(), n, rep, nb1 - 1,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "pool_block_copy_multi")
    copy_pool_blocks_multi.launches += 1
    return leaves


copy_pool_blocks_multi.launches = 0


def commit_chunk_kv(cache: dict, k_q, v_q, s_k, s_v, block_tbl, offset,
                    chunk_len) -> None:
    """Commit a batch of prefill windows into one layer's block pool, in
    place, with per-row write offsets.

    cache: layer dict with pool leaves k_q/v_q (NB+1,Hkv,bs,D) and s_k/s_v
    (NB+1,Hkv,bs). k_q/v_q (n,Hkv,C,D) int, s_k/s_v (n,Hkv,C) fp32: the
    quantized windows of n slots, row i starting at absolute position
    ``offset[i]`` with ``chunk_len[i]`` real tokens; block_tbl (n,T).
    Padding rows and positions land in the sink. A plain indexed scatter
    on every device, as in the reference (its XLA scatter is already
    memory-bound-optimal; a kernel would move the same bytes).
    """
    bs = cache["k_q"].shape[2]
    blk, off = chunk_commit_ids(block_tbl, offset, chunk_len, k_q.shape[2],
                                bs, pool_blocks(cache["k_q"]))
    scatter_chunk_kv(cache["k_q"], k_q.transpose(1, 2), blk, off)
    scatter_chunk_kv(cache["v_q"], v_q.transpose(1, 2), blk, off)
    scatter_chunk_kv(cache["s_k"], s_k.transpose(1, 2), blk, off)
    scatter_chunk_kv(cache["s_v"], s_v.transpose(1, 2), blk, off)
