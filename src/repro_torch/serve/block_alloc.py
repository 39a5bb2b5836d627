"""Host-side block allocator for the paged quantized KV cache.

The device holds one global pool of fixed-size cache blocks per attention
layer (``(num_blocks, Hkv, block_size, D)`` int8 + per-token scales); this
allocator owns the pool bookkeeping and decides which pool blocks back
which slot. The engine mirrors the resulting ``(slots, table_len)`` block
table on the host and pushes it to the device at admission/chunk
boundaries, so the compiled decode program only ever *reads* the table.

Ownership is **refcounted**: a pool block may back several slots at once
(prefix sharing), and a block whose refcount drops to zero but that is
still content-addressed by the prefix index parks on an LRU of
*evictable* blocks instead of the free list — it can be resurrected by a
later request with the same prompt prefix, or evicted when the pool needs
a fresh block. Every block is therefore in exactly one of three states:

* **free**      — on the free list, contents meaningless;
* **mapped**    — refcount >= 1, referenced by that many slot tables;
* **evictable** — refcount 0 but registered in the prefix index (LRU).

**Prefix index**: full blocks of *written* tokens are content-addressed by
a rolling hash chain (``sha256(parent_digest + block_tokens)``), so a
lookup walks a prompt block-by-block and returns the longest cached chain.
The final *partial* block of a prompt (``len % block_size`` tokens) is
registered too, keyed by its parent chain digest with the partial token
content stored verbatim — a lookup takes the longest common prefix with
the new prompt, finding the exact divergence point. That is the "split
block" two requests with a common prefix share until one of them writes
past the shared extent (copy-on-write).

**Copy-on-write**: writes go through ``cow_range`` first — a block that is
shared (refcount > 1) and not owned by the writing slot is replaced by a
fresh block and the caller is told to device-copy the payload. The *owner*
(the slot that originally filled the block) may keep appending beyond the
registered extent without a copy: readers only ever trust the extent the
index recorded.

Two admission disciplines coexist, chosen per slot:

* ``reserve``  — the slot's worst-case block count is debited up front
  (``ceil((prompt + max_new - 1) / block_size)``, minus blocks obtained by
  sharing, plus one for the potential split-block COW), so a resident can
  never strand mid-decode. ``ensure`` outgrowing the reservation is an
  accounting bug (RuntimeError).
* ``register`` — optimistic: no reservation; ``ensure``/``cow_range`` on a
  dry pool raise :class:`PoolDry` and the engine preempts (swaps out) a
  victim to make room.

Entries never allocated stay at the ``num_blocks`` sentinel. On the
device every pool leaf holds one block more, row ``num_blocks``, so the
scatters write sentinel destinations into that sink and the gathers
clamp sentinels to ``num_blocks - 1``.

This module is the port's own copy of the reference's allocator (plain
numpy and hashlib): the decisions and block tables are the same.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PoolDry(RuntimeError):
    """Raised when an optimistic (unreserved) slot needs a block and the
    pool has neither free nor evictable blocks — the engine's cue to
    preempt a victim."""


def _digest(parent: bytes, tokens: np.ndarray) -> bytes:
    return hashlib.sha256(
        parent + np.ascontiguousarray(tokens, np.int32).tobytes()).digest()


class BlockAllocator:
    """Refcounted allocator over ``num_blocks`` cache blocks of
    ``block_size`` tokens, with a content-addressed prefix index."""

    def __init__(self, num_blocks: int, block_size: int, slots: int,
                 table_len: int, prefix_cache: bool = True):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.table_len = table_len
        self.prefix_cache = prefix_cache
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = [0] * num_blocks                # block -> map count
        self._owned: Dict[int, List[int]] = {}      # slot -> block ids
        self._reserved: Dict[int, int] = {}         # slot -> fresh blocks
        self._owner: Dict[int, int] = {}            # block -> filling slot
        # prefix index: chain digest -> block for *full* blocks; split
        # (partial) blocks are keyed by their parent chain digest with the
        # partial token content stored verbatim, so a lookup can find the
        # exact divergence point inside the block. _meta inverts both for
        # eviction bookkeeping; a block can carry BOTH a partial and a
        # full entry — a split block registered at admission is promoted
        # once decode fills it (harvest), keeping the chain walkable past
        # it without orphaning the split-sharing entry.
        self._index: Dict[bytes, int] = {}
        self._partial: Dict[bytes, Tuple[int, np.ndarray]] = {}
        self._meta: Dict[int, List[Tuple[str, bytes]]] = {}
        self.index_version = 0          # bumped on any index mutation
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # evictable
        self.peak_blocks = 0
        self.prefix_lookups = 0
        self.prefix_hit_blocks = 0
        self.prefix_evictions = 0
        # host mirror of the device block table; sentinel = num_blocks
        self.tables = np.full((slots, table_len), num_blocks, np.int32)

    # ---- accounting ----
    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` (ceil division, clamped at 0).

        >>> alloc = BlockAllocator(8, 16, slots=2, table_len=4)
        >>> alloc.blocks_for_tokens(17)
        2
        >>> alloc.blocks_for_tokens(0)
        0
        """
        return -(-max(n_tokens, 0) // self.block_size)

    @property
    def allocated_blocks(self) -> int:
        """Blocks currently mapped by at least one slot."""
        return self.num_blocks - len(self._free) - len(self._lru)

    @property
    def cached_blocks(self) -> int:
        """Evictable blocks kept alive only by the prefix index."""
        return len(self._lru)

    @property
    def free_blocks(self) -> int:
        """Blocks obtainable right now (free + evictable) and not promised
        to a reserved slot."""
        return (len(self._free) + len(self._lru)
                - sum(self._reserved.values()))

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))

    # ---- prefix index ----
    def lookup(self, prompt: np.ndarray) -> Tuple[List[int], int, bool]:
        """Longest cached chain for ``prompt``: (block ids, cached tokens,
        last-hit-is-partial). Capped at ``len(prompt) - 1`` so at least one
        tail token is always left to recompute (its logits seed sampling).
        Side-effect free — pair with ``reserve``/``register`` to map."""
        if not self.prefix_cache:
            return [], 0, False
        self.prefix_lookups += 1
        bs = self.block_size
        cap = len(prompt) - 1
        ids: List[int] = []
        cached = 0
        parent = b""
        while cached + bs <= cap:
            key = _digest(parent, prompt[cached:cached + bs])
            blk = self._index.get(key)
            if blk is None:
                break
            ids.append(blk)
            cached += bs
            parent = key
        partial = False
        # split block: a partial block registered under this chain stores
        # its token content, so the longest common prefix IS the exact
        # point where the two prompts diverge
        entry = self._partial.get(parent)
        if entry is not None:
            blk, toks = entry
            lim = min(len(toks), cap - cached)
            p = 0
            while p < lim and toks[p] == prompt[cached + p]:
                p += 1
            if p > 0 and blk not in ids:
                ids.append(blk)
                cached += p
                partial = True
        self.prefix_hit_blocks += len(ids)
        return ids, cached, partial

    def register_prefix(self, slot: int, tokens: np.ndarray,
                        upto: int) -> None:
        """Content-address the slot's blocks covering ``tokens[:upto]``
        (all written): full blocks plus the trailing partial extent.
        Content already indexed is skipped; a block registered as a split
        block earlier (at admission) gains a full entry once filled, and
        its split entry's stored content is extended in place — so a
        harvest-time pass indexes the *decoded* stream too (multi-turn
        continuations hit blocks written by decode)."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        owned = self._owned.get(slot, [])
        parent = b""
        for i in range(upto // bs):
            if i >= len(owned):
                return
            key = _digest(parent, tokens[i * bs:(i + 1) * bs])
            parent = key
            if key in self._index:
                continue                      # same content already cached
            blk = owned[i]
            if any(k == "full" for k, _ in self._meta.get(blk, ())):
                return        # full under another key: defensive dead-end
            self._index[key] = blk
            self._meta.setdefault(blk, []).append(("full", key))
            self.index_version += 1
        p = upto % bs
        i = upto // bs
        if p and i < len(owned):
            blk = owned[i]
            ext = np.array(tokens[i * bs:upto], np.int32)
            cur = self._partial.get(parent)
            if cur is None:
                if not any(k == "partial"
                           for k, _ in self._meta.get(blk, ())):
                    self._partial[parent] = (blk, ext)
                    self._meta.setdefault(blk, []).append(
                        ("partial", parent))
                    self.index_version += 1
            elif (cur[0] == blk and len(ext) > len(cur[1])
                  and np.array_equal(ext[:len(cur[1])], cur[1])):
                # same split block, longer content (harvest extending the
                # admission-time entry): every old match stays a prefix
                self._partial[parent] = (blk, ext)
                self.index_version += 1

    # ---- lifecycle ----
    def _map_shared(self, slot: int, ids: Sequence[int]) -> None:
        owned = self._owned[slot]
        for b in ids:
            if self._ref[b] == 0:
                self._lru.pop(b)              # resurrect an evictable block
            self._ref[b] += 1
            self.tables[slot, len(owned)] = b
            owned.append(b)

    def reserve(self, slot: int, n_tokens: int,
                shared: Sequence[int] = (), partial: bool = False) -> bool:
        """Debit the slot's worst-case *fresh* block count (total minus
        ``shared`` prefix blocks, plus one if the last shared block is
        partial — its split-block COW needs a fresh block); False if the
        pool can't honor it right now (the request stays queued)."""
        nb = self.blocks_for_tokens(n_tokens)
        fresh = max(nb - len(shared) + (1 if partial else 0), 0)
        # shared hits parked on the evictable LRU leave the obtainable
        # pool the moment they are mapped: budget them alongside the
        # fresh blocks, or the reservation guarantee silently breaks
        resurrect = sum(1 for b in shared if self._ref[b] == 0)
        if fresh + resurrect > self.free_blocks or slot in self._owned:
            return False
        self._reserved[slot] = fresh
        self._owned[slot] = []
        self._map_shared(slot, shared)
        return True

    def register(self, slot: int, shared: Sequence[int] = ()) -> None:
        """Optimistic admission: map the shared prefix, reserve nothing.
        Later ``ensure``/``cow_range`` growth may raise :class:`PoolDry`."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already admitted")
        self._owned[slot] = []
        self._map_shared(slot, shared)

    def _take_block(self, slot: int) -> Optional[int]:
        """One fresh block for ``slot``: free list first, then evict the
        LRU prefix-cached block. None when the pool is truly dry."""
        if self._free:
            b = self._free.pop()
        elif self._lru:
            b, _ = self._lru.popitem(last=False)
            for kind, key in self._meta.pop(b):
                del (self._index if kind == "full" else self._partial)[key]
            self.prefix_evictions += 1
            self.index_version += 1
        else:
            return None
        self._ref[b] = 1
        self._owner[b] = slot
        return b

    def _debit(self, slot: int) -> int:
        """Account one fresh block against the slot's discipline, then
        take it. Raises RuntimeError (reserved slot outgrowing its debit —
        an admission accounting bug) or PoolDry (optimistic slot, empty
        pool)."""
        reserved = slot in self._reserved
        if reserved and self._reserved[slot] <= 0:
            raise RuntimeError(
                f"slot {slot} outgrew its reservation "
                f"({len(self._owned[slot])} owned, 0 reserved, "
                f"{len(self._free)} free) — admission accounting bug")
        b = self._take_block(slot)
        if b is None:
            if reserved:
                raise RuntimeError(
                    f"slot {slot} has a reservation but the pool is dry "
                    f"— admission accounting bug")
            raise PoolDry(
                f"slot {slot} needs a block but the pool is dry "
                f"({self.allocated_blocks} mapped, 0 free, 0 evictable)")
        if reserved:
            self._reserved[slot] -= 1
        return b

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow the slot's table to cover ``n_tokens``; returns True if any
        new block was allocated (the device table needs a push)."""
        need = self.blocks_for_tokens(n_tokens)
        owned = self._owned[slot]
        if need > self.table_len:
            raise ValueError(
                f"slot {slot} needs {need} blocks but the block table is "
                f"only {self.table_len} entries wide")
        grew = False
        while len(owned) < need:
            b = self._debit(slot)
            self.tables[slot, len(owned)] = b
            owned.append(b)
            grew = True
        self.peak_blocks = max(self.peak_blocks, self.allocated_blocks)
        return grew

    def _frozen_extent(self, blk: int) -> int:
        """Tokens of ``blk`` the prefix index content-addresses (0 when
        unregistered). Writes below this offset by anyone but the block's
        filling owner must copy first — in-place they would silently
        invalidate what the index promises readers."""
        return max((self.block_size if kind == "full"
                    else len(self._partial[key][1])
                    for kind, key in self._meta.get(blk, ())), default=0)

    def cow_range(self, slot: int, start_tok: int,
                  end_tok: int) -> List[Tuple[int, int]]:
        """Copy-on-write pass for a pending write of token positions
        ``[start_tok, end_tok)``: every covered block that is shared
        (mapped by another slot, or registered in the prefix index below
        the write offset) is replaced with a fresh block — unless this
        slot filled the block itself and is appending past the registered
        extent. Returns (src, dst) pairs the caller must device-copy
        *before* the write executes. The needed block count is checked up
        front, so a PoolDry/RuntimeError raise leaves the table untouched
        — the caller preempts and simply calls again."""
        owned = self._owned.get(slot)
        if not owned:
            return []
        bs = self.block_size

        def needs_cow(i: int) -> bool:
            b = owned[i]
            if self._owner.get(b) == slot:
                return False
            wstart = max(start_tok - i * bs, 0)  # first offset written in b
            return self._ref[b] > 1 or wstart < self._frozen_extent(b)

        lo = max(start_tok, 0) // bs
        hi = min(self.blocks_for_tokens(end_tok), len(owned))
        need = sum(needs_cow(i) for i in range(lo, hi))
        if need:
            physical = len(self._free) + len(self._lru)
            if slot in self._reserved and self._reserved[slot] < need:
                raise RuntimeError(
                    f"slot {slot} needs {need} COW blocks but reserved "
                    f"only {self._reserved[slot]} — admission accounting "
                    f"bug")
            if physical < need:
                if slot in self._reserved:
                    raise RuntimeError(
                        f"slot {slot} has a reservation but the pool is "
                        f"dry — admission accounting bug")
                raise PoolDry(
                    f"slot {slot} needs {need} COW blocks but the pool "
                    f"is dry")
        pairs: List[Tuple[int, int]] = []
        for i in range(lo, hi):
            if not needs_cow(i):
                continue
            b = owned[i]
            dst = self._debit(slot)
            self._ref[b] -= 1
            if self._ref[b] == 0:
                # sole mapper walked away from a registered block: it
                # stays resurrectable through the index (evictable LRU)
                self._owner.pop(b, None)
                self._lru[b] = None
            owned[i] = dst
            self.tables[slot, i] = dst
            pairs.append((b, dst))
        if pairs:
            self.peak_blocks = max(self.peak_blocks, self.allocated_blocks)
        return pairs

    def _return_block(self, b: int) -> None:
        """Send a refcount-zero block back to the pool: the evictable LRU
        when the prefix index still addresses it, else the free list."""
        if b in self._meta:
            self._lru[b] = None           # most-recently released
        else:
            self._free.append(b)

    def trim(self, slot: int, n_tokens: int) -> int:
        """Shrink the slot's mapping to its first ``n_tokens`` tokens —
        the speculative-decode *rollback* primitive: the verify-wave
        writes ``k + 1`` candidate tokens' KV through the table, and the
        rejected suffix's whole blocks are released here.

        Per-block semantics match ``release``: refcounts drop, blocks
        other slots still map survive for them, blocks the prefix index
        addresses park on the evictable LRU (their content stays
        resurrectable), and ownership dies with the trim. Blocks this
        slot obtained fresh under a ``reserve`` discipline credit the
        reservation back when they return to the obtainable pool, so a
        rolled-back slot can regrow without outgrowing its debit.

        The kept boundary block is repaired against the index: when this
        slot owns it (and may therefore rewrite it in place without a
        COW), index entries addressing content beyond the retained
        in-block extent are dropped (full) or truncated (partial) — a
        later in-place write must not silently invalidate what the index
        promises readers. Returns the number of blocks released.
        """
        owned = self._owned.get(slot)
        if owned is None:
            raise ValueError(f"slot {slot} is not admitted")
        keep = self.blocks_for_tokens(n_tokens)
        # boundary repair applies only when the trim actually cuts into
        # owned content (a trim past the owned extent is a no-op)
        boundary = owned[keep - 1] if 0 < keep <= len(owned) else None
        cut = owned[keep:]
        for b in cut:
            self._ref[b] -= 1
            if self._ref[b] < 0:
                raise RuntimeError(f"block {b} refcount went negative — "
                                   f"double trim/release")
            was_owner = self._owner.get(b) == slot
            if was_owner:
                del self._owner[b]
            if self._ref[b] == 0:
                # obtainable again: blocks this slot debited fresh go
                # back into its reservation budget (physical and
                # promised capacity move together, so the free_blocks
                # guarantee is preserved)
                if was_owner and slot in self._reserved:
                    self._reserved[slot] += 1
                self._return_block(b)
        del owned[keep:]
        self.tables[slot, keep:] = self.num_blocks
        if boundary is not None and self._owner.get(boundary) == slot:
            self._repair_boundary(boundary,
                                  n_tokens - (keep - 1) * self.block_size)
        return len(cut)

    def _repair_boundary(self, blk: int, off: int) -> None:
        """Drop/truncate index entries of ``blk`` addressing content past
        the retained ``off`` tokens. Only reached when the trimming slot
        owns the block — owners append in place without COW, so stale
        entries would otherwise promise readers content about to be
        overwritten."""
        ents = self._meta.get(blk)
        if not ents or off >= self.block_size:
            return
        kept = []
        for kind, key in ents:
            if kind == "full":
                del self._index[key]
                self.index_version += 1
                continue
            b, toks = self._partial[key]
            if len(toks) > off:
                if off > 0:
                    self._partial[key] = (b, np.array(toks[:off], np.int32))
                    kept.append((kind, key))
                else:
                    del self._partial[key]
                self.index_version += 1
            else:
                kept.append((kind, key))
        if kept:
            self._meta[blk] = kept
        else:
            del self._meta[blk]

    def release(self, slot: int) -> int:
        """Unmap the slot's blocks and drop its remaining reservation.
        Blocks whose refcount hits zero return to the pool — to the free
        list, or to the evictable LRU when the prefix index still addresses
        them. Returns the number of blocks that reached refcount zero."""
        owned = self._owned.pop(slot, [])
        self._reserved.pop(slot, None)
        n_zero = 0
        for b in owned:
            self._ref[b] -= 1
            if self._ref[b] < 0:
                raise RuntimeError(f"block {b} refcount went negative — "
                                   f"double release")
            if self._owner.get(b) == slot:
                # ownership dies with the filling slot even while sharers
                # keep the block alive: slot ids are recycled, and a later
                # occupant of this id must not inherit the in-place-write
                # privilege (it would skip COW on a shared/frozen block)
                del self._owner[b]
            if self._ref[b] == 0:
                n_zero += 1
                self._return_block(b)
        self.tables[slot, :] = self.num_blocks
        return n_zero

    # ---- invariants (exercised by the property test) ----
    def check(self) -> None:
        """Block conservation + table consistency; raises AssertionError."""
        states = [0] * self.num_blocks
        for b in self._free:
            states[b] += 1
            assert self._ref[b] == 0, f"free block {b} has refs"
        for b in self._lru:
            states[b] += 1
            assert self._ref[b] == 0, f"evictable block {b} has refs"
            assert b in self._meta, f"evictable block {b} not indexed"
        mapped = {}
        for slot, owned in self._owned.items():
            row = self.tables[slot]
            for i, b in enumerate(owned):
                mapped[b] = mapped.get(b, 0) + 1
                assert row[i] == b, f"table/owned mismatch at {slot},{i}"
            assert (row[len(owned):] == self.num_blocks).all(), \
                f"slot {slot} table tail not sentinel"
        for b in range(self.num_blocks):
            assert self._ref[b] == mapped.get(b, 0), \
                f"block {b} ref {self._ref[b]} != {mapped.get(b, 0)} views"
            if self._ref[b] > 0:
                states[b] += 1
            assert states[b] == 1, f"block {b} in {states[b]} states"
        for key, b in self._index.items():
            assert ("full", key) in self._meta.get(b, ()), \
                f"index/meta mismatch for block {b}"
        for key, (b, toks) in self._partial.items():
            assert ("partial", key) in self._meta.get(b, ()), \
                f"partial/meta mismatch for block {b}"
            assert 0 < len(toks) < self.block_size, \
                f"split block {b} has a non-partial extent {len(toks)}"
        for b, ents in self._meta.items():
            kinds = [k for k, _ in ents]
            assert len(kinds) == len(set(kinds)) and ents, \
                f"block {b} has duplicate-kind index entries"
        for b, s in self._owner.items():
            assert b in self._owned.get(s, ()), \
                f"block {b} owned by slot {s} that no longer maps it"
        assert sum(len(v) for v in self._meta.values()) \
            == len(self._index) + len(self._partial), \
            "meta count != index entries"
        assert sum(v >= 0 for v in self._reserved.values()) \
            == len(self._reserved), "negative reservation"
