"""The collectives of tensor-parallel serving and of data-parallel
training, by hand.

In the JAX package GSPMD inserts these from the sharding rules; here the
model code calls them where a sharded operand meets a replicated one:

* ``all_reduce_max`` (f32): the per-token amax of a row-parallel
  linear's input slice, so its dynamic int8 scale is the whole row's;
* ``all_reduce_sum`` (int32): the row-parallel linear's accumulators
  (exact integer sums, in any order);
* ``all_gather_last``: the column-parallel head's vocabulary slices, in
  rank order, into the whole logits;
* ``embed_lookup``: the vocabulary-sharded embedding's masked local
  lookup, summed exactly (each token's row lives on one rank, the other
  ranks add zeros; the sum runs on the bit patterns as integers, so even
  a ``-0.0`` survives);
* ``sum_owned``: an MoE layer's combine under expert parallelism: each
  element (a bf16 expert output in a token's top-k slot) is filled on
  the one rank that holds its expert and is zero elsewhere, so the sum
  of the bit patterns as integers is the owner's bits (a ``-0.0`` and a
  NaN survive, which an f32 sum of the slots would not guarantee);
* ``all_reduce_sum_f32``: the f32 partials of an expert bank split
  inside its experts (``wd`` row-parallel over d_ff), not exact;
* ``broadcast_floats``: rank 0's host values (the engine's command, its
  clock, its measured rates, the probe's pick), so every rank's host
  loop takes the same decisions;
* ``broadcast_submissions``: the requests submitted on rank 0 since the
  engine's last host step (a frontend lives on rank 0), as one f64
  tensor, so every rank enqueues the same requests.

Every call counts one in :attr:`TPComm.census` by kind: a decode step of
a dense decoder makes two MAX and two SUM all-reduces a layer (``wo``,
``wd``), one SUM for the embedding and one all-gather for the logits;
an expert-parallel MoE layer one MAX and one SUM (``wo``) and one
``all_reduce_owned`` (the combine); a layer whose attention every rank
runs whole none for its attention.
The census is the port's form of the reference's rule on the compiled
decode wave (``collective_counts`` / ``pool_allgather_sites``: at least
one all-reduce, at most two all-gathers, no KV pool leaf gathered);
``watch`` (a set) collects the storage of every tensor handed to a
collective, so a check can prove that no pool leaf was.

:class:`DPComm` is the data axis's: where the reference's train step,
jitted over a data axis, gets its all-reduces from GSPMD, the port's
step sums its gradients here in f32 buckets (``sync_grads``), and the
loss's global statistics (the mask count, an MoE layer's routing sums)
through ``sum_forward``, whose backward stays local.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import torch

# a submission's fields besides its prompt (``broadcast_submissions``):
# the request's own, and its submit time on rank 0's clock
SUBMISSION_KEYS = ("uid", "max_new_tokens", "eos_id", "temperature",
                   "top_k", "seed", "deadline_ms", "priority", "submit_t")
_INT_KEYS = ("uid", "max_new_tokens", "eos_id", "top_k", "seed",
             "priority")

KINDS = ("all_reduce_max", "all_reduce_sum", "all_reduce_sum_f32",
         "all_reduce_owned", "all_gather", "broadcast")
ALL_REDUCE_KINDS = tuple(k for k in KINDS if k.startswith("all_reduce"))


class TPComm:
    """One rank's collectives over the mesh's model axis."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self._dist = dist
        self.group = mesh.group
        self.size = int(mesh.shape["model"])
        self.rank = int(mesh.rank)
        self.census: Counter = Counter()
        self.watch: Optional[set] = None

    def __repr__(self) -> str:
        return f"TPComm(rank={self.rank}, size={self.size})"

    def _note(self, kind: str, t: torch.Tensor) -> None:
        self.census[kind] += 1
        if self.watch is not None:
            self.watch.add(t.untyped_storage().data_ptr())

    def counts(self) -> dict:
        """The census by kind, with ``all_reduce`` the sum of the
        all-reduce kinds."""
        d = {k: int(self.census[k]) for k in KINDS}
        d["all_reduce"] = sum(d[k] for k in ALL_REDUCE_KINDS)
        return d

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the elementwise max over the ranks (f32)."""
        if t.dtype != torch.float32:
            raise TypeError(f"all_reduce_max takes f32, got {t.dtype}")
        self._note("all_reduce_max", t)
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MAX,
                              group=self.group)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the elementwise sum over the ranks (int32, exact)."""
        if t.dtype != torch.int32:
            raise TypeError(f"all_reduce_sum takes int32 (an exact sum), "
                            f"got {t.dtype}")
        self._note("all_reduce_sum", t)
        self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        return t

    def all_reduce_sum_f32(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the elementwise f32 sum over the ranks (rounded: the
        partials of a split the int32 path cannot take)."""
        if t.dtype != torch.float32:
            raise TypeError(f"all_reduce_sum_f32 takes f32, got {t.dtype}")
        self._note("all_reduce_sum_f32", t)
        self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        return t

    def sum_owned(self, t: torch.Tensor) -> torch.Tensor:
        """Every element from the one rank that owns it: ``t`` holds this
        rank's elements and zero bits elsewhere, each element nonzero on
        at most one rank. The bit patterns are summed as integers, so the
        result is the owners' bits exactly. A 2-byte tensor of even size
        moves as int32 words of two elements (each half has one owner,
        so no carry crosses it: the payload's own bytes); any other moves
        widened to int32. Gloo and NCCL both sum int32."""
        t = t.contiguous()
        self._note("all_reduce_owned", t)
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
            t.element_size()]
        pairs = ints == torch.int16 and t.numel() % 2 == 0
        bits = (t.reshape(-1).view(torch.int32).clone() if pairs
                else t.view(ints).to(torch.int32, copy=True))
        self._dist.all_reduce(bits, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        if pairs:
            return bits.view(t.dtype).view(t.shape)
        return bits.to(ints).view(t.dtype)

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along the last dim, in rank
        order."""
        t = t.contiguous()
        self._note("all_gather", t)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=-1)

    def broadcast_floats(self, vals: Sequence[float]) -> List[float]:
        """Rank 0's ``vals`` on every rank (f64 on the host)."""
        t = torch.tensor(list(vals), dtype=torch.float64)
        if self.group is not None and self._dist.get_backend(
                self.group) == "nccl":
            t = t.cuda()
        self._note("broadcast", t)
        self._dist.broadcast(t, src=0, group=self.group)
        return t.cpu().tolist()

    def broadcast_submissions(self, subs, n: int, n_tokens: int) -> list:
        """Rank 0's ``n`` new requests on every rank. ``subs`` (rank 0's;
        None on the others) holds, for each request, a dict of
        ``SUBMISSION_KEYS`` (``deadline_ms`` may be None) and its prompt,
        ``n_tokens`` tokens in all. They move as one f64 tensor, a row of
        the fields and the prompt's length a request and then every
        prompt's tokens (integers below 2^53 and the f64 host values are
        exact in it). Returns [(fields, prompt as int64 numpy)] in rank
        0's order."""
        width = len(SUBMISSION_KEYS) + 1
        if self.rank == 0:
            rows = [[float("nan") if f[k] is None else float(f[k])
                     for k in SUBMISSION_KEYS] + [len(p)] for f, p in subs]
            toks = [np.asarray(p, np.float64) for _, p in subs]
            flat = np.concatenate([np.asarray(rows, np.float64).reshape(-1)]
                                  + toks)
            t = torch.from_numpy(flat)
        else:
            t = torch.empty(n * width + n_tokens, dtype=torch.float64)
        if self.group is not None and self._dist.get_backend(
                self.group) == "nccl":
            t = t.cuda()
        self._note("broadcast", t)
        self._dist.broadcast(t, src=0, group=self.group)
        flat = t.cpu().numpy()
        rows = flat[:n * width].reshape(n, width)
        out, pos = [], n * width
        for row in rows:
            f = dict(zip(SUBMISSION_KEYS, row.tolist()))
            for k in _INT_KEYS:
                f[k] = int(f[k])
            if f["deadline_ms"] != f["deadline_ms"]:      # NaN: none
                f["deadline_ms"] = None
            k = int(row[-1])
            out.append((f, flat[pos:pos + k].astype(np.int64)))
            pos += k
        return out

    def embed_lookup(self, table: torch.Tensor, tokens: torch.Tensor,
                     vocab: int, d_model: int) -> torch.Tensor:
        """``full_table[tokens]`` from this rank's shard of the (vocab,
        d_model) table: a vocabulary shard (``vocab / size`` rows, this
        rank's in rank order) is looked up masked and summed exactly
        over the ranks; a d_model shard (the rules' fallback when the
        vocabulary does not divide) is gathered; a whole table is read
        as it is."""
        rows = table.shape[0]
        if rows == vocab:
            if table.shape[1] == d_model:
                return table[tokens]
            return self.all_gather_last(table[tokens])
        lo = self.rank * rows
        local = tokens.long() - lo
        mine = (local >= 0) & (local < rows)
        x = table[torch.clamp(local, 0, rows - 1)]
        x = torch.where(mine[..., None], x, torch.zeros_like(x))
        ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
        bits = x.contiguous().view(ints).to(torch.int32)
        self.all_reduce_sum(bits)
        return bits.to(ints).view(x.dtype)


# --------------------------------------------------------------------------
# The data axis: data-parallel training
# --------------------------------------------------------------------------

# f32 elements of one gradient bucket (256 MiB); a leaf larger than a
# bucket is synced alone
GRAD_BUCKET_ELEMS = 64 * 2 ** 20


class _SumLocalGrad(torch.autograd.Function):
    """The sum over the data group in the forward, the identity in the
    backward: each rank's loss holds the global statistic, and the
    gradient sync already sums the ranks' paths through it, so an
    all-reduce in the backward too would count it ``n`` times (what
    ``torch.distributed.nn.functional.all_reduce`` does)."""

    @staticmethod
    def forward(ctx, t, comm):
        out = t.detach().clone()
        comm.all_reduce_sum(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class DPComm:
    """One rank's collectives over the mesh's data axis (training): f32
    SUM all-reduces, in place, and the gradient sync. ``wire`` counts the
    bytes a rank receives by kind (``runtime.compression.wire_bytes``)."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self._dist = dist
        self.group = mesh.data_group
        self.size = int(mesh.shape["data"])
        self.rank = int(mesh.data_rank)
        self.wire: Counter = Counter()

    def __repr__(self) -> str:
        return f"DPComm(rank={self.rank}, size={self.size})"

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the elementwise f32 sum over the data ranks (every
        rank gets the same bits: a ring reduces each element once)."""
        if t.dtype != torch.float32:
            raise TypeError(f"the data axis sums f32, got {t.dtype}")
        self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        return t

    def sum_forward(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data ranks, with a local backward
        (:class:`_SumLocalGrad`)."""
        return _SumLocalGrad.apply(t, self)

    def sync_grads(self, grads: List[Optional[torch.Tensor]],
                   bucket_elems: int = GRAD_BUCKET_ELEMS
                   ) -> List[Optional[torch.Tensor]]:
        """Every gradient summed over the data ranks: the leaves in
        order, cast to f32 and packed into buckets of at most
        ``bucket_elems`` (a larger leaf alone), one SUM all-reduce a
        bucket, each leaf cast back to its type once. A None leaf (read
        by no op, on every rank alike) stays None."""
        from repro_torch.runtime.compression import wire_bytes
        out = list(grads)
        live = [i for i, g in enumerate(grads) if g is not None]
        self.wire["f32"] += wire_bytes([grads[i].numel() for i in live],
                                       self.size, "f32")
        pos = 0
        while pos < len(live):
            take, n = [], 0
            while pos < len(live) and (not take or n + grads[
                    live[pos]].numel() <= bucket_elems):
                take.append(live[pos])
                n += grads[live[pos]].numel()
                pos += 1
            buf = torch.cat([grads[i].reshape(-1).float() for i in take])
            self.all_reduce_sum(buf)
            off = 0
            for i in take:
                k = grads[i].numel()
                out[i] = buf[off:off + k].view(grads[i].shape).to(
                    grads[i].dtype)
                off += k
            del buf
        return out
