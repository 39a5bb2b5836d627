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

Tensor-parallel training (``launch.steps.make_train_step`` at model >
1) adds the autograd-aware model-axis collectives, each a
``torch.autograd.Function``:

* ``copy_in``: the identity forward and an f32 SUM of dx, rounded once,
  backward, at the input every column-parallel linear of a block shares
  (Megatron's f);
* ``reduce_out``: an f32 SUM of a row-parallel linear's partials, rounded
  once, forward, and the identity backward (Megatron's g);
* ``gather_last``: the all-gather of a column-parallel output, backward
  this rank's slice (``grad="slice"``: the head's logits, whose loss every
  rank computes whole) or the SUM over the ranks then the slice
  (``grad="sum"``: ``kv_rep``'s K/V, which each rank reads only for its
  own query heads);
* ``gather_seq``: the all-gather of this rank's query rows along the
  sequence (``seq`` attention's output), backward the rank's rows;
* ``embed_lookup`` under autograd: its backward writes this rank's rows
  of the vocabulary shard only;
* ``sum_grads``: the gradients a rank holds partially (``runtime.
  sharding.partial_grads``) summed over the model ranks in f32 buckets.

Every call counts one in :attr:`TPComm.census` by kind, and its bytes in
:attr:`TPComm.bytes` (the tensor handed over, per rank): a decode step of
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

import time
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
        self.bytes: Counter = Counter()
        self.watch: Optional[set] = None
        # host ms spent in the collectives while ``timed`` (the device
        # synchronised before and after each, so a CUDA rank's pending
        # kernels are not counted): a training step's TP phase
        self.timed = False
        self.ms = 0.0

    def __repr__(self) -> str:
        return f"TPComm(rank={self.rank}, size={self.size})"

    def _note(self, kind: str, t: torch.Tensor) -> None:
        self.census[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()
        if self.watch is not None:
            self.watch.add(t.untyped_storage().data_ptr())

    def _call(self, fn, t: torch.Tensor, *args, **kw):
        if not self.timed:
            return fn(t, *args, **kw)
        dev = t[0].device if isinstance(t, list) else t.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(t, *args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.ms += 1e3 * (time.perf_counter() - t0)
        return out

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
        self._call(self._dist.all_reduce, t, op=self._dist.ReduceOp.MAX,
                              group=self.group)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the elementwise sum over the ranks (int32, exact)."""
        if t.dtype != torch.int32:
            raise TypeError(f"all_reduce_sum takes int32 (an exact sum), "
                            f"got {t.dtype}")
        self._note("all_reduce_sum", t)
        self._call(self._dist.all_reduce, t, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        return t

    def all_reduce_sum_f32(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the elementwise f32 sum over the ranks (rounded: the
        partials of a split the int32 path cannot take)."""
        if t.dtype != torch.float32:
            raise TypeError(f"all_reduce_sum_f32 takes f32, got {t.dtype}")
        self._note("all_reduce_sum_f32", t)
        self._call(self._dist.all_reduce, t, op=self._dist.ReduceOp.SUM,
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
        self._call(self._dist.all_reduce, bits, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        if pairs:
            return bits.view(t.dtype).view(t.shape)
        return bits.to(ints).view(t.dtype)

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along the last dim, in rank
        order."""
        return self.all_gather_dim(t, -1)

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
        as it is. Under autograd a vocabulary shard's backward adds the
        rows' gradient (the whole one on every rank) into this rank's
        rows only (:class:`_EmbedShard`)."""
        rows = table.shape[0]
        if rows == vocab:
            if table.shape[1] == d_model:
                return table[tokens]
            return self.all_gather_last(table[tokens])
        if torch.is_grad_enabled() and table.requires_grad:
            return _EmbedShard.apply(table, tokens, self)
        return self._embed_shard(table, tokens)

    def _embed_shard(self, table: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
        rows = table.shape[0]
        lo = self.rank * rows
        local = tokens.long() - lo
        mine = (local >= 0) & (local < rows)
        x = table[torch.clamp(local, 0, rows - 1)]
        x = torch.where(mine[..., None], x, torch.zeros_like(x))
        ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
        bits = x.contiguous().view(ints).to(torch.int32)
        self.all_reduce_sum(bits)
        return bits.to(ints).view(x.dtype)

    # ---- tensor-parallel training: the autograd-aware collectives --------

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (replicated) as the input of this rank's column-parallel
        linears: the identity, whose backward sums the ranks' partial
        input gradients (f32, rounded once to x's type)."""
        return _CopyIn.apply(x, self)

    def reduce_out(self, part: torch.Tensor, dtype) -> torch.Tensor:
        """The f32 partials ``part`` of a row-parallel linear summed over
        the ranks and rounded once to ``dtype``; the backward hands the
        output's gradient (the same on every rank) to each partial."""
        if part.dtype != torch.float32:
            raise TypeError(f"reduce_out sums f32 partials, got {part.dtype}")
        return _ReduceOut.apply(part, self, dtype)

    def gather_last(self, t: torch.Tensor, grad: str = "slice"
                    ) -> torch.Tensor:
        """:meth:`all_gather_last` under autograd. ``grad="slice"``: the
        gathered tensor's gradient is the same on every rank (a loss
        every rank computes whole), so this rank's columns of it;
        ``grad="sum"``: each rank's is partial (``kv_rep``'s K/V, read
        for this rank's query heads), so the ranks' are summed (f32,
        rounded once) before the slice."""
        if grad not in ("slice", "sum"):
            raise ValueError(f"grad is 'slice' or 'sum', got {grad!r}")
        return _GatherLast.apply(t, self, grad == "sum")

    def gather_seq(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` (B, S / size, ...) along dim 1, in
        rank order (``seq`` attention's output); the backward keeps this
        rank's rows of the gradient, the same on every rank."""
        return _GatherSeq.apply(t, self)

    def all_gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order
        (outside autograd)."""
        t = t.contiguous()
        self._note("all_gather", t)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._call(self._dist.all_gather, parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def sum_grads(self, grads: List[Optional[torch.Tensor]],
                  bucket_elems: int = None) -> List[Optional[torch.Tensor]]:
        """Each gradient summed over the model ranks in f32 buckets (one
        SUM all-reduce a bucket, each leaf rounded to its type once): the
        leaves a rank holds partially. None stays None."""
        return _sum_buckets(grads, self.all_reduce_sum_f32,
                            bucket_elems or GRAD_BUCKET_ELEMS)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = g.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
        ctx.comm.all_reduce_sum_f32(s)
        return s.to(g.dtype), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, comm, dtype):
        out = part.detach().contiguous().clone()
        comm.all_reduce_sum_f32(out)
        return out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.float(), None, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, summed):
        ctx.comm, ctx.summed, ctx.n = comm, summed, t.shape[-1]
        return comm.all_gather_last(t.detach())

    @staticmethod
    def backward(ctx, g):
        comm, n = ctx.comm, ctx.n
        if ctx.summed:
            s = g.to(torch.float32, memory_format=torch.contiguous_format,
                     copy=True)
            comm.all_reduce_sum_f32(s)
            g = s.to(g.dtype)
        return g[..., comm.rank * n:(comm.rank + 1) * n].contiguous(), \
            None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm, ctx.n = comm, t.shape[1]
        return comm.all_gather_dim(t.detach(), 1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.comm.rank, ctx.n
        return g[:, r * n:(r + 1) * n].contiguous(), None


class _EmbedShard(torch.autograd.Function):
    """The vocabulary-sharded lookup; its backward adds each token's row
    gradient into this rank's row of it, where the rank owns the token
    (the ranks' shards together take the whole table's gradient once)."""

    @staticmethod
    def forward(ctx, table, tokens, comm):
        ctx.save_for_backward(tokens)
        ctx.comm, ctx.shape = comm, table.shape
        return comm._embed_shard(table.detach(), tokens)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        rows = ctx.shape[0]
        local = tokens.long() - ctx.comm.rank * rows
        mine = (local >= 0) & (local < rows)
        dw = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        dw.index_put_((local[mine],), g[mine], accumulate=True)
        return dw, None, None


def _sum_buckets(grads, reduce, bucket_elems):
    """``grads`` cast to f32, packed into buckets of at most
    ``bucket_elems`` (a larger leaf alone), ``reduce`` (an in-place SUM
    all-reduce) on each, each leaf cast back to its type once."""
    out = list(grads)
    live = [i for i, g in enumerate(grads) if g is not None]
    pos = 0
    while pos < len(live):
        take, n = [], 0
        while pos < len(live) and (not take or n + grads[
                live[pos]].numel() <= bucket_elems):
            take.append(live[pos])
            n += grads[live[pos]].numel()
            pos += 1
        buf = torch.cat([grads[i].reshape(-1).float() for i in take])
        reduce(buf)
        off = 0
        for i in take:
            k = grads[i].numel()
            out[i] = buf[off:off + k].view(grads[i].shape).to(
                grads[i].dtype)
            off += k
        del buf
    return out


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
        self.wire["f32"] += wire_bytes(
            [g.numel() for g in grads if g is not None], self.size, "f32")
        return _sum_buckets(grads, self.all_reduce_sum, bucket_elems)
