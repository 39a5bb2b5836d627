"""Per-architecture sharding rules on the ``("data", "model")`` mesh (the
JAX package's ``runtime/sharding.py``, rule for rule), and the helpers
that apply them to the port's trees.

A rule is a pure function of ``(cfg, mesh, path, shape)`` returning one
entry per dim of ``shape``: ``"model"``, the batch axes (a tuple), or
None. ``mesh`` needs only ``shape`` (a dict of axis sizes) and
``axis_names``. Paths are ``/``-joined: the reference's stacked
``segments/<i>/<j>/...`` leaves carry a leading layer axis that stays
unsharded; the port's per-layer ``layers/<n>/...`` leaves have none.

Parameter rules (a rule that does not divide its dim falls back to
replication, never to an error):

* column-parallel (output over "model"): wq/wk/wv, wg/wu, w1, w_in,
  w_gate, w_ig, w_rg, w_up, w_x, r_h, w_q/w_k/w_v (mLSTM)
* row-parallel (input over "model"): wo, wd, w2, w_out, w_down
* embeddings: vocab over "model" when divisible, else d_model
* MoE: expert-parallel (experts over "model") when n_experts divides the
  axis; tensor-parallel inside experts otherwise; router replicated
* per-channel quantizer scales follow their weight's output sharding;
  per-tensor scales, norms and the recurrence diagonal replicate
* w4a8 export planes (``<linear>/w4a8/{wq,s_w,b,wf}``) shard like the
  linear they shadow: column-parallel owners split ``wq`` on d_out and
  ``s_w``/``b``/``wf`` on the output channel; row-parallel owners split
  ``wq`` on the packed d_in/2 axis (a divisible packed axis cuts between
  nibble pairs) and ``wf`` on d_in, with ``s_w``/``b`` replicated
* anything under ``segments/`` gets a leading None for the scan axis

Serving rule (``serve_cache_spec``): only the quantized KV payload
shards, over "model" on the KV-head dim, so GQA groups stay local to a
rank; block tables, lengths, positions and the pool's block axis (the
host allocator's global block ids) replicate.

:func:`shard_params` is the port's ``jax.device_put(params,
param_shardings(...))``: it keeps this rank's slice of every leaf.
:func:`local_bytes` is one rank's share of a tree under its specs.
``param_spec`` stays the reference's pure rule, whose GSPMD reshards
what the port keeps head-local; both helpers depart from it in two
cases for serving (training's layout is below). Where ``tp`` is a multiple of ``n_kv_heads``
(:func:`kv_head_local`) they keep a whole KV head a rank instead of the
spec's slice of one. Where ``tp`` divides neither the query heads nor,
with a multiple of it, the KV heads (:func:`attn_replicated`), they keep
every attention linear whole (``wq`` / ``wk`` / ``wv`` / ``wo``, their
biases, scales and packed planes): every rank runs the whole attention,
as ``serve_cache_spec`` then keeps the whole pool on every rank. The
expert banks follow the rule: experts over "model" when ``tp`` divides
them (expert parallelism), else ``wg`` / ``wu`` column- and ``wd``
row-parallel inside every expert. The recurrent blocks follow the rule
(the RG-LRU's linears, ``conv_w``, ``conv_b`` and ``lam`` over its
width) but for three linears whose outputs are concatenated blocks
(:func:`recurrent_blocks`): the mLSTM's ``w_up`` (``[u | z]``) keeps
``u`` whole and this rank's heads of ``z``, its ``w_gates`` (``[input |
forget]``) this rank's heads of each, and the sLSTM's ``w_x`` and
``r_h`` stay whole (its recurrence runs whole on every rank). A
recurrent layer's serving state is this rank's slice (the RG-LRU's
channels, the mLSTM's heads) or whole (the sLSTM's), never resharded.

:func:`shard_batch` cuts this data rank's rows of a training batch by
:func:`batch_spec`.

Training at model > 1 (``shard_params(..., attn_mode=...)``,
:func:`shard_train_state`) takes the rules as they are, the optimizer's
moments following their parameters (the reference's ``opt_shardings``),
with one departure: under the ``seq`` attention mode the attention's
linears stay whole (:func:`train_whole_leaf`), where the reference's
GSPMD would reshard its activations around cut ones. ``kv_rep`` keeps
the rules' column cut of ``wk`` / ``wv`` even where it falls inside a KV
head (the model code gathers their outputs). :func:`gather_params` undoes
the cut (a checkpoint's whole tree), and :func:`partial_grad` names the
leaves whose gradient each rank holds a part of.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.bridge import flatten
from repro_torch.configs.base import BLOCK_MLSTM, BLOCK_SLSTM, ModelConfig

COL_PARALLEL = {"wq", "wk", "wv", "wg", "wu", "w1", "w_in", "w_gate",
                "w_ig", "w_rg", "w_up", "w_x", "r_h", "w_q", "w_k", "w_v"}
ROW_PARALLEL = {"wo", "wd", "w2", "w_out", "w_down"}
MOE_KEYS = {"wg", "wu", "wd"}

Spec = Tuple[Any, ...]


def _divides(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _size(mesh, axis) -> int:
    if isinstance(axis, str):
        return int(mesh.shape[axis])
    n = 1
    for a in axis:
        n *= int(mesh.shape[a])
    return n


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_entry(dp: Tuple[str, ...]):
    """A spec entry over the batch axes: one axis by its name (as a
    ``PartitionSpec`` normalizes a 1-tuple), several as the tuple."""
    return dp[0] if len(dp) == 1 else dp


def _maybe(axis: Optional[str], size: int, mesh):
    """Use the axis only if it divides the dim."""
    if axis is None:
        return None
    return axis if _divides(size, _size(mesh, axis)) else None


def _full(spec: tuple, ndim: int) -> Spec:
    """A spec shorter than the shape leaves its trailing dims unsharded."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def param_spec(cfg: ModelConfig, mesh, path: str,
               shape: Tuple[int, ...]) -> Spec:
    """Spec of one parameter leaf, one entry per dim."""
    shape = tuple(shape)
    return _full(_param_rule(cfg, mesh, path, shape), len(shape))


def _param_rule(cfg: ModelConfig, mesh, path: str,
                shape: Tuple[int, ...]) -> tuple:
    parts = path.split("/")
    key = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    in_scan = "segments" in parts
    is_moe = len(parts) >= 3 and "moe" in parts
    m = mesh.shape["model"]

    def lead(spec: tuple) -> tuple:
        # scan-stacked params carry a leading layer axis (replicated)
        if in_scan and len(spec) < len(shape):
            return (None,) * (len(shape) - len(spec)) + tuple(spec)
        return tuple(spec)

    # ---- w4a8 export planes (serve-time packed weights) -------------------
    # before the head branch: head/w4a8/wq has parts[-2] == "w4a8"
    if "w4a8" in parts:
        i = parts.index("w4a8")
        owner = parts[i - 1] if i else ""
        col = owner in COL_PARALLEL or owner == "head"
        row = owner in ROW_PARALLEL
        if key == "wq":                 # packed uint8 (d_out, d_in/2)
            if col:
                return lead((_maybe("model", shape[-2], mesh), None))
            if row:
                return lead((None, _maybe("model", shape[-1], mesh)))
            return lead((None, None))
        if key == "wf":                 # int8 ref plane (d_in, d_out)
            if col:
                return lead((None, _maybe("model", shape[-1], mesh)))
            if row:
                return lead((_maybe("model", shape[-2], mesh), None))
            return lead((None, None))
        if key == "s_w":                # (1, d_out): follows output sharding
            if col:
                return lead((None, _maybe("model", shape[-1], mesh)))
            return lead((None, None))
        if key == "b":
            return lead((_maybe("model", shape[-1], mesh),) if col
                        else (None,))
        return lead(())

    # ---- embeddings / head ------------------------------------------------
    if path.endswith("embed/w"):        # (V, d) or (maxpos, d)
        if parts[-2] == "embed" and _divides(shape[0], m) \
                and "pos_embed" not in path:
            return ("model", None)
        return (None, _maybe("model", shape[-1], mesh))
    if parts[0] == "head" or parent == "head":
        if key in ("w", "s_w"):         # (d, V) / (1, V)
            return (None, _maybe("model", shape[-1], mesh))
        return ()

    # ---- MoE expert tensors ------------------------------------------------
    if is_moe and parent in MOE_KEYS and key in ("w", "s_w"):
        e = shape[1] if in_scan else shape[0]
        base = len(shape) - 3           # dims before (E, din, dout)
        if _divides(e, m):              # expert parallelism
            return (None,) * base + ("model", None, None)
        if parent in ("wg", "wu"):      # TP inside experts, column
            return (None,) * base + (None, None, "model")
        return (None,) * base + ((None, "model", None) if key == "w"
                                 else (None, None, None))

    # ---- quantizer scales ----------------------------------------------------
    if key == "s_w":                    # (1, dout) [+ scan lead]
        if parent in COL_PARALLEL and _divides(shape[-1], m):
            return lead((None, "model"))
        return lead((None, None))
    if key.startswith("s_"):            # per-tensor scalars
        return lead(())

    # ---- linears ------------------------------------------------------------
    if key == "w" and parent in COL_PARALLEL:
        return lead((None, _maybe("model", shape[-1], mesh)))
    if key == "w" and parent in ROW_PARALLEL:
        return lead((_maybe("model", shape[-2], mesh), None))
    if key == "b":
        if parent in COL_PARALLEL:
            return lead((_maybe("model", shape[-1], mesh),))
        return lead((None,))

    # ---- recurrent diagonals / conv ---------------------------------------
    if key in ("lam", "conv_b"):
        return lead((_maybe("model", shape[-1], mesh),))
    if key == "conv_w":
        return lead((None, _maybe("model", shape[-1], mesh)))

    # ---- norms, router, gates, everything else: replicated -----------------
    return lead(())


def batch_spec(mesh, shape: Tuple[int, ...], name: str) -> Spec:
    """Spec of one batch leaf: the batch over the batch axes, else the
    sequence over "data" (long-context sequence parallelism)."""
    shape = tuple(shape)
    dp = batch_axes(mesh)
    dp_size = _size(mesh, dp)
    if name == "positions":             # (3, B, S)
        if len(shape) >= 2 and _divides(shape[1], dp_size):
            return _full((None, _dp_entry(dp)), len(shape))
        return _full((), len(shape))
    if not shape:
        return ()
    if _divides(shape[0], dp_size):
        return _full((_dp_entry(dp),), len(shape))
    if len(shape) >= 2 and _divides(shape[1], mesh.shape["data"]):
        return _full((None, "data"), len(shape))
    return _full((), len(shape))


def cache_spec(cfg: ModelConfig, mesh, path: str,
               shape: Tuple[int, ...]) -> Spec:
    """Training-cache leaf spec. Attention caches (rep, B, Hkv, S, D):
    batch over DP when divisible, else sequence over "data"; KV heads
    over "model" when divisible, else the sequence, else head_dim.
    Recurrent states: width or heads over "model"."""
    shape = tuple(shape)
    key = path.split("/")[-1]
    dp = batch_axes(mesh)
    dp_size = _size(mesh, dp)
    m = mesh.shape["model"]
    if key in ("length", "position"):
        return _full((), len(shape))
    base = 1 if "segments" in path else 0   # leading scan axis replicated
    dims: list = [None] * len(shape)
    if len(shape) > base and _divides(shape[base], dp_size):
        dims[base] = _dp_entry(dp)
        seq_sharded = False
    else:
        seq_sharded = True
    if key in ("k_q", "v_q"):           # (..., B, Hkv, S, D)
        hkv, S, D = shape[-3], shape[-2], shape[-1]
        if _divides(hkv, m):
            dims[-3] = "model"
        elif _divides(S, m):
            dims[-2] = "model"
        elif _divides(D, m):
            dims[-1] = "model"
        if seq_sharded and dims[-2] is None \
                and _divides(S, mesh.shape["data"]):
            dims[-2] = "data"
    elif key in ("s_k", "s_v"):         # (..., B, Hkv, S)
        hkv, S = shape[-2], shape[-1]
        if _divides(hkv, m):
            dims[-2] = "model"
        elif _divides(S, m):
            dims[-1] = "model"
        elif seq_sharded and _divides(S, mesh.shape["data"]):
            dims[-1] = "data"
    elif key in ("state_q", "conv_buf", "c"):
        if _divides(shape[-1], m):
            dims[-1] = "model"
        elif len(shape) >= 3 and _divides(shape[-3], m):
            dims[-3] = "model"
    return tuple(dims)


def serve_cache_spec(cfg: ModelConfig, mesh, path: str,
                     shape: Tuple[int, ...]) -> Spec:
    """Serve-cache leaf spec (paged pool or dense per-slot cache): the
    KV-head dim over "model" when divisible, nothing else; the leading
    pool axis (global block ids) never shards."""
    shape = tuple(shape)
    key = path.split("/")[-1]
    m = mesh.shape["model"]
    dims: list = [None] * len(shape)
    if key in ("k_q", "v_q") and len(shape) >= 4:   # (..., NB|B, Hkv, S, D)
        if _divides(shape[-3], m):
            dims[-3] = "model"
    elif key in ("s_k", "s_v") and len(shape) >= 3:  # (..., NB|B, Hkv, S)
        if _divides(shape[-2], m):
            dims[-2] = "model"
    return tuple(dims)


# --------------------------------------------------------------------------
# Applying the rules to the port's trees
# --------------------------------------------------------------------------

def _slice(t: torch.Tensor, spec: Spec, tp: int, rank: int) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax == "model":
            n = t.shape[dim] // tp
            t = t.narrow(dim, rank * n, n)
    return t


def _local_numel(shape, spec: Spec, tp: int) -> int:
    n = 1
    for d, ax in zip(shape, spec):
        n *= d // tp if ax == "model" else d
    return n


def kv_head_local(cfg: ModelConfig, tp: int) -> bool:
    """Whether ``tp`` ranks hold whole KV heads rather than slices of
    them: fewer KV heads than ranks, ``tp`` a multiple of
    ``n_kv_heads`` and ``n_heads`` divisible by ``tp``. Rank ``r`` then
    keeps query heads ``[r Hq/tp, (r+1) Hq/tp)``, which all read KV
    head ``r // (tp / Hkv)``, and keeps that whole KV head: every KV head
    lives on ``tp / Hkv`` ranks."""
    hkv = cfg.n_kv_heads
    return (0 < hkv < tp and tp % hkv == 0 and cfg.n_heads % tp == 0)


def attn_replicated(cfg: ModelConfig, tp: int) -> bool:
    """Whether every rank keeps and runs the whole attention: ``tp`` > 1
    divides neither ``n_heads`` nor, as a divisor or through
    :func:`kv_head_local`, the KV heads (e.g. qwen2-7b's 28 query heads
    at tp=8). The reference's rules replicate those projections too
    (``_maybe``) and its GSPMD reshards the activations around them; the
    port computes every head on every rank and reduces nothing at
    ``wo``, so K, V and the attention output are bitwise tp=1's."""
    if tp <= 1:
        return False
    return (cfg.n_heads % tp != 0
            or (cfg.n_kv_heads % tp != 0 and not kv_head_local(cfg, tp)))


ATTN_LINEARS = ("wq", "wk", "wv", "wo")


def _attn_leaf(path: str) -> bool:
    """Whether ``path`` is a leaf of an attention linear (its weight,
    bias, scales or packed planes): ``.../attn/<wq|wk|wv|wo>/...``."""
    parts = path.split("/")
    return any(a == "attn" and b in ATTN_LINEARS
               for a, b in zip(parts, parts[1:]))


def bank_leaf(path: str) -> bool:
    """Whether ``path`` is an expert bank's weight or scale
    (``.../moe/<wg|wu|wd>/<w|s_w>``), the leaves the MoE rule above
    cuts over the experts or inside them."""
    parts = path.split("/")
    return (len(parts) >= 3 and parts[-3] == "moe"
            and parts[-2] in MOE_KEYS and parts[-1] in ("w", "s_w"))


# recurrent linears whose output is a concatenation of equal blocks, by
# (layer kind, linear): for each block, True keeps it whole on every
# rank, False keeps this rank's part of it in rank order
_RECURRENT_BLOCKS = {(BLOCK_MLSTM, "w_up"): (True, False),      # [u | z]
                     (BLOCK_MLSTM, "w_gates"): (False, False),  # [i | f]
                     (BLOCK_SLSTM, "w_x"): (True,),
                     (BLOCK_SLSTM, "r_h"): (True,)}


def _layer_kind(cfg: ModelConfig, parts) -> Optional[str]:
    if len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit():
        return cfg.layer_kinds()[int(parts[1])]
    return None


def recurrent_blocks(cfg: ModelConfig, path: str, shape: Tuple[int, ...]
                     ) -> Optional[Tuple[int, Tuple[bool, ...]]]:
    """(output dim, blocks) of a leaf of a recurrent linear whose
    per-rank layout departs from :func:`param_spec`'s contiguous cut:
    the mLSTM's ``w_up`` (its ``u`` block whole, ``z`` cut by heads) and
    ``w_gates`` (both gate blocks cut by heads), the sLSTM's ``w_x`` and
    ``r_h`` (whole). The output dim is the columns of ``w``, ``b`` and
    ``s_w`` and of the packed planes' ``s_w`` and ``b``, the rows of the
    packed ``wq`` (d_out, d_in / 2). None for any other leaf (``s_in``
    among them)."""
    parts = path.split("/")
    if "w4a8" in parts:
        i = parts.index("w4a8")
        owner, key = (parts[i - 1] if i else ""), parts[-1]
        dim = -2 if key == "wq" else -1
    else:
        owner, key = (parts[-2] if len(parts) >= 2 else ""), parts[-1]
        dim = -1
    blocks = _RECURRENT_BLOCKS.get((_layer_kind(cfg, parts), owner))
    if blocks is None or key not in ("w", "b", "s_w", "wq") \
            or len(shape) < -dim:
        return None
    return len(shape) + dim, blocks


def _cut_blocks(t: torch.Tensor, dim: int, blocks: Tuple[bool, ...],
                tp: int, rank: int) -> torch.Tensor:
    """``t``'s dim ``dim`` as ``len(blocks)`` equal blocks, each kept
    whole (True) or cut to this rank's part (False), concatenated."""
    n = t.shape[dim] // len(blocks)
    parts = [t.narrow(dim, b * n, n) if whole else
             t.narrow(dim, b * n + rank * (n // tp), n // tp)
             for b, whole in enumerate(blocks)]
    return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]


def _blocks_numel(shape, dim: int, blocks: Tuple[bool, ...],
                  tp: int) -> int:
    n = shape[dim] // len(blocks)
    kept = sum(n if whole else n // tp for whole in blocks)
    total = 1
    for d in shape:
        total *= d
    return total // shape[dim] * kept


def _kv_head_dim(cfg: ModelConfig, path: str,
                 shape: Tuple[int, ...]) -> Optional[int]:
    """The KV-head (output-channel) dim of a ``wk`` / ``wv`` leaf: the
    columns of ``w``, ``b``, ``s_w`` and the packed planes' ``s_w``,
    ``b`` and ``wf``, the rows of the packed ``wq`` (d_out, d_in / 2);
    None for any other leaf (``s_in`` among them)."""
    parts = path.split("/")
    if "w4a8" in parts:
        i = parts.index("w4a8")
        owner, key = (parts[i - 1] if i else ""), parts[-1]
        dim = -2 if key == "wq" else -1
    else:
        owner, key = (parts[-2] if len(parts) >= 2 else ""), parts[-1]
        dim = -1
    if owner not in ("wk", "wv") or key not in ("w", "b", "s_w", "wq",
                                                "wf"):
        return None
    if len(shape) < -dim or shape[dim] != cfg.kv_dim:
        return None
    return len(shape) + dim


def shard_params(params, cfg: ModelConfig, mesh,
                 attn_mode: Optional[str] = None):
    """This rank's slice of every leaf of ``params`` (a new tree; each
    sharded leaf a contiguous copy, so the full leaves can be freed).
    Dims a spec maps to "model" are cut into ``mesh.shape["model"]``
    equal parts in rank order; batch axes are not cut (a serving mesh
    has one data replica). Runs after ``attach_w4a8_exports``, so the
    packed planes are cut by their owner's rule.

    Where the ranks hold whole KV heads (:func:`kv_head_local`), the
    ``wk`` / ``wv`` leaves are not cut by their spec (which would split
    a head): each rank keeps its KV head's columns (and the packed
    planes' rows of it) whole. Every output column of a column-parallel
    linear depends only on the shared input and its own weights, and the
    K/V scales are per token and head, so this rank's K and V are bitwise
    the same columns of tp=1's. Where every rank runs the whole attention
    (:func:`attn_replicated`), its linears' leaves are kept whole. The
    recurrent linears of :func:`recurrent_blocks` keep their blocks whole
    or cut by heads.

    ``attn_mode`` (a string) asks for the training layout of that
    attention mode instead (:func:`train_whole_leaf`): the rules as they
    are, but for ``seq``, whose attention linears stay whole. A training
    tree's every part takes it: the student, the teacher and the
    optimizer's ``m`` / ``v`` (:func:`shard_train_state`), as the
    reference's ``opt_shardings`` follow the parameters."""
    tp, rank = int(mesh.shape["model"]), int(mesh.rank)
    train = attn_mode is not None
    local_kv = kv_head_local(cfg, tp) and not train
    whole_attn = (attn_mode == "seq") if train else attn_replicated(cfg, tp)
    hd = cfg.resolved_head_dim
    kv_head = rank // (tp // cfg.n_kv_heads) if local_kv else 0

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        if not isinstance(tree, torch.Tensor) or tp == 1:
            return tree
        path, shape = prefix[:-1], tuple(tree.shape)
        if whole_attn and _attn_leaf(path):
            return tree
        rec = recurrent_blocks(cfg, path, shape)
        if rec is not None:
            if all(rec[1]):
                return tree
            return _cut_blocks(tree, rec[0], rec[1], tp, rank
                               ).contiguous().clone()
        if local_kv:
            dim = _kv_head_dim(cfg, path, shape)
            if dim is not None:
                return tree.narrow(dim, kv_head * hd, hd).contiguous(
                    ).clone()
        spec = param_spec(cfg, mesh, path, shape)
        if "model" not in spec:
            return tree
        return _slice(tree, spec, tp, rank).contiguous().clone()

    return walk(params, "")


# --------------------------------------------------------------------------
# The training layout (tensor-parallel QAT at model > 1)
# --------------------------------------------------------------------------

TRAIN_MODES = ("", "kv_rep", "seq")


def train_whole_leaf(path: str, attn_mode: str) -> bool:
    """Whether the training layout keeps ``path`` whole where the rules
    would cut it: under ``seq`` every rank runs the attention's linears
    whole on its query rows (the reference's GSPMD instead reshards the
    activations around cut linears; the port departs here, as
    :func:`attn_replicated` does for serving)."""
    return attn_mode == "seq" and _attn_leaf(path)


def cut_dims(params, cfg: ModelConfig, mesh,
             attn_mode: str) -> Dict[str, Optional[int]]:
    """{path: the dim :func:`shard_params` cuts over "model" in the
    training layout of ``attn_mode``, or None for a whole leaf}, from the
    whole tree ``params`` (what :func:`gather_params` undoes)."""
    out = {}
    for path, t in flatten(params):
        if not isinstance(t, torch.Tensor):
            continue
        spec = param_spec(cfg, mesh, path, tuple(t.shape))
        dim = spec.index("model") if "model" in spec else None
        out[path] = None if train_whole_leaf(path, attn_mode) else dim
    return out


def gather_params(tree, dims: Dict[str, Optional[int]], comm):
    """The whole tree from this rank's shards: each cut leaf all-gathered
    over the model ranks (``comm``, a ``TPComm``) along its dim of
    ``dims`` (:func:`cut_dims`), in rank order; a whole leaf as it is.
    Bitwise the tree :func:`shard_params` cut. Collective: every model
    rank calls it."""
    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{prefix}{i}/") for i, v in enumerate(t))
        dim = dims.get(prefix[:-1]) if isinstance(t, torch.Tensor) else None
        if dim is None:
            return t
        return comm.all_gather_dim(t.detach(), dim)
    return walk(tree, "")


def shard_train_state(student, opt, cfg: ModelConfig, mesh,
                      attn_mode: str):
    """(this rank's student, its optimizer state): the AdamW moments cut
    as their parameters (``step`` whole)."""
    return (shard_params(student, cfg, mesh, attn_mode),
            type(opt)(opt.step, shard_params(opt.m, cfg, mesh, attn_mode),
                      shard_params(opt.v, cfg, mesh, attn_mode)))


def gather_train_state(student, opt, dims, comm):
    """:func:`shard_train_state` undone (a checkpoint's whole tree)."""
    return (gather_params(student, dims, comm),
            type(opt)(opt.step, gather_params(opt.m, dims, comm),
                      gather_params(opt.v, dims, comm)))


# per-leaf keys a rank reads on its part only in every training mode
_PARTIAL_KEYS = {"s_in", "s_q", "s_k", "s_v"}


def partial_grad(path: str, attn_mode: str) -> bool:
    """Whether a training rank's gradient of ``path`` is its part of a
    sum over the model ranks (summed after the backward,
    ``TPComm.sum_grads``): a leaf whole on every rank that each rank
    reads on its part of a tensor only.

    * every per-tensor activation scale (``s_in``: a column-parallel
      linear's input is quantized whole but only this rank's columns
      take its gradient, a row-parallel one's is a slice; ``s_q``,
      ``s_k``, ``s_v``: this rank's heads or query rows, or the whole K
      / V read for this rank's heads);
    * the per-channel ``s_w`` of the row-parallel ``wo`` and ``wd`` (this
      rank's rows of each channel);
    * ``q_norm`` / ``k_norm`` (qwen3's per-head norms, on this rank's
      heads, or the whole K read for them);
    * under ``seq`` every attention leaf (whole, read on this rank's
      query rows)."""
    parts = path.split("/")
    key = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if key in _PARTIAL_KEYS:
        return True
    if key == "s_w" and parent in ("wo", "wd"):
        return True
    if parent in ("q_norm", "k_norm"):
        return True
    return train_whole_leaf(path, attn_mode)


def local_bytes(tree, specs: Dict[str, Spec], tp: int,
                cfg: Optional[ModelConfig] = None) -> int:
    """One rank's bytes of ``tree`` (the full, unsharded leaves) under
    ``specs`` ({path: spec}; a leaf without one is replicated): a
    sharded leaf counts its shard, a replicated leaf its whole size. The
    port's ``_device_local_bytes``. With ``cfg``, where the ranks hold
    whole KV heads (:func:`kv_head_local`), a ``wk`` / ``wv`` leaf
    counts one KV head, and where they run the whole attention
    (:func:`attn_replicated`) an attention linear's leaf counts whole,
    and a leaf of :func:`recurrent_blocks` counts its kept blocks, as
    :func:`shard_params` keeps them."""
    local_kv = cfg is not None and kv_head_local(cfg, tp)
    whole_attn = cfg is not None and attn_replicated(cfg, tp)
    total = 0
    for path, t in flatten(tree):
        if isinstance(t, torch.Tensor):
            dim = (_kv_head_dim(cfg, path, tuple(t.shape)) if local_kv
                   else None)
            rec = (recurrent_blocks(cfg, path, tuple(t.shape))
                   if cfg is not None else None)
            if whole_attn and _attn_leaf(path):
                n = t.numel()
            elif rec is not None:
                n = _blocks_numel(tuple(t.shape), rec[0], rec[1], tp)
            elif dim is not None:
                n = t.numel() // t.shape[dim] * cfg.resolved_head_dim
            else:
                n = _local_numel(t.shape, _full(specs.get(path, ()),
                                                t.dim()), tp)
            total += n * t.element_size()
    return total


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This data rank's rows of every leaf of a global ``batch`` (numpy
    arrays or tensors), cut by :func:`batch_spec`: the batch dim (dim 1
    of ``positions``) in ``mesh.shape["data"]`` equal parts in data-rank
    order (``mesh.data_rank``); every model rank of a data replica gets
    the same rows (the model code reads them whole). Scalars are kept
    whole. A batch the data
    axis does not divide gets the reference's sequence-over-"data" spec,
    which needs context-parallel attention: that raises
    NotImplementedError (ROADMAP Queue 1 item 2b)."""
    n = int(mesh.shape["data"])
    if n == 1:
        return dict(batch)
    rank = int(mesh.data_rank)
    out = {}
    for name, v in batch.items():
        shape = tuple(v.shape)
        spec = batch_spec(mesh, shape, name)
        dims = [i for i, ax in enumerate(spec) if ax is not None]
        if not shape:
            out[name] = v
            continue
        if not dims or spec[dims[0]] != _dp_entry(batch_axes(mesh)) \
                or dims[0] != (1 if name == "positions" else 0):
            raise NotImplementedError(
                f"batch leaf {name!r} of shape {shape} does not split its "
                f"batch over {n} data ranks (spec {spec}): the sequence "
                "over 'data' needs context-parallel attention, which is "
                "not ported (ROADMAP Queue 1 item 2b)")
        d = dims[0]
        rows = shape[d] // n
        idx = (slice(None),) * d + (slice(rank * rows, (rank + 1) * rows),)
        out[name] = v[idx]
    return out
