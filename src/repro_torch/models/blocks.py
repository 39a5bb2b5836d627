"""Transformer blocks: attention (causal self-, bidirectional and
cross-attention) with a quantized KV cache, the SwiGLU and GELU MLPs and
the GShard-style top-k MoE, with SiLQ quantization sites (paper Fig. 2):

* every linear: input A-bits (``s_in``), weight W-bits per-out-channel (``s_w``)
* query into QK^T: 16-bit (``s_q``)
* K/V written to cache: C-bits (``s_k``/``s_v``)
* MoE router: 8-bit weight and activation; expert banks ``(e, d_in,
  d_out)`` per output channel of each expert (``s_w`` ``(e, 1, d_out)``)

Caches are updated in place: the engine owns one cache per layer for its
whole life, and a decode step writes its new K/V row into it.

Tensor-parallel serving runs these functions unchanged on one rank's
heads: the engine hands them a config with ``n_heads / tp`` query and
``n_kv_heads / tp`` KV heads (head-major halves, so each GQA group stays
on one rank and the group size is unchanged; one whole KV head a rank
where ``tp`` is a multiple of ``n_kv_heads``), the rank's column slices
of wq/wk/wv/wg/wu and row slices of wo/wd, and caches of its KV heads.
The row-parallel linears (``qlinear(..., row=True)``) reduce over the
ranks through ``ctx.tp``. Where ``tp`` does not divide the heads the
engine hands them every head and whole attention linears
(``ctx.attn_whole``: ``wo`` reduces nothing); a dense MLP whose ``d_ff``
``tp`` does not divide is kept whole and reduces nothing either. An MoE
layer holds ``n_experts / tp`` experts a rank (expert parallelism) or
every expert's ``d_ff / tp`` slice (TP inside experts):
:func:`moe_fwd`.

Tensor-parallel training (``ctx.attn_mode``, model > 1) runs them on
the global config instead: :func:`attn_fwd` cuts the attention by the
reference's mode (:func:`_attn_fwd_tp`: heads, ``kv_rep``'s gathered
K/V, ``seq``'s query rows), :func:`mlp_fwd` copies its input in before
the column-parallel ``wg`` / ``wu`` and ``wd`` sums its f32 partials.

Two cache layouts: the dense ring (``init_attn_cache``, one stripe of
``cache_len`` rows per slot, or of ``min(cache_len, window)`` rows for a
sliding-window layer, whose ring eviction enforces the window) and the paged pool (``init_paged_attn_cache``,
blocks of ``page_size`` tokens shared by every slot through a block table).
A paged layer's pool leaves are views of layer-stacked tensors with one
block more than the pool holds: the last block is the write sink for
sentinel destinations (``kernels/kvq_attn/ref.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qat import (QuantCtx, cache_quantize, init_linear,
                                  qlinear, quantize_act, quantize_weight_p,
                                  subcol, train_tp)
from repro_torch.core.quantizer import quantize_by_amax, quantize_to_int
from repro_torch.kernels.kvq_attn.ref import gather_paged_kv, pool_blocks
from repro_torch.models.common import (_gelu, _tanh, apply_rope,
                                       blockwise_attention,
                                       decode_attention_intcache,
                                       head_rms_norm, rope_tables)
from repro_torch.models.recurrent import _exp

MOE_CAPACITY_FACTOR = 1.25
MOE_CHUNK_S = 1024      # sequence chunk bounding the dispatch working set

POOL_KEYS = ("k_q", "v_q", "s_k", "s_v")     # pool-shaped paged leaves
_NEG = -1e30


def _decode_attn(ctx: QuantCtx, q, k_q, v_q, s_k, s_v, lengths) -> torch.Tensor:
    """Decode attention over the int cache for a full slot batch.

    CUDA tensors go through the hand-written split-KV decode kernel (int8
    rows dequantized on chip, a CTA per 64-token split of a slot and KV
    head, the paged kernel's code with the table taken away); CPU
    tensors, and every tensor under ``kernel_backend="ref"``, through the
    plain path. Both take the same batched (B, ...) operands.
    """
    if q.is_cuda and ctx.kernel_backend != "ref":
        from repro_torch.kernels.kvq_attn.ops import kvq_decode_attn
        return kvq_decode_attn(q, k_q, v_q, s_k, s_v, lengths)
    return decode_attention_intcache(q, k_q, v_q, s_k, s_v, lengths)


def _decode_attn_paged(ctx: QuantCtx, q, k_pool, v_pool, s_k, s_v,
                       block_tbl, lengths) -> torch.Tensor:
    """Decode attention through a block table over the global pool.

    CUDA tensors go through the hand-written paged kernel, which walks
    each slot's table itself; CPU tensors, and every tensor under
    ``kernel_backend="ref"``, gather the slot's blocks into a contiguous
    view and take the dense plain path, so dense and paged decode agree
    bitwise there, as in the reference.
    """
    if q.is_cuda and ctx.kernel_backend != "ref":
        from repro_torch.kernels.kvq_attn.ops import kvq_paged_decode_attn
        return kvq_paged_decode_attn(q, k_pool, v_pool, s_k, s_v,
                                     block_tbl, lengths)
    return decode_attention_intcache(
        q, gather_paged_kv(k_pool, block_tbl),
        gather_paged_kv(v_pool, block_tbl), gather_paged_kv(s_k, block_tbl),
        gather_paged_kv(s_v, block_tbl), lengths)


def _spec_verify_attn(ctx: QuantCtx, q, k_pool, v_pool, s_k, s_v,
                      block_tbl, lengths) -> torch.Tensor:
    """The verify-wave's attention: q (n, C, H, D), query c of row i over
    the first ``lengths[i, c]`` pool tokens of its table.

    CUDA tensors go through the hand-written kernel, one launch for all C
    queries, each query bitwise equal to the paged decode kernel at its
    length. CPU tensors, and every tensor under ``kernel_backend="ref"``,
    run :func:`_decode_attn_paged`'s plain path once per query, so the
    verified logits equal sequential decode steps there too.
    """
    if q.is_cuda and ctx.kernel_backend != "ref":
        from repro_torch.kernels.kvq_attn.ops import kvq_spec_verify_attn
        return kvq_spec_verify_attn(q, k_pool, v_pool, s_k, s_v, block_tbl,
                                    lengths)
    return torch.stack(
        [_decode_attn_paged(ctx, q[:, c], k_pool, v_pool, s_k, s_v,
                            block_tbl, lengths[:, c].contiguous())
         for c in range(q.shape[1])], dim=1)


# ==========================================================================
# Dense MLPs (SwiGLU; GELU with biases)
# ==========================================================================

def init_mlp(cfg: ModelConfig, gen: torch.Generator,
             dtype=torch.bfloat16) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wg": init_linear(gen, d, f, dtype=dtype),
                "wu": init_linear(gen, d, f, dtype=dtype),
                "wd": init_linear(gen, f, d, dtype=dtype)}
    return {"w1": init_linear(gen, d, f, bias=True, dtype=dtype),
            "w2": init_linear(gen, f, d, bias=True, dtype=dtype)}


def _row_sliced(p: Dict, d_in: int) -> bool:
    """Whether a row-parallel linear holds a slice of its ``d_in`` input
    rows (its packed plane's K, else its weight's), or the whole linear,
    which the sharding rules keep where ``tp`` does not divide ``d_in``."""
    exp = p.get("w4a8")
    k = 2 * exp["wq"].shape[-1] if exp is not None else p["w"].shape[-2]
    return k < d_in


def mlp_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
            col: Optional[Dict] = None) -> torch.Tensor:
    if train_tp(ctx):
        # tensor-parallel training: wg / wu (w1) column-parallel on the
        # input copied in, wd (w2) row-parallel
        x = ctx.tp.copy_in(x)
    if "w1" in p:
        # GELU MLP (whisper): the tanh-approximate GELU in f32
        h = qlinear(ctx, x, p["w1"], subcol(col, "w1"))
        h = _gelu(h.float(), _tanh).to(x.dtype)
        return qlinear(ctx, h, p["w2"], subcol(col, "w2"),
                       row=_row_sliced(p["w2"], cfg.d_ff))
    g = qlinear(ctx, x, p["wg"], subcol(col, "wg"))
    u = qlinear(ctx, x, p["wu"], subcol(col, "wu"))
    h = F.silu(g.float()).to(x.dtype) * u
    return qlinear(ctx, h, p["wd"], subcol(col, "wd"),
                   row=_row_sliced(p["wd"], cfg.d_ff))


# ==========================================================================
# Mixture of Experts (GShard capacity dispatch, chunked over tokens)
# ==========================================================================

def init_moe(cfg: ModelConfig, gen: torch.Generator,
             dtype=torch.bfloat16) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = gen.device

    def expert_w(din, dout):
        w = torch.randn((e, din, dout), generator=gen, dtype=torch.float32,
                        device=dev).mul_(din ** -0.5).to(dtype)
        return {"w": w,
                "s_w": torch.ones((e, 1, dout), dtype=torch.float32,
                                  device=dev),
                "s_in": torch.tensor(1.0, dtype=torch.float32, device=dev)}

    return {"router": init_linear(gen, d, e, dtype=dtype),
            "wg": expert_w(d, f), "wu": expert_w(d, f), "wd": expert_w(f, d)}


def _expert_linear(ctx: QuantCtx, x: torch.Tensor, p: Dict,
                   col: Optional[Dict], wq: torch.Tensor) -> torch.Tensor:
    """x (e, B, C, d_in) -> (e, B, C, d_out): the quantized activations of
    each expert's C slots times the expert's fake-quantized weights ``wq``
    (e, d_in, d_out), one batched GEMM over the experts (the reference's
    ``einsum("becd,edf->becf")``)."""
    e, Bn, C, _ = x.shape
    xq = quantize_act(ctx, x, p, "s_in", col)
    return torch.bmm(xq.reshape(e, Bn * C, -1), wq).reshape(e, Bn, C, -1)


def _expert_linear_row(ctx: QuantCtx, x: torch.Tensor, p: Dict,
                       col: Optional[Dict],
                       wq: torch.Tensor) -> torch.Tensor:
    """:func:`_expert_linear` of ``wd`` split inside the experts (TP
    inside experts): ``x`` and ``wq`` hold this rank's d_ff slice. A
    dynamic activation scale takes the whole row's amax (all-reduced
    MAX), so the slice's quantized values are tp=1's; the f32 partial
    products are all-reduced (SUM) and rounded once. That sum is not
    tp=1's bf16 GEMM's (other partial sums, rounded elsewhere): within a
    tolerance, not bitwise."""
    e, Bn, C, _ = x.shape
    if ctx.policy.act_dynamic and not ctx.off and ctx.mode != "calib":
        xf = x.float()
        amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
        ctx.tp.all_reduce_max(amax)
        q, s = quantize_by_amax(xf, amax, ctx.bits_for("s_in"))
        xq = (q.float() * s).to(x.dtype)
    else:   # a fixed scale (or none) quantizes the slice as the row
        xq = quantize_act(ctx, x, p, "s_in", col)
    part = torch.bmm(xq.reshape(e, Bn * C, -1).float(), wq.float())
    return ctx.tp.all_reduce_sum_f32(part).to(x.dtype).reshape(
        e, Bn, C, -1)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in its op order: exp(x - max)
    over its sum, the exp XLA:CPU's on the CPU (``recurrent._exp``)."""
    u = _exp(x - torch.amax(x, dim=-1, keepdim=True))
    return u / torch.sum(u, dim=-1, keepdim=True)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, in descending
    order, ties to the lower index (a stable sort keeps equal values in
    index order; ``torch.topk`` fixes no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ModelConfig, sc: int) -> int:
    """Slots per expert and batch row for a chunk of ``sc`` tokens: the
    reference's ``round(sc * k / e * MOE_CAPACITY_FACTOR)``, at least 1,
    rounded up to a multiple of 4 from 4 on, at most ``sc * k``."""
    e, k = cfg.n_experts, cfg.n_experts_active
    cap = max(1, int(round(sc * k / e * MOE_CAPACITY_FACTOR)))
    return min(cap + (-cap) % 4 if cap >= 4 else cap, sc * k)


def moe_route(logits: torch.Tensor, k: int, cap: int):
    """Routing of one chunk (logits (B, sc, e) f32): the top-k experts of
    each token (``idx``), its softmax gates over them, each (token, slot)'s
    position within its expert counted along the flattened (s, k) order
    within its row (``pos``), and ``keep = pos < cap``. Positions are
    integers, so the reference's f32 cumulative sum over one-hots gives
    the same values."""
    Bn, sc, e = logits.shape
    vals, idx = _top_k(logits, k)                        # (B, sc, k)
    gates = _softmax(vals)
    flat = F.one_hot(idx, e).reshape(Bn, sc * k, e)
    before = (torch.cumsum(flat, dim=1) - flat).reshape(Bn, sc, k, e)
    pos = torch.gather(before, -1, idx[..., None])[..., 0]
    return idx, gates, pos, pos < cap


def moe_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
            col: Optional[Dict] = None, *,
            with_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with per-batch-row capacity dispatch (the
    reference's ``moe_fwd``), chunked over the sequence at ``MOE_CHUNK_S``
    (S padded to a multiple of the chunk). Returns (y, the Switch
    load-balance aux averaged over chunks; zero when not ``with_aux``).

    The reference dispatches and combines with one-hot einsums; here the
    same sums are index gathers. A slot of expert e takes exactly one
    token's row (or stays zero), and a token's output is the sum of at
    most k products of a bf16 gate and a bf16 expert output, exact in f32:
    with k = 2 any order of summation gives the same bits. With k = 6
    (moonshot) the order of the f32 sum matters: the reference's
    contraction over (e, cap) agrees with the sum in top-k order (kept
    here), in ascending (e, c) order or in four lanes on 98.5-99.5% of
    the f32 values and no order on all, but after the cast to x's bf16
    every order gave the reference's bits except where the f32 sums sit
    on either side of a bf16 rounding tie
    (``tests/test_torch_moonshot.py``). Each bank is fake-quantized once
    per call, not once per chunk (the same values).
    The expert GEMMs run over the whole wave: on the H100 a prompt's
    prefill gave the same bits alone and in a padded wave of 4, and a
    tail-wave row alone and beside a deeper row (chip_smoke's mixtral
    and moonshot checks), so they need no row-by-row form as attention
    does.

    On a data axis (``ctx.dp``) the aux is the global batch's: the
    dispatch and the capacity are per batch row, so unchanged, and the
    routing statistics are summed over the data ranks (forward only).

    On a tensor-parallel mesh (``ctx.tp``) the banks are this rank's, as
    ``runtime.sharding.shard_params`` cuts them; the router is whole, so
    the routing, the capacity (of all ``n_experts``) and the dispatch
    table are tp=1's on every rank. With ``n_experts / tp`` experts a
    rank (expert parallelism: rank r holds experts ``[r E/tp, (r+1)
    E/tp)``) a rank fake-quantizes and runs only its experts, fills the
    (B, sc, k, d) slots of the tokens' top-k pairs its experts own (the
    read tp=1 makes, dropped pairs too) and leaves the rest zero, and
    ``TPComm.sum_owned`` gathers every slot from its owner bit for bit:
    the combine then runs as at tp=1, so the output is tp=1's bits. It
    moves B·sc·k·d bf16 values a layer, ``n_experts·cap / k`` times fewer
    than gathering the experts' outputs (at moonshot's decode, cap 1 of
    64 experts at top 6: 10.7x). With every expert's ``d_ff / tp`` slice
    (TP inside experts, where ``tp`` does not divide the experts) ``wg``
    and ``wu`` are column-parallel and ``wd`` row-parallel
    (:func:`_expert_linear_row`): within a tolerance of tp=1."""
    e, k = cfg.n_experts, cfg.n_experts_active
    Bn, S, d = x.shape
    tp = ctx.tp if ctx.tp is not None and ctx.tp.size > 1 else None
    e_loc = p["wg"]["w"].shape[0]
    lo = tp.rank * e_loc if tp is not None and e_loc < e else 0
    inside = (tp is not None and e_loc == e
              and p["wd"]["w"].shape[-2] < cfg.d_ff)
    sc = min(MOE_CHUNK_S, S)
    nchunk = -(-S // sc)
    pad = nchunk * sc - S
    xs = F.pad(x, (0, 0, 0, pad)) if pad else x
    cap = moe_capacity(cfg, sc)
    wq = {n: quantize_weight_p(ctx, p[n]) for n in ("wg", "wu", "wd")}
    dev = x.device
    bidx = torch.arange(Bn, device=dev)
    tok = torch.arange(sc, device=dev).view(1, sc, 1).expand(Bn, sc, k)
    ys, auxs = [], []
    for i in range(nchunk):
        xc = xs[:, i * sc:(i + 1) * sc]
        logits = qlinear(ctx, xc, p["router"], subcol(col, "router"),
                         act_bits=8, weight_bits=8).float()
        idx, gates, pos, keep = moe_route(logits, k, cap)
        # dispatch: the token each (expert, slot) holds, sc for none (the
        # zero row appended to the chunk); dropped pairs land in a sink
        slot = torch.where(keep, idx * cap + pos, e * cap)
        table = torch.full((Bn, e * cap + 1), sc, dtype=torch.long,
                           device=dev)
        table.scatter_(1, slot.reshape(Bn, -1), tok.reshape(Bn, -1))
        table = table[:, :e * cap].reshape(Bn, e, cap).transpose(0, 1)
        # the reference dispatches x in bf16 and casts back to x's type
        xz = torch.cat([xc, xc.new_zeros((Bn, 1, d))], dim=1).to(
            torch.bfloat16).to(x.dtype)
        # (this rank's experts only, under expert parallelism)
        xe = xz[bidx[None, :, None], table[lo:lo + e_loc]]  # (e, B, cap, d)
        g = _expert_linear(ctx, xe, p["wg"], subcol(col, "wg"), wq["wg"])
        u = _expert_linear(ctx, xe, p["wu"], subcol(col, "wu"), wq["wu"])
        h = F.silu(g.float()).to(x.dtype) * u
        down = _expert_linear_row if inside else _expert_linear
        ye = down(ctx, h, p["wd"], subcol(col, "wd"),
                  wq["wd"])                              # (e, B, cap, d)
        # combine: each token's k slots, gate (bf16) times output (bf16)
        # in f32, dropped pairs weighted zero
        slot_pos = torch.clamp_max(pos, cap - 1)
        if e_loc < e:
            # expert parallelism: the slots of this rank's experts, then
            # every slot from its owner (bitwise the whole gather)
            mine = (idx >= lo) & (idx < lo + e_loc)
            ysel = ye[torch.clamp(idx - lo, 0, e_loc - 1),
                      bidx[:, None, None], slot_pos]
            ysel = tp.sum_owned(torch.where(mine[..., None], ysel,
                                            torch.zeros_like(ysel)))
        else:
            ysel = ye[idx, bidx[:, None, None], slot_pos]
        gk = torch.where(keep, gates.to(torch.bfloat16).float(),
                         torch.zeros_like(gates))
        yc = torch.sum(ysel.to(torch.bfloat16).float() * gk[..., None],
                       dim=2)
        ys.append(yc.to(x.dtype))
        if with_aux:
            # load-balance aux (Switch): e * sum_e(frac_tokens * frac_prob);
            # frac_tokens is the reference's bf16 mean of a bf16 one-hot
            # sum: an f32 mean rounded to bf16
            probs = _softmax(logits)
            counts = F.one_hot(idx, e).sum(dim=2).float()
            if ctx.dp is None:
                frac_tok = (counts.sum(dim=(0, 1)) / float(Bn * sc)).to(
                    torch.bfloat16)
                frac_prob = probs.mean(dim=(0, 1))
            else:
                # data-parallel: the global batch's statistics. The counts
                # are integers (exact in f32, so frac_tok is the one-
                # process value); the probability sums are summed with a
                # local backward, as the gradient sync sums the ranks'
                # paths through them
                n_tok = float(Bn * sc * ctx.dp.size)
                tot = ctx.dp.all_reduce_sum(counts.sum(dim=(0, 1)))
                frac_tok = (tot / n_tok).to(torch.bfloat16)
                frac_prob = ctx.dp.sum_forward(probs.sum(dim=(0, 1))) / n_tok
            auxs.append(e * torch.sum(frac_tok.float() * frac_prob))
    y = ys[0] if nchunk == 1 else torch.cat(ys, dim=1)
    aux = (torch.stack(auxs).mean() if with_aux else
           torch.zeros((), dtype=torch.float32, device=dev))
    return y[:, :S], aux


# ==========================================================================
# Attention block with quantized KV cache
# ==========================================================================

def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype=torch.bfloat16, cross: bool = False) -> Dict:
    """q, k, v, o and the query and cache quantizer scales; a
    cross-attention (``cross``) takes no qk-norm."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dev = gen.device
    one = lambda: torch.tensor(1.0, dtype=torch.float32, device=dev)  # noqa: E731
    p = {"wq": init_linear(gen, d, qd, bias=cfg.qkv_bias, dtype=dtype),
         "wk": init_linear(gen, d, kvd, bias=cfg.qkv_bias, dtype=dtype),
         "wv": init_linear(gen, d, kvd, bias=cfg.qkv_bias, dtype=dtype),
         "wo": init_linear(gen, qd, d, dtype=dtype),
         "s_q": one(), "s_k": one(), "s_v": one()}
    if cfg.qk_norm and not cross:
        hd = cfg.resolved_head_dim
        p["q_norm"] = {"w": torch.ones((hd,), dtype=dtype, device=dev)}
        p["k_norm"] = {"w": torch.ones((hd,), dtype=dtype, device=dev)}
    return p


def _qkv(cfg: ModelConfig, ctx: QuantCtx, p: Dict, xq: torch.Tensor,
         xkv: torch.Tensor, rope, col: Optional[Dict] = None, *,
         skip_rope: bool = False):
    """q from ``xq`` (B, Sq, d), k and v from ``xkv`` (B, Skv, d): the
    same tensor for self-attention, the encoder's output for
    cross-attention (which applies no RoPE: ``skip_rope``)."""
    hd = cfg.resolved_head_dim
    B, Sq = xq.shape[0], xq.shape[1]
    Skv = xkv.shape[1]
    q = qlinear(ctx, xq, p["wq"], subcol(col, "wq")).reshape(
        B, Sq, cfg.n_heads, hd)
    k = qlinear(ctx, xkv, p["wk"], subcol(col, "wk")).reshape(
        B, Skv, cfg.n_kv_heads, hd)
    v = qlinear(ctx, xkv, p["wv"], subcol(col, "wv")).reshape(
        B, Skv, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = head_rms_norm(q, p["q_norm"]["w"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"]["w"], cfg.norm_eps)
    if rope is not None and not skip_rope:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    # paper sites: query INT16, cache C-bits
    q = quantize_act(ctx, q, p, "s_q", col)
    k = quantize_act(ctx, k, p, "s_k", col)
    v = quantize_act(ctx, v, p, "s_v", col)
    return q, k, v


def _out_proj(ctx: QuantCtx, p: Dict, out: torch.Tensor,
              col: Optional[Dict] = None) -> torch.Tensor:
    """The attention's output projection ``wo``: row-parallel over the
    ranks' heads on a tensor-parallel mesh, or whole where every rank
    runs every head (``ctx.attn_whole``)."""
    return qlinear(ctx, out, p["wo"], subcol(col, "wo"),
                   row=not ctx.attn_whole)


def attn_fwd(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
             rope, col: Optional[Dict] = None, *, window: int = 0,
             enc_out: Optional[torch.Tensor] = None,
             causal: bool = True) -> torch.Tensor:
    """Self-attention (``enc_out`` None; causal unless ``causal`` is
    False, as in the encoder) or cross-attention over ``enc_out``
    (B, Skv, d), never causal: the training / teacher / calibration path.

    The rule for the attention itself is written here once: a forward
    that needs no gradient (the teacher in each QAT step, calibration,
    evaluation: ``torch.is_grad_enabled()`` is False) runs the
    flash-attention kernel for CUDA tensors (``kernel_backend="ref"``: its
    plain version) and its plain version for CPU tensors; a forward under
    autograd (the student, the teacher's pretraining) runs
    :func:`blockwise_attention`, which autograd differentiates, as XLA
    differentiates the same function in the reference.
    """
    B, S, _ = x.shape
    if train_tp(ctx) and enc_out is None:
        return _attn_fwd_tp(cfg, ctx, p, x, rope, col, window=window,
                            causal=causal)
    xkv = x if enc_out is None else enc_out
    q, k, v = _qkv(cfg, ctx, p, x, xkv, rope, col,
                   skip_rope=enc_out is not None)
    out = _attention(ctx, q, k, v, causal=causal and enc_out is None,
                     window=window)
    return _out_proj(ctx, p, out.reshape(B, S, cfg.q_dim), col)


def _attention(ctx: QuantCtx, q, k, v, *, causal: bool, window: int,
               q_offset: int = 0, q_chunk: int = 1024) -> torch.Tensor:
    """:func:`attn_fwd`'s rule: :func:`blockwise_attention` under
    autograd, the flash kernel (CUDA) or its plain version without."""
    if torch.is_grad_enabled():
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, kv_chunk=1024,
                                   q_offset=q_offset)
    from repro_torch.kernels.flash_attn.ops import flash_attn_fwd
    return flash_attn_fwd(q, k, v, causal=causal, window=window,
                          q_offset=q_offset,
                          plain=ctx.kernel_backend == "ref")


def kv_heads_for(cfg: ModelConfig, heads: range) -> list:
    """The KV heads to hand an attention with the query heads ``heads``:
    the distinct ones they read (``h // group``) where local query head
    i reads local KV head ``i // (len(heads) / n)`` (the kernel's and
    :func:`blockwise_attention`'s map), else one a query head (heads
    that straddle groups unevenly, e.g. 6 of 12 query heads over 3 KV
    heads)."""
    group = cfg.n_heads // cfg.n_kv_heads
    kv = [h // group for h in heads]
    uniq = sorted(set(kv))
    per = len(kv) // len(uniq)
    even = len(kv) % len(uniq) == 0 and all(
        uniq.index(j) == i // per for i, j in enumerate(kv))
    return uniq if even else kv


def _attn_fwd_tp(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
                 rope, col: Optional[Dict], *, window: int,
                 causal: bool) -> torch.Tensor:
    """Self-attention on a tensor-parallel training rank
    (``ctx.attn_mode``; the reference's ``attn_shard_mode`` hints):

    * ``""``: ``wq`` / ``wk`` / ``wv`` cut by heads (the KV heads divide
      the model axis), local attention, ``wo`` row-parallel;
    * ``"kv_rep"``: ``wq`` cut by heads, ``wk`` / ``wv`` column-parallel
      as the rules cut them (a cut may fall inside a KV head); their
      outputs are gathered whole in rank order (exact) and each rank
      takes the KV heads its query heads read (one a query head where
      the rank's heads straddle groups: :func:`kv_heads_for`); the
      gather's backward sums the ranks' K/V gradients;
    * ``"seq"``: every attention linear whole; this rank's S / m query
      rows (at their global positions, ``q_offset``) attend over whole
      K / V, ``wo`` runs on those rows and the rows are gathered along
      the sequence.

    The block's input is copied in, so its gradient is summed over the
    ranks. The scales and norms a rank reads on its part only (s_q,
    s_k, s_v, the inputs of wo, q_norm / k_norm, and in ``seq`` every
    attention leaf) hold partial gradients the step sums afterwards."""
    tp, mode = ctx.tp, ctx.attn_mode
    m, r = tp.size, tp.rank
    hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    B, S, _ = x.shape
    x = tp.copy_in(x)
    cos = sin = None
    if rope is not None:
        cos, sin = rope
    if mode == "seq":
        n = S // m
        lo = r * n
        q = qlinear(ctx, x[:, lo:lo + n], p["wq"], subcol(col, "wq"),
                    shards=m).reshape(B, n, H, hd)
        k = qlinear(ctx, x, p["wk"], subcol(col, "wk")).reshape(
            B, S, Hkv, hd)
        v = qlinear(ctx, x, p["wv"], subcol(col, "wv")).reshape(
            B, S, Hkv, hd)
        q_shards, kv_shards, heads = m, 1, None
        if cos is not None:
            q_rope = (cos[lo:lo + n], sin[lo:lo + n])
    else:
        lo, n = 0, S
        hl = H // m
        q = qlinear(ctx, x, p["wq"], subcol(col, "wq")).reshape(
            B, S, hl, hd)
        k = qlinear(ctx, x, p["wk"], subcol(col, "wk"))
        v = qlinear(ctx, x, p["wv"], subcol(col, "wv"))
        if mode == "kv_rep":
            k = tp.gather_last(k, grad="sum")
            v = tp.gather_last(v, grad="sum")
            q_shards, kv_shards = m, 1
        else:
            q_shards, kv_shards = m, m
        k = k.reshape(B, S, -1, hd)
        v = v.reshape(B, S, -1, hd)
        heads = range(r * hl, (r + 1) * hl)
        q_rope = (cos, sin)
    if "q_norm" in p:
        q = head_rms_norm(q, p["q_norm"]["w"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"]["w"], cfg.norm_eps)
    if cos is not None:
        q = apply_rope(q, *q_rope)
        k = apply_rope(k, cos, sin)
    q = quantize_act(ctx, q, p, "s_q", col, shards=q_shards)
    k = quantize_act(ctx, k, p, "s_k", col, shards=kv_shards)
    v = quantize_act(ctx, v, p, "s_v", col, shards=kv_shards)
    if mode == "kv_rep":
        idx = torch.tensor(kv_heads_for(cfg, heads), device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    out = _attention(ctx, q, k, v, causal=causal, window=window,
                     q_offset=lo, q_chunk=n if mode == "seq" else 1024)
    out = out.reshape(B, n, -1)
    if mode == "seq":
        y = qlinear(ctx, out, p["wo"], subcol(col, "wo"), shards=m)
        return tp.gather_seq(y)
    return qlinear(ctx, out, p["wo"], subcol(col, "wo"), row=True)


def quantize_kv_for_cache(ctx: QuantCtx, p: Dict, k: torch.Tensor,
                          v: torch.Tensor):
    """(B,S,Hkv,D) bf16 -> cache layout (B,Hkv,S,D) + (B,Hkv,S) scales.

    Dynamic policy: per-token absmax int scales. Static policy: the learned
    LSQ scale broadcast per token. C16/off: bf16 storage, unit scales.
    """
    bits = ctx.policy.cache_bits
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if ctx.off or bits >= 16 or ctx.policy.act_dynamic:
        k_q, s_k = cache_quantize(ctx, kt, axis=-1)
        v_q, s_v = cache_quantize(ctx, vt, axis=-1)
        return k_q, v_q, s_k[..., 0], s_v[..., 0]
    s_k = p["s_k"].float().expand(kt.shape[:-1])
    s_v = p["s_v"].float().expand(vt.shape[:-1])
    return (quantize_to_int(kt, s_k[..., None], bits),
            quantize_to_int(vt, s_v[..., None], bits), s_k, s_v)


def _ring_gather(val: torch.Tensor, lengths: torch.Tensor,
                 Sc: int) -> torch.Tensor:
    """Dense ring cache of ``Sc`` rows from prefill K/V ``val``
    (B, Hkv, S, ...): the token at absolute position j lives at ring row
    j % Sc, each row keeps its last min(length, Sc) real tokens, and the
    rest stays zero. Written as a gather (row c reads the one kept token
    j with j % Sc == c), so no out-of-range scatter is needed."""
    B = val.shape[0]
    c = torch.arange(Sc, device=val.device)[None]                  # (1, Sc)
    lo = torch.clamp_min(lengths[:, None] - Sc, 0)                 # (B, 1)
    j = lo + torch.remainder(c - lo, Sc)                           # (B, Sc)
    valid = j < lengths[:, None]
    j = torch.minimum(j, torch.tensor(val.shape[2] - 1, device=val.device))
    idx = j.reshape(B, 1, Sc, *([1] * (val.ndim - 3)))
    idx = idx.expand(B, val.shape[1], Sc, *val.shape[3:])
    out = torch.gather(val, 2, idx)
    keep = valid.reshape(B, 1, Sc, *([1] * (val.ndim - 3)))
    return torch.where(keep, out, torch.zeros_like(out))


def attn_prefill(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x: torch.Tensor,
                 rope, *, window: int = 0, cache_len: int = 0,
                 lengths: Optional[torch.Tensor] = None,
                 page_size: int = 0, row_lengths: Optional[list] = None,
                 enc_out: Optional[torch.Tensor] = None):
    """Causal attention over the prompt that also emits the quantized
    dense cache for serving.

    ``enc_out`` (B, Skv, d) makes it a cross-attention instead: the
    queries attend, without a mask, over K/V projected from the encoder's
    output, and the cache holds all ``Skv`` rows of them (a decoder
    layer's frozen cross cache; ``cache_len`` and ``lengths`` do not
    apply).

    ``window`` > 0 (a local-attention layer) attends over the last
    ``window`` positions and keeps a ring of ``min(cache_len, window)``
    rows: the token at position j lives at row j % Sc.

    ``lengths`` (B,) marks the valid (right-padded) prefix of each row:
    pad-position K/V are dropped from the cache and ``cache["length"]``
    holds the true per-row length, so one padded prefill call admits
    prompts of different lengths (causality keeps real-token outputs
    independent of the padding). On CUDA the attention runs row by row
    over ``row_lengths`` (host ints; the lengths when not given;
    :func:`_prefill_attention_rows`), so a row's result does not depend
    on the wave it rides in.

    ``page_size`` > 0 emits the cache in *block shape* (B, nb, Hkv,
    page_size, D) instead: the paged engine scatters those blocks into
    the global pool through the rows' block ids. The attention is the
    same either way; it needs ``window`` 0 (paged layers are full
    attention).
    """
    B, S, _ = x.shape
    if page_size and window:
        raise ValueError("paged cache layout requires full attention "
                         "(window == 0)")
    cross = enc_out is not None
    q, k, v = _qkv(cfg, ctx, p, x, enc_out if cross else x, rope,
                   skip_rope=cross)
    if row_lengths is None and lengths is not None:
        row_lengths = lengths.tolist() if x.is_cuda else None
    if x.is_cuda and row_lengths is not None:
        out = _prefill_attention_rows(q, k, v, row_lengths, window,
                                      causal=not cross)
    else:
        out = blockwise_attention(q, k, v, causal=not cross, window=window,
                                  q_chunk=1024, kv_chunk=1024)
    y = _out_proj(ctx, p, out.reshape(B, S, cfg.q_dim))
    k_q, v_q, s_k, s_v = quantize_kv_for_cache(ctx, p, k, v)
    if cross:
        cache = {n: t.contiguous() for n, t in
                 (("k_q", k_q), ("v_q", v_q), ("s_k", s_k), ("s_v", s_v))}
        cache["length"] = torch.full((B,), k.shape[1], dtype=torch.int32,
                                     device=x.device)
        return y, cache
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if page_size:
        cache = _paginate_kv(k_q, v_q, s_k, s_v, page_size)
        cache["length"] = lengths.to(torch.int32, copy=True)
        return y, cache
    Sc = cache_len or S
    if window:
        Sc = min(Sc, window)   # ring eviction enforces the sliding window
    cache = {"k_q": _ring_gather(k_q, lengths, Sc),
             "v_q": _ring_gather(v_q, lengths, Sc),
             "s_k": _ring_gather(s_k, lengths, Sc),
             "s_v": _ring_gather(s_v, lengths, Sc),
             # a copy per layer: decode advances each layer's in place
             "length": lengths.to(torch.int32, copy=True)}
    return y, cache


def _prefill_attention_rows(q, k, v, lengths: list, window: int = 0,
                            causal: bool = True) -> torch.Tensor:
    """Attention of a prefill wave, each row's queries over its own
    ``lengths[b]`` real tokens and nothing else; pad positions stay zero
    (causality keeps them out of every real token, and their K/V are
    dropped from the cache). Batched, the wave's score and probability
    GEMMs and the softmax sums take their shapes, and so cuBLAS's kernel
    and the reductions' summation order, from the whole wave (its row
    count and padded length); row by row a prompt's cache and first-token
    logits are the same whichever prompts it is admitted with.
    ``lengths``: host ints; ``window`` as in :func:`attn_prefill`. Not
    ``causal`` (a cross-attention): each row's queries over all of its
    keys."""
    out = torch.zeros_like(q)
    for b, n in enumerate(lengths):
        if n:
            kv = slice(None) if not causal else slice(0, n)
            out[b, :n] = blockwise_attention(
                q[b:b + 1, :n], k[b:b + 1, kv], v[b:b + 1, kv],
                causal=causal, window=window, q_chunk=1024,
                kv_chunk=1024)[0]
    return out


def _paginate_kv(k_q, v_q, s_k, s_v, page_size: int) -> Dict:
    """Cache-layout K/V (B, Hkv, S, D) + scales (B, Hkv, S) -> block shape
    (B, nb, Hkv, page_size, D) / (B, nb, Hkv, page_size); the trailing
    partial block is zero-padded (masked by ``length`` at read and
    overwritten in place by decode)."""
    B, Hkv, S = k_q.shape[0], k_q.shape[1], k_q.shape[2]
    nb = -(-S // page_size)
    pad = nb * page_size - S

    def blk(x):
        widths = [0, 0] * (x.ndim - 3) + [0, pad]     # F.pad: last dim first
        xp = F.pad(x, widths) if pad else x
        xp = xp.reshape((B, Hkv, nb, page_size) + tuple(x.shape[3:]))
        return xp.movedim(2, 1)                      # (B, nb, Hkv, bs, ...)

    return {"k_q": blk(k_q), "v_q": blk(v_q),
            "s_k": blk(s_k), "s_v": blk(s_v)}


def _blank_attn_cache(B: int, cfg: ModelConfig, S: int, qdtype,
                      device) -> Dict:
    hd = cfg.resolved_head_dim
    kw = {"device": device}
    return {
        "k_q": torch.zeros((B, cfg.n_kv_heads, S, hd), dtype=qdtype, **kw),
        "v_q": torch.zeros((B, cfg.n_kv_heads, S, hd), dtype=qdtype, **kw),
        "s_k": torch.zeros((B, cfg.n_kv_heads, S), dtype=torch.float32, **kw),
        "s_v": torch.zeros((B, cfg.n_kv_heads, S), dtype=torch.float32, **kw),
        "length": torch.zeros((B,), dtype=torch.int32, **kw),
    }


def init_attn_cache(cfg: ModelConfig, B: int, S: int, *, device,
                    window: int = 0, dtype=torch.int8) -> Dict:
    """window > 0 -> a ring bounded at the window (sliding-window
    decode)."""
    Sc = min(S, window) if window else S
    return _blank_attn_cache(B, cfg, Sc, dtype, device)


def init_paged_attn_cache(cfg: ModelConfig, B: int, num_blocks: int,
                          page_size: int, *, layers: int, device,
                          dtype=torch.int8):
    """Global block pools of ``layers`` attention layers: ``num_blocks``
    blocks of ``page_size`` tokens, shared by every slot through the block
    table, plus the sink block. Each leaf is one layer-stacked tensor
    (layers, num_blocks + 1, Hkv, page_size[, D]), so one copy launch per
    leaf clones a block in every layer.

    Returns (pool, per-layer caches): the stacked leaves, and one dict per
    layer holding views of them and the layer's per-slot ``length``.
    """
    hd = cfg.resolved_head_dim
    shape = (layers, num_blocks + 1, cfg.n_kv_heads, page_size)
    kw = {"device": device}
    pool = {"k_q": torch.zeros(shape + (hd,), dtype=dtype, **kw),
            "v_q": torch.zeros(shape + (hd,), dtype=dtype, **kw),
            "s_k": torch.zeros(shape, dtype=torch.float32, **kw),
            "s_v": torch.zeros(shape, dtype=torch.float32, **kw)}
    return pool, paged_layer_views(pool, B)


def paged_layer_views(pool: Dict, B: int,
                      lengths: Optional[list] = None) -> list:
    """Per-layer cache dicts over the stacked pool leaves: views of each
    leaf's layer row, and a per-slot ``length`` (zeros, or ``lengths``)."""
    n = next(iter(pool.values())).shape[0]
    dev = next(iter(pool.values())).device
    return [{**{k: pool[k][i] for k in POOL_KEYS},
             "length": (torch.zeros((B,), dtype=torch.int32, device=dev)
                        if lengths is None else lengths[i])}
            for i in range(n)]


def attn_decode(cfg: ModelConfig, ctx: QuantCtx, p: Dict, x1: torch.Tensor,
                cache: Dict, positions: torch.Tensor,
                block_tbl: Optional[torch.Tensor] = None, rope=None,
                cross: bool = False):
    """One-token decode step. x1: (B, 1, d). Returns (y1, cache).

    ``cross``: a cross-attention over the frozen cache the prefill wrote
    from the encoder's output: the query alone is projected (no RoPE),
    nothing is committed, and the attention reads the cache's
    ``length`` rows.

    Dense layout: writes the new K/V row of every slot into ``cache`` in
    place (ring row ``length % Sc``), advances ``cache["length"]`` and
    attends over the first min(length, Sc) rows. A sliding-window layer's
    ring holds ``min(cache_len, window)`` rows, so once it wraps the
    oldest token is overwritten and the window is kept by the ring itself.

    ``block_tbl`` (B, T) switches to the paged layout: the commit goes
    through the slot's table into the pool, and a slot whose entry is the
    sentinel (a parked slot) writes into the sink block, which nothing
    reads. Attention walks the table.

    ``rope``: the step's (cos, sin) tables at ``positions``, computed once
    per step by the caller; made here when not given.
    """
    B = x1.shape[0]
    hd = cfg.resolved_head_dim
    if cross:
        q = qlinear(ctx, x1, p["wq"]).reshape(B, 1, cfg.n_heads, hd)
        q = quantize_act(ctx, q, p, "s_q")
        out = _decode_attn(ctx, q[:, 0], cache["k_q"], cache["v_q"],
                           cache["s_k"], cache["s_v"], cache["length"])
        y = _out_proj(ctx, p, out.reshape(B, cfg.q_dim))
        return y[:, None], cache
    if rope is None and cfg.rope_theta:
        rope = rope_tables(positions[:, None], hd, cfg.rope_theta)
    q, k, v = _qkv(cfg, ctx, p, x1, x1, rope)
    k_q1, v_q1, s_k1, s_v1 = quantize_kv_for_cache(ctx, p, k, v)
    if block_tbl is not None:
        bs = cache["k_q"].shape[2]
        T = block_tbl.shape[1]
        pos = cache["length"].long()                 # tokens written so far
        blk = torch.gather(block_tbl.long(), 1,
                           torch.clamp_max(pos // bs, T - 1)[:, None])[:, 0]
        blk = torch.clamp(blk, 0, pool_blocks(cache["k_q"]))
        off = pos % bs
        cache["k_q"][blk, :, off] = k_q1[:, :, 0]
        cache["v_q"][blk, :, off] = v_q1[:, :, 0]
        cache["s_k"][blk, :, off] = s_k1[:, :, 0]
        cache["s_v"][blk, :, off] = s_v1[:, :, 0]
        cache["length"] += 1
        out = _decode_attn_paged(ctx, q[:, 0], cache["k_q"], cache["v_q"],
                                 cache["s_k"], cache["s_v"], block_tbl,
                                 cache["length"])
        y = _out_proj(ctx, p, out.reshape(B, cfg.q_dim))
        return y[:, None], cache
    Sc = cache["k_q"].shape[2]
    slot = torch.remainder(cache["length"], Sc).long()
    bidx = torch.arange(B, device=x1.device)
    cache["k_q"][bidx, :, slot] = k_q1[:, :, 0]
    cache["v_q"][bidx, :, slot] = v_q1[:, :, 0]
    cache["s_k"][bidx, :, slot] = s_k1[:, :, 0]
    cache["s_v"][bidx, :, slot] = s_v1[:, :, 0]
    cache["length"] += 1
    out = _decode_attn(ctx, q[:, 0], cache["k_q"], cache["v_q"],
                       cache["s_k"], cache["s_v"],
                       torch.clamp_max(cache["length"], Sc))
    y = _out_proj(ctx, p, out.reshape(B, cfg.q_dim))
    return y[:, None], cache


def attn_chunk_prefill(cfg: ModelConfig, ctx: QuantCtx, p: Dict,
                       x: torch.Tensor, rope, cache: Dict,
                       tbl: torch.Tensor, slot: torch.Tensor,
                       offset: torch.Tensor, chunk_len: torch.Tensor,
                       hist_rows: Optional[list] = None):
    """One window of an incremental (chunked or prefix-hit tail) prefill
    for a batch of slots with per-row offsets, on the paged pool.

    x (n, C, d): row i is a window of one slot's prompt whose first token
    sits at absolute position ``offset[i]``; its first ``chunk_len[i]``
    positions are real, the rest padding. Every row is a real slot
    (``slot`` holds valid slot ids). Queries attend to the ``offset[i]``
    tokens already in the pool (gathered through ``tbl[i]`` and
    dequantized by ``gather_dequant_paged_kv``, as decode reads them)
    plus the window itself (causal, exact bf16 K/V); that softmax over
    ``Lh + C`` keys is plain torch, as the reference leaves it to XLA.
    The window's K/V are then quantized and committed through the table
    in place (``commit_chunk_kv``), and ``length[slot]`` moves to
    ``offset + chunk_len``. The engine has grown each table to cover the
    window and resolved copy-on-write for shared blocks in the write range
    before the call, so the commit lands only in blocks the row owns.

    ``hist_rows`` (host ints, one per row) is each row's own history
    extent in blocks, the one the row would get in a wave of its own. On
    CUDA it makes each row's result independent of what else rides the
    wave; elsewhere, and without it, the wave is computed in one batch
    over ``tbl``'s width, as in the reference.
    """
    from repro_torch.kernels.kvq_attn.ops import (
        commit_chunk_kv, gather_dequant_paged_kv_pair)
    n, C, _ = x.shape
    q, k, v = _qkv(cfg, ctx, p, x, x, rope)
    bs = cache["k_q"].shape[2]
    kh, vh = gather_dequant_paged_kv_pair(cache["k_q"], cache["s_k"],
                                          cache["v_q"], cache["s_v"], tbl)
    if x.is_cuda and hist_rows is not None:
        # one row at a time over its own history extent: cuBLAS picks a
        # batched GEMM's kernel from the batch count and the key length,
        # so a row computed inside a wave (whose extent the deepest row
        # sets) could differ in the last bits from the same row alone
        out = torch.cat([_window_attention(
            cfg, q[i:i + 1], k[i:i + 1], v[i:i + 1],
            kh[i:i + 1, :, :hist_rows[i] * bs],
            vh[i:i + 1, :, :hist_rows[i] * bs], offset[i:i + 1],
            chunk_len[i:i + 1]) for i in range(n)])
    else:
        out = _window_attention(cfg, q, k, v, kh, vh, offset, chunk_len)
    y = _out_proj(ctx, p, out.reshape(n, C, cfg.q_dim).to(x.dtype))
    k_q1, v_q1, s_k1, s_v1 = quantize_kv_for_cache(ctx, p, k, v)
    commit_chunk_kv(cache, k_q1, v_q1, s_k1, s_v1, tbl, offset, chunk_len)
    cache["length"][slot.long()] = (offset + chunk_len).to(torch.int32)
    return y, cache


def _window_attention(cfg: ModelConfig, q, k, v, kh, vh, offset,
                      chunk_len) -> torch.Tensor:
    """Softmax attention of a batch of windows q/k/v (n, C, H|Hkv, D) over
    their dequantized history kh/vh (n, Hkv, Lh, D) plus the window
    itself. History key j is valid iff j < offset (allocated but unwritten
    positions hold stale data); window key j is causal and masked past
    chunk_len. Returns (n, C, H, D) f32."""
    C = q.shape[1]
    Lh = kh.shape[2]
    dev = q.device
    kall = torch.cat([kh.transpose(1, 2), k.float()], dim=1)
    vall = torch.cat([vh.transpose(1, 2), v.float()], dim=1)
    group = cfg.n_heads // cfg.n_kv_heads
    if group > 1:
        kall = torch.repeat_interleave(kall, group, dim=2)
        vall = torch.repeat_interleave(vall, group, dim=2)
    scale = cfg.resolved_head_dim ** -0.5
    scores = torch.einsum("bqhd,bkhd->bqhk", q.float() * scale, kall)
    kj = torch.arange(Lh + C, device=dev)
    qi = torch.arange(C, device=dev)
    hist = kj < Lh
    kpos = torch.where(hist, kj, kj - Lh)[None, None, :]
    mask = torch.where(hist[None, None, :],
                       kpos < offset.long()[:, None, None],
                       (kpos <= qi[None, :, None])
                       & (kpos < chunk_len.long()[:, None, None]))
    mask4 = mask[:, :, None, :]
    scores = torch.where(mask4, scores, torch.full_like(scores, _NEG))
    pr = torch.softmax(scores, dim=-1)
    pr = torch.where(mask4, pr, torch.zeros_like(pr))
    return torch.einsum("bqhk,bkhd->bqhd", pr, vall)


def attn_spec_verify(cfg: ModelConfig, ctx: QuantCtx, p: Dict,
                     x: torch.Tensor, rope, cache: Dict, tbl: torch.Tensor,
                     slot: torch.Tensor, offset: torch.Tensor,
                     chunk_len: torch.Tensor):
    """One attention layer of the speculative verify-wave.

    The batched-window contract of :func:`attn_chunk_prefill`: x (n, C, d)
    holds one slot's window ``[last_token, draft_1..draft_k]`` per row,
    committed through the table at per-row offsets (``commit_chunk_kv``).
    The numerics are decode's, not prefill's: the window's K/V are
    quantized and committed to the pool first, and every window position
    then reads the pool back through the table, as the ``k + 1``
    sequential decode steps it replaces would. Position j attends to
    ``offset + j + 1`` tokens; positions at or past ``chunk_len`` commit
    into the sink and their outputs are discarded by the engine. The
    caller rolls the rejected suffix back (device counters and
    ``BlockAllocator.trim``) and has grown the table and resolved
    copy-on-write for ``[offset, offset + chunk_len)`` before the call.

    Returns (y (n, C, d), cache) with ``length[slot]`` at
    ``offset + chunk_len``.
    """
    from repro_torch.kernels.kvq_attn.ops import commit_chunk_kv
    n, C, _ = x.shape
    q, k, v = _qkv(cfg, ctx, p, x, x, rope)
    k_q1, v_q1, s_k1, s_v1 = quantize_kv_for_cache(ctx, p, k, v)
    commit_chunk_kv(cache, k_q1, v_q1, s_k1, s_v1, tbl, offset, chunk_len)
    cache["length"][slot.long()] = (offset + chunk_len).to(torch.int32)
    # per-query extent: the history plus the window through the query
    lens = (offset[:, None] + 1
            + torch.arange(C, device=x.device)[None]).to(torch.int32)
    out = _spec_verify_attn(ctx, q, cache["k_q"], cache["v_q"],
                            cache["s_k"], cache["s_v"], tbl, lens)
    y = _out_proj(ctx, p, out.reshape(n, C, cfg.q_dim).to(x.dtype))
    return y, cache
