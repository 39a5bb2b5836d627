"""The port's moonshot slice (moonshot-v1-16b-a3b: top 6 of 64 experts,
the first MoE on the paged pool) against the JAX package: the config,
the MoE block at top 6, the model stack, the batched-window calls (tail
prefill and the verify-wave) on the pool, and the paged engine with
prefix sharing, optimistic admission with a preemption and speculative
decoding (``test_torch_moonshot_engine.py``). Training, PTQ and the
bridge: ``test_torch_moonshot_train.py``.

Same params (the reference's, calibrated, bridged), same tokens through
both. The reduced config (2 layers, d 64, 4 heads on 4, head dim 16, 8
experts, top 2, d_ff 64) is the reference's own; the top-6 cases take
``replace(n_experts_active=6)`` and ``replace(n_experts=64,
n_experts_active=6)`` of it. Tolerances, each with its reason:

* routing (top-k with ties, positions, ``keep``, the capacity): exact;
* ``moe_fwd`` at top 2: bitwise (two exact f32 products); at top 6 the
  f32 sum of six products depends on its order, and after the cast to
  bf16 the reference's bits are kept except where the sum sits on
  either side of a bf16 rounding tie: within one bf16 ulp (rtol 2^-8),
  at most ``TIE_SHARE`` of the values differing (measured: none of them
  at the shapes here); the aux within ``AUX_RTOL`` (its f32 means'
  order);
* the forward's logits as ``test_torch_mixtral.py`` holds them (one bf16
  ulp, ``FWD_SHARE``); prefill, decode and the batched-window calls:
  bitwise (measured).

Reference-side properties mirrored, not repaired: an MoE routes a
verify-wave's C tokens at a C-token chunk's capacity (one slot an expert
at C 5, top 6 of 64), so a token decode keeps can be dropped there, and
spec streams need not equal plain decode streams; a prefix hit changes
the routing capacity of the tail that is computed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import blocks as JB
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro.models import prefill as jax_prefill
from repro.models import prefill_tail as jprefill_tail
from repro.models import spec_verify as jspec_verify
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import qat as tqat
from repro_torch.models import (clone_cache, decode_step, forward,
                                init_cache, prefill, prefill_tail,
                                spec_verify)
from repro_torch.models import blocks as TB

ARCH = "moonshot-v1-16b-a3b"
POLICY = "A8d-C8-W4"
AUX_RTOL = 1e-6
FWD_SHARE = 1e-3
FWD_ATOL = 1e-6
TIE_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def served():
    cfg, tcfg = get_reduced_config(ARCH), t_reduced(ARCH)
    params = jqat.calibrate_weight_scales(jinit(cfg, jax.random.PRNGKey(0)),
                                          parse_policy(POLICY))
    return cfg, tcfg, params, _port(params)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_for_field(reduced):
    c = t_reduced(ARCH) if reduced else t_get_config(ARCH)
    r = get_reduced_config(ARCH) if reduced else get_config(ARCH)
    for f in dataclasses.fields(c):
        assert getattr(c, f.name) == getattr(r, f.name), f.name
    assert c.is_moe and not c.sliding_window and not c.tie_embeddings
    assert c.layer_kinds() == r.layer_kinds()
    if not reduced:
        assert (c.n_experts, c.n_experts_active, c.resolved_head_dim,
                c.n_heads // c.n_kv_heads) == (64, 6, 128, 1)
        assert c.param_counts()["total"] == 28_057_796_608


# --------------------------------------------------------------------------
# the MoE block at top 6 of 64
# --------------------------------------------------------------------------

def _moe(cfg_j, cfg_t, seed=3):
    p = JB.init_moe(cfg_j, jax.random.PRNGKey(seed))
    p = jqat.calibrate_weight_scales(p, parse_policy(POLICY))
    return p, jax.tree.map(lambda a: bridge.to_torch(np.asarray(a), "cpu"),
                           p)


VARIANTS = {"top2of8": {}, "top6of8": {"n_experts_active": 6},
            "top6of64": {"n_experts": 64, "n_experts_active": 6}}


@pytest.mark.parametrize("variant,chunk,factor", [
    ("top2of8", None, None), ("top6of8", None, None), ("top6of8", 8, None),
    ("top6of8", None, 0.5), ("top6of64", None, None), ("top6of64", 8, None)])
def test_moe_fwd_matches_reference(variant, chunk, factor, monkeypatch):
    """y at S 20 in one chunk and in three chunks of 8, with the default
    capacity and one that drops: bitwise at top 2, within one bf16 ulp
    with at most TIE_SHARE differing at top 6; the aux to AUX_RTOL."""
    kw = VARIANTS[variant]
    cfg = get_reduced_config(ARCH).replace(**kw)
    tcfg = t_reduced(ARCH).replace(**kw)
    p, tp = _moe(cfg, tcfg)
    for mod in (JB, TB):
        if chunk:
            monkeypatch.setattr(mod, "MOE_CHUNK_S", chunk)
        if factor:
            monkeypatch.setattr(mod, "MOE_CAPACITY_FACTOR", factor)
    x = np.random.default_rng(1).standard_normal((2, 20, cfg.d_model))
    jx = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    tx = bridge.to_torch(np.asarray(jx), "cpu")
    with jax.disable_jit():
        jy, jaux = JB.moe_fwd(cfg, jqat.make_ctx(POLICY), p, jx)
    ty, taux = TB.moe_fwd(tcfg, tqat.make_ctx(POLICY), tp, tx)
    g, w = _f32(ty), _f32(jy)
    if cfg.n_experts_active == 2:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=2.0 ** -8, atol=0)
        assert np.mean(g != w) <= TIE_SHARE
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)


def _ref_route(logits, k, cap):
    """The reference chunk's routing, line for line (jnp)."""
    e = logits.shape[-1]
    B, sc = logits.shape[:2]
    vals, idx = jax.lax.top_k(logits, k)
    gates = jax.nn.softmax(vals, axis=-1)
    oh = jax.nn.one_hot(idx, e, dtype=jnp.bfloat16)
    flat = oh.astype(jnp.float32).reshape(B, sc * k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(B, sc, k, e)
    pos = jnp.sum(pos * oh.astype(jnp.float32), axis=-1)
    frac_tok = jnp.mean(jnp.sum(oh, axis=2), axis=(0, 1))
    return idx, gates, pos, pos < cap, frac_tok


@pytest.mark.parametrize("sc", [1, 5, 64, 130])
def test_routing_at_64_experts_top_6(sc):
    """At e 64 and k 6 nothing needs to change: the top-6 indices (ties to
    the lower expert), gates, positions, ``keep`` at the chunk's capacity
    (one slot an expert for a token and for a 5-token verify window) and
    the aux's bf16 ``frac_tok`` equal the reference's."""
    cfg = t_reduced(ARCH).replace(n_experts=64, n_experts_active=6)
    cap = TB.moe_capacity(cfg, sc)
    assert cap == {1: 1, 5: 1, 64: 8, 130: 16}[sc]
    rng = np.random.default_rng(sc)
    logits = rng.integers(-3, 4, (3, sc, 64)).astype(np.float32) / 8.0
    logits[0, 0, :] = 0.25                        # a 64-way tie
    with jax.disable_jit():
        jidx, jg, jpos, jkeep, jfrac = _ref_route(jnp.asarray(logits), 6,
                                                  cap)
    idx, gates, pos, keep = TB.moe_route(torch.from_numpy(logits), 6, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(gates.numpy(), np.asarray(jg))
    assert idx[0, 0].tolist() == list(range(6))
    counts = torch.nn.functional.one_hot(idx, 64).sum(dim=2).float()
    frac = (counts.sum(dim=(0, 1)) / float(3 * sc)).to(torch.bfloat16)
    np.testing.assert_array_equal(_f32(frac), _f32(jfrac))


# --------------------------------------------------------------------------
# the model stack
# --------------------------------------------------------------------------

def test_forward_matches_op_by_op_reference(served):
    cfg, tcfg, params, tp = served
    toks = _tokens(cfg, (2, 30), 1)
    with jax.disable_jit():
        want, jaux = jforward(cfg, params, jqat.make_ctx(POLICY),
                              {"tokens": jnp.asarray(toks)})
    got, aux = forward(tcfg, tp, tqat.make_ctx(POLICY),
                       {"tokens": torch.from_numpy(toks)})
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=FWD_ATOL)
    assert np.mean(g != w) <= FWD_SHARE
    np.testing.assert_allclose(float(aux["moe_aux"]), float(jaux["moe_aux"]),
                               rtol=AUX_RTOL)


def test_prefill_and_decode_match_reference(served):
    """A padded wave of two prompts, then 3 decode steps: logits and the
    first layer's cache codes bitwise."""
    cfg, tcfg, params, tp = served
    jctx, tctx = jqat.make_ctx(POLICY), tqat.make_ctx(POLICY)
    toks = _tokens(cfg, (2, 30), 7)
    lens = np.array([19, 30], np.int32)
    with jax.disable_jit():
        jl, jc = jax_prefill(cfg, params, jctx,
                             {"tokens": jnp.asarray(toks),
                              "lengths": jnp.asarray(lens)},
                             cache_budget=40)
        ref = [jl]
        feed = []
        for i in range(3):
            feed.append(((np.arange(2) * 31 + 7 * i) % 256).astype(
                np.int32)[:, None])
            jl, jc = jax_decode_step(cfg, params, jctx, jnp.asarray(feed[-1]),
                                     jc)
            ref.append(jl)
    tl, tc = prefill(tcfg, tp, tctx, {"tokens": torch.from_numpy(toks),
                                      "lengths": torch.from_numpy(lens)},
                     cache_budget=40)
    got = [tl]
    for f in feed:
        tl, tc = decode_step(tcfg, tp, tctx, torch.from_numpy(f), tc)
        got.append(tl)
    for step, (g, w) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(_f32(g), _f32(w), err_msg=str(step))
    jk = jc["segments"][0]["0"]["self"]["k_q"][0]
    np.testing.assert_array_equal(_f32(tc["layers"][0]["k_q"]), _f32(jk))


def _paged_pair(cfg, tcfg, S, NB, bs, T, seed):
    """The same blank paged cache in both packages, one shuffled block
    table."""
    tbl = np.random.default_rng(seed).permutation(NB)[:S * T].reshape(
        S, T).astype(np.int32)
    jc = jinit_cache(cfg, jqat.make_ctx(POLICY), S, T * bs, num_blocks=NB,
                     page_size=bs, table_len=T)
    jc["block_tbl"] = jnp.asarray(tbl)
    tc = init_cache(tcfg, tqat.make_ctx(POLICY), S, T * bs, device="cpu",
                    num_blocks=NB, page_size=bs, table_len=T)
    tc["block_tbl"].copy_(torch.from_numpy(tbl))
    return jc, tc


def test_batched_windows_on_the_pool_match_reference(served):
    """Two rows through two tail-prefill windows of 16 (the second at
    per-row offsets, so the MoE routes each window at a 16-token chunk's
    capacity), a verify-wave of 5 (3 real in one row) and a decode step,
    all on the pool: logits bitwise at every call."""
    cfg, tcfg, params, tp = served
    jctx, tctx = jqat.make_ctx(POLICY), tqat.make_ctx(POLICY)
    jc, tc = _paged_pair(cfg, tcfg, 2, 24, 8, 8, seed=2)
    slot = np.array([0, 1], np.int32)
    calls = [("tail", _tokens(cfg, (2, 16), 3), [0, 0], [16, 11]),
             ("tail", _tokens(cfg, (2, 16), 4), [16, 11], [7, 16]),
             ("verify", _tokens(cfg, (2, 5), 5), [23, 27], [5, 3])]
    for kind, toks, start, n in calls:
        args = (slot, np.array(start, np.int32), np.array(n, np.int32))
        jfn, tfn = ((jprefill_tail, prefill_tail) if kind == "tail"
                    else (jspec_verify, spec_verify))
        with jax.disable_jit():
            jl, jc = jfn(cfg, params, jctx, jnp.asarray(toks), jc,
                         *map(jnp.asarray, args))
        tl, tc = tfn(tcfg, tp, tctx, torch.from_numpy(toks), tc,
                     *map(torch.from_numpy, args))
        np.testing.assert_array_equal(_f32(tl), _f32(jl), err_msg=kind)
    tok = np.array([[5], [9]], np.int32)
    with jax.disable_jit():
        jl, _ = jax_decode_step(cfg, params, jctx, jnp.asarray(tok), jc)
    tl, _ = decode_step(tcfg, tp, tctx, torch.from_numpy(tok), tc)
    np.testing.assert_array_equal(_f32(tl), _f32(jl))


def test_verify_equals_decode_only_without_drops(served, monkeypatch):
    """The verify-wave's logits at position j equal ``decode_step``'s after
    the same tokens when no pair is dropped (capacity factor 100), the
    contract a dense MLP keeps; at the default capacity of a 5-token
    window (at top 6 of 64: one slot an expert) they need not."""
    cfg, tcfg, params, tp = served
    monkeypatch.setattr(TB, "MOE_CAPACITY_FACTOR", 100.0)
    tctx = tqat.make_ctx(POLICY)
    _, tc = _paged_pair(cfg, tcfg, 2, 24, 8, 8, seed=6)
    slot = torch.tensor([0, 1], dtype=torch.int32)
    prompt = torch.from_numpy(_tokens(cfg, (2, 16), 7))
    _, tc = prefill_tail(tcfg, tp, tctx, prompt, tc, slot,
                         torch.tensor([0, 0], dtype=torch.int32),
                         torch.tensor([16, 13], dtype=torch.int32))
    win = torch.from_numpy(_tokens(cfg, (2, 5), 8))
    start = tc["position"].clone()
    seq, cache = [], clone_cache(tc)
    for j in range(5):
        lg, cache = decode_step(tcfg, tp, tctx, win[:, j:j + 1], cache)
        seq.append(lg[:, 0])
    vl, _ = spec_verify(tcfg, tp, tctx, win, clone_cache(tc), slot, start,
                        torch.tensor([5, 5], dtype=torch.int32))
    assert torch.equal(vl, torch.stack(seq, dim=1))
