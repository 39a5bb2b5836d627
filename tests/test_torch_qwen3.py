"""The port's qwen3 slice (qwen3-14b and qwen3-32b: dense GQA decoders
with qk-norm and an untied head; qwen3-32b's q_dim exceeds d_model)
against the JAX package: the configs, ``head_rms_norm``, the forward,
prefill and decode, the batched-window calls on the pool (tail prefill
and the verify-wave) through qk-norm and the w4a8 export of the untied
head. The engines: ``test_torch_qwen3_engine.py``; one QAT step:
``test_torch_qwen3_train.py``. The two archs' reduced configs (2
layers, d 64, 4 heads on 2, head dim 16, d_ff 128, q_dim = d_model) are
the same but for the name, so the model cases run qwen3-14b's and
``"qwen3-32b-wide"``, the reduced qwen3-32b with 8 heads of 16 (q_dim
128 > d 64, a GQA group of 4), as the full model's 64 heads of 128
exceed its 5120.

Same params (the reference's, calibrated, bridged), same inputs from a
numpy seed; the JAX side runs op by op (``jax.disable_jit``). Tolerances,
each with its reason:

* ``head_rms_norm``: one ``rsqrt`` per head and token, which XLA:CPU
  computes as the x86 estimate refined by a Newton step and the port
  correctly rounded (ROADMAP, Queue 3 item 1): within one bf16 ulp (rtol
  2^-7), at most ``RSQRT_SHARE`` of the outputs differing (measured 1 in
  14208 and 1 in 113664);
* the forward's logits (QAT mode): at G 2 within one bf16 ulp or
  ``FWD_ATOL``, at most ``FWD_SHARE`` differing (a bf16 GEMM near a
  tie); at G 4 the attention's f32 contractions (XLA's dot, torch's
  einsum) round 0.5% of the first layer's attention outputs one bf16 ulp
  apart (held to ``ATTN_SHARE``), and the next linear's per-token int8
  quantization carries those on (10% of the logits differ, relative L2
  5.6e-3): the logits within ``FWD_REL`` relative L2, argmax equal;
* prefill, decode and the batched-window calls' logits: bitwise
  (measured).
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
from repro.models import common as jcommon
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
from repro_torch.core.precision import parse_policy as t_parse_policy
from repro_torch.models import (decode_step, forward, init_cache, prefill,
                                prefill_tail, spec_verify)
from repro_torch.models import blocks as TB
from repro_torch.models import common as tcommon
from repro_torch.models.common import head_rms_norm

POLICY = "A8d-C8-W4"
RSQRT_SHARE = 1e-3
FWD_SHARE = 1e-3
FWD_ATOL = 1e-6
ATTN_SHARE = 1e-2
FWD_REL = 2e-2
WIDE = dict(n_heads=8, head_dim=16)
VARIANTS = ("qwen3-14b", "qwen3-32b-wide")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(variant):
    arch = variant.replace("-wide", "")
    kw = WIDE if variant.endswith("-wide") else {}
    return (get_reduced_config(arch).replace(**kw),
            t_reduced(arch).replace(**kw))


def _port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


_SERVED = {}


def _served(variant):
    if variant not in _SERVED:
        cfg, tcfg = _cfgs(variant)
        params = jqat.calibrate_weight_scales(
            jinit(cfg, jax.random.PRNGKey(0)), parse_policy(POLICY))
        _SERVED[variant] = (cfg, tcfg, params, _port(params))
    return _SERVED[variant]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# --------------------------------------------------------------------------
# configs and qk-norm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen3-32b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_for_field(arch, reduced):
    c = t_reduced(arch) if reduced else t_get_config(arch)
    r = get_reduced_config(arch) if reduced else get_config(arch)
    for f in dataclasses.fields(c):
        assert getattr(c, f.name) == getattr(r, f.name), f.name
    assert c.qk_norm and not c.tie_embeddings and not c.qkv_bias
    if not reduced:
        assert c.resolved_head_dim == 128
        assert c.n_heads // c.n_kv_heads == {"qwen3-14b": 5,
                                             "qwen3-32b": 8}[arch]


def test_wide_variant_widens_q():
    a, b = t_reduced("qwen3-14b"), t_reduced("qwen3-32b")
    assert a.replace(name=b.name) == b
    cfg, tcfg = _cfgs("qwen3-32b-wide")
    assert tcfg.q_dim == 128 > tcfg.d_model == 64 == cfg.d_model
    assert tcfg.n_heads // tcfg.n_kv_heads == 4


@pytest.mark.parametrize("D", [16, 128])
def test_head_rms_norm_matches_reference(D):
    rng = np.random.default_rng(D)
    x = rng.standard_normal((3, 37, 8, D)).astype(np.float32) * 3.0
    w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = jcommon.head_rms_norm(jx, jw, 1e-6)
    got = head_rms_norm(bridge.to_torch(np.asarray(jx), "cpu"),
                        bridge.to_torch(np.asarray(jw), "cpu"), 1e-6)
    g, wv = _f32(got), _f32(want)
    np.testing.assert_allclose(g, wv, rtol=2.0 ** -7, atol=0)
    assert np.mean(g != wv) <= RSQRT_SHARE


# --------------------------------------------------------------------------
# the model stack
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_op_by_op_reference(variant):
    cfg, tcfg, params, tp = _served(variant)
    jctx, tctx = jqat.make_ctx(POLICY), tqat.make_ctx(POLICY)
    toks = _tokens(cfg, (2, 30), 1)
    with jax.disable_jit():
        want, _ = jforward(cfg, params, jctx, {"tokens": jnp.asarray(toks)})
    got, _ = forward(tcfg, tp, tctx, {"tokens": torch.from_numpy(toks)})
    g, w = _f32(got), _f32(want)
    assert (g.argmax(-1) == w.argmax(-1)).all()
    if tcfg.n_heads // tcfg.n_kv_heads == 2:
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=FWD_ATOL)
        assert np.mean(g != w) <= FWD_SHARE
        return
    assert np.linalg.norm(g - w) <= FWD_REL * np.linalg.norm(w)
    # the first layer's attention: one ulp apart on a few outputs
    x = _tokens(cfg, (2, 30), 2)
    jx = jnp.asarray(params["embed"]["w"])[x]
    jp = jax.tree.map(lambda a: a[0], params["segments"][0]["0"]["attn"])
    rope = jcommon.rope_tables(jnp.arange(30)[None], cfg.resolved_head_dim,
                               cfg.rope_theta)
    with jax.disable_jit():
        ja = JB.attn_fwd(cfg, jctx, jp, jx, rope)
    ta = TB.attn_fwd(tcfg, tctx, tp["layers"][0]["attn"],
                     tp["embed"]["w"][torch.from_numpy(x)],
                     tcommon.rope_tables(torch.arange(30)[None],
                                         tcfg.resolved_head_dim,
                                         tcfg.rope_theta))
    a, b = _f32(ta), _f32(ja)
    np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=FWD_ATOL)
    assert np.mean(a != b) <= ATTN_SHARE


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match_reference(variant):
    """A padded wave of two prompts and 3 decode steps through qk-norm:
    logits and the first layer's cache codes bitwise (measured)."""
    cfg, tcfg, params, tp = _served(variant)
    jctx, tctx = jqat.make_ctx(POLICY), tqat.make_ctx(POLICY)
    toks = _tokens(cfg, (2, 30), 7)
    lens = np.array([19, 30], np.int32)
    feed = [((np.arange(2) * 31 + 7 * i) % 256).astype(np.int32)[:, None]
            for i in range(3)]
    with jax.disable_jit():
        jl, jc = jax_prefill(cfg, params, jctx,
                             {"tokens": jnp.asarray(toks),
                              "lengths": jnp.asarray(lens)},
                             cache_budget=40)
        ref = [jl]
        for f in feed:
            jl, jc = jax_decode_step(cfg, params, jctx, jnp.asarray(f), jc)
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
    for k in ("k_q", "s_k", "v_q"):
        np.testing.assert_array_equal(
            _f32(tc["layers"][1][k]),
            _f32(jc["segments"][0]["0"]["self"][k][1]), err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_batched_windows_on_the_pool_match_reference(variant):
    """qk-norm through two tail-prefill windows at per-row offsets and a
    verify-wave on the pool: logits bitwise at every call (measured)."""
    cfg, tcfg, params, tp = _served(variant)
    jctx, tctx = jqat.make_ctx(POLICY), tqat.make_ctx(POLICY)
    S, NB, bs, T = 2, 24, 8, 8
    tbl = np.random.default_rng(2).permutation(NB)[:S * T].reshape(
        S, T).astype(np.int32)
    jc = jinit_cache(cfg, jctx, S, T * bs, num_blocks=NB, page_size=bs,
                     table_len=T)
    jc["block_tbl"] = jnp.asarray(tbl)
    tc = init_cache(tcfg, tctx, S, T * bs, device="cpu", num_blocks=NB,
                    page_size=bs, table_len=T)
    tc["block_tbl"].copy_(torch.from_numpy(tbl))
    slot = np.array([0, 1], np.int32)
    for kind, toks, start, n in (
            ("tail", _tokens(cfg, (2, 16), 3), [0, 0], [16, 11]),
            ("tail", _tokens(cfg, (2, 16), 4), [16, 11], [7, 16]),
            ("verify", _tokens(cfg, (2, 5), 5), [23, 27], [5, 3])):
        args = (slot, np.array(start, np.int32), np.array(n, np.int32))
        jfn, tfn = ((jprefill_tail, prefill_tail) if kind == "tail"
                    else (jspec_verify, spec_verify))
        with jax.disable_jit():
            jl, jc = jfn(cfg, params, jctx, jnp.asarray(toks), jc,
                         *map(jnp.asarray, args))
        tl, tc = tfn(tcfg, tp, tctx, torch.from_numpy(toks), tc,
                     *map(torch.from_numpy, args))
        np.testing.assert_array_equal(_f32(tl), _f32(jl), err_msg=kind)


# --------------------------------------------------------------------------
# the w4a8 export
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["qwen3-14b", "qwen3-32b-wide"])
def test_w4a8_export_of_the_untied_head(variant):
    """The untied head packs at the head's 8 bits (the body at 4), codes
    and scales bitwise with the reference's; re-attaching exports to a
    tree whose bf16 weights were dropped keeps the head's export (it
    must not be re-exported from the embedding)."""
    cfg, tcfg, params, tp = _served(variant)
    jexp = jqat.attach_w4a8_exports(params, parse_policy(POLICY))
    texp = tqat.attach_w4a8_exports(tp, t_parse_policy(POLICY))
    for k in ("wq", "s_w"):
        np.testing.assert_array_equal(_f32(texp["head"]["w4a8"][k]),
                                      np.asarray(jexp["head"]["w4a8"][k],
                                                 np.float32), err_msg=k)
    again = tqat.attach_w4a8_exports(tqat.drop_exported_weights(texp),
                                     t_parse_policy(POLICY))
    assert "w" not in again["head"]
    for k, v in texp["head"]["w4a8"].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(again["head"]["w4a8"][k], v), k
    assert tqat.w4a8_weight_bytes(texp) == jqat.w4a8_weight_bytes(jexp)
