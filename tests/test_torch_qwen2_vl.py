"""The port's qwen2-vl-2b slice (a VLM decoder backbone: M-RoPE over a
prefix of precomputed patch embeddings, GQA with QKV bias, a tied head)
against the JAX package: the config, ``mrope_tables``, the forward with
patches, the reference's ``test_vlm_mrope_text_equivalence``, prefill
with patches then decode, and the engines text-only (dense, and paged
with a shared prefix).

Same params (the reference's, calibrated, bridged), same tokens, patches
and positions (numpy, seeded); the JAX side runs op by op
(``jax.disable_jit``), the reference engine with ``w4a8_backend="ref"``.
The reduced config is the reference's (2 layers, d 64, 4 heads on 2 of
16, 8 patch positions). Tolerances: ``mrope_tables`` bitwise; the
forward's logits within one bf16 ulp or ``FWD_ATOL``, at most
``FWD_SHARE`` differing (a bf16 GEMM near a tie, as
``test_torch_qwen2_7b.py`` holds it; measured: 1 of 9216 at random
streams, 0 on the raster); prefill's cache codes and logits, decode's
logits and the engines' streams and counters bitwise or equal
(measured); the text-equivalence case within the reference's 1e-4.
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
from repro.models import common as JC
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import qat as tqat
from repro_torch.core.precision import parse_policy as t_parse_policy
from repro_torch.models import common as TC
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "qwen2-vl-2b"
POLICY = "A8d-C8-W4"
FWD_SHARE = 1e-3
FWD_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def served():
    cfg, tcfg = get_reduced_config(ARCH), t_reduced(ARCH)
    params = jqat.calibrate_weight_scales(jinit(cfg, jax.random.PRNGKey(0)),
                                          parse_policy(POLICY))
    return cfg, tcfg, params, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def vl_positions(B, grid, n_text):
    """Qwen2-VL's position streams for a patch prefix on a ``grid`` x
    ``grid`` raster followed by ``n_text`` tokens: patches at t 0 and
    (h, w) their row and column; the text from max + 1 on all three
    streams. (3, B, grid**2 + n_text) int32."""
    hh, ww = np.divmod(np.arange(grid * grid), grid)
    text = grid + np.arange(n_text)
    t = np.concatenate([np.zeros(grid * grid, np.int64), text])
    h = np.concatenate([hh, text])
    w = np.concatenate([ww, text])
    return np.broadcast_to(np.stack([t, h, w])[:, None],
                           (3, B, t.size)).astype(np.int32).copy()


def _inputs(cfg, B, S, seed, grid=None):
    """Tokens, bf16 patches and positions: the reference's batch and the
    port's. ``grid``: Qwen2-VL's raster scheme (vision_tokens must be
    grid**2), else random distinct streams."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)
                                  ).astype(np.float32)
    n = cfg.vision_tokens + S
    if grid:
        pos = vl_positions(B, grid, S)
    else:
        pos = rng.integers(0, 4 * n, (3, B, n)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
          "patches": jnp.asarray(patches).astype(jnp.bfloat16)}
    tb = {"tokens": torch.from_numpy(toks), "positions": torch.from_numpy(pos),
          "patches": torch.from_numpy(patches).to(torch.bfloat16)}
    return jb, tb


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_for_field(reduced):
    c = t_reduced(ARCH) if reduced else t_get_config(ARCH)
    r = get_reduced_config(ARCH) if reduced else get_config(ARCH)
    for f in dataclasses.fields(c):
        assert getattr(c, f.name) == getattr(r, f.name), f.name
    assert c.param_counts() == r.param_counts()
    assert c.mrope and c.family == "vlm" and c.tie_embeddings
    if not reduced:
        assert (c.vision_tokens, c.resolved_head_dim,
                c.n_heads // c.n_kv_heads) == (256, 128, 6)


@pytest.mark.parametrize("head_dim,theta,top", [
    (16, 1_000_000.0, 300), (128, 1_000_000.0, 40_000), (64, 10_000.0, 5)])
def test_mrope_tables_match_reference(head_dim, theta, top):
    """Distinct t, h and w streams, positions up to ``top`` (past 120
    rad: glibc's large-argument reduction): cos and sin bitwise; with
    three equal streams they equal ``rope_tables``."""
    rng = np.random.default_rng(head_dim)
    pos = rng.integers(0, top, (3, 2, 37)).astype(np.int32)
    with jax.disable_jit():
        jc, js = JC.mrope_tables(jnp.asarray(pos), head_dim, theta)
    tc, ts = TC.mrope_tables(torch.from_numpy(pos), head_dim, theta)
    assert tuple(tc.shape) == (2, 37, head_dim // 2)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    mc, ms = TC.mrope_tables(torch.from_numpy(same), head_dim, theta)
    rc, rs = TC.rope_tables(torch.from_numpy(same[0]), head_dim, theta)
    assert torch.equal(mc, rc) and torch.equal(ms, rs)


@pytest.mark.parametrize("grid", [None, 2])
def test_forward_with_patches_matches_reference(served, grid):
    """The patch prefix and M-RoPE positions (random distinct streams over
    the reduced 8 patches, and Qwen2-VL's raster scheme over 4 patches on
    a 2 x 2 grid): logits over prefix and text bitwise."""
    cfg, tcfg, params, tp = served
    if grid:
        cfg, tcfg = (c.replace(vision_tokens=grid * grid) for c in (cfg, tcfg))
    jb, tb = _inputs(cfg, 2, 10, 1, grid)
    with jax.disable_jit():
        jl, _ = jforward(cfg, params, jqat.make_ctx(POLICY), jb)
    got, _ = forward(tcfg, tp, tqat.make_ctx(POLICY), tb)
    assert got.shape == (2, cfg.vision_tokens + 10, cfg.vocab_size)
    g, w = _f32(got), _f32(jl)
    np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=FWD_ATOL)
    assert np.mean(g != w) <= FWD_SHARE


def test_vlm_mrope_text_equivalence():
    """The reference's case: with the three streams equal, M-RoPE is
    RoPE, so a VLM forward on text equals the model without mrope."""
    cfg = t_reduced(ARCH).replace(vision_tokens=0)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    ctx = tqat.make_ctx("A16-C16-W16", mode="off")
    B, S = 2, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(0))
    pos = torch.arange(S).repeat(3, B, 1)
    with torch.no_grad():
        l_mrope, _ = forward(cfg, params, ctx,
                             {"tokens": tokens, "positions": pos})
        l_std, _ = forward(cfg.replace(mrope=False), params, ctx,
                           {"tokens": tokens})
    np.testing.assert_allclose(l_mrope.numpy(), l_std.numpy(), atol=1e-4)


@pytest.mark.parametrize("layout", ["bf16", "w4a8"])
def test_prefill_with_patches_then_decode(served, layout):
    """Prefill over patches and text, then 3 decode steps (plain RoPE at
    the position after the prefix, as the reference): logits and the
    cache codes bitwise, the position counting the prefix."""
    cfg, tcfg, params, tp = served
    jctx = jqat.make_ctx(POLICY, weights_layout=layout, w4a8_backend="ref")
    tctx = tqat.make_ctx(POLICY, weights_layout=layout)
    if layout == "w4a8":
        params = jqat.attach_w4a8_exports(params, parse_policy(POLICY))
        tp = tqat.attach_w4a8_exports(tp, t_parse_policy(POLICY))
    jb, tb = _inputs(cfg, 2, 12, 7)
    feed = [np.array([[11 + i], [200 - i]], np.int32) for i in range(3)]
    with jax.disable_jit():
        jl, jc = jprefill(cfg, params, jctx, jb, cache_budget=32)
        ref = [jl]
        for f in feed:
            jl, jc = jdecode(cfg, params, jctx, jnp.asarray(f), jc)
            ref.append(jl)
    tl, tc = prefill(tcfg, tp, tctx, tb, cache_budget=32)
    assert tc["position"].tolist() == [cfg.vision_tokens + 12] * 2
    got = [tl]
    for f in feed:
        tl, tc = decode_step(tcfg, tp, tctx, torch.from_numpy(f), tc)
        got.append(tl)
    for step, (g, w) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(_f32(g), _f32(w), err_msg=str(step))
    for i in range(cfg.n_layers):
        for k in ("k_q", "v_q", "s_k", "s_v", "length"):
            np.testing.assert_array_equal(
                _f32(tc["layers"][i][k]),
                _f32(jc["segments"][0]["0"]["self"][k][i]), err_msg=k)


PAGED = dict(slots=2, cache_len=64, kv_layout="paged", block_size=16,
             num_blocks=32, max_seq_len=96, decode_block=4)
DENSE = dict(slots=2, cache_len=64, decode_block=4)


def _shared(cls, n=3):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 250, 40).astype(np.int32)
    return [cls(uid=i, prompt=np.concatenate(
        [prefix, ((np.arange(5) * (i + 3) + i) % 250).astype(np.int32)]),
        max_new_tokens=6, temperature=0.8 if i == 2 else 0.0,
        top_k=8 if i == 2 else 0, seed=i) for i in range(n)]


def _drain(eng, reqs):
    eng.submit(reqs[0])
    eng.run_until_drained()
    for r in reqs[1:]:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], stats


@pytest.mark.parametrize("kw", [DENSE, PAGED], ids=["dense", "paged"])
def test_engine_text_only_matches_reference(served, kw):
    """The engine serves the VLM text-only, as the reference's: shared-
    prefix requests (on the pool: hits, COW of the split block,
    tail-waves) under w4a8, streams and counters equal to the reference
    engine's run op by op."""
    cfg, tcfg, params, tp = served
    teng = ServeEngine(tcfg, tp, weights_layout="w4a8", device="cpu", **kw)
    got, st = _drain(teng, _shared(Request))
    jeng = JServeEngine(cfg, params, weights_layout="w4a8",
                        w4a8_backend="ref", **kw)
    with jax.disable_jit():
        ref, rst = _drain(jeng, _shared(JRequest))
    assert got == ref
    for k in ("tokens_out", "decode_steps", "prefill_calls"):
        assert st[k] == rst[k], k
    if kw is PAGED:
        assert st["prefix_hit_tokens"] > 0 and st["cow_copies"] > 0
        assert st["tail_waves"] > 0


def test_dense_and_paged_streams_equal(served):
    """Prompts of three lengths, each admitted in one cold prefill window
    (prefix cache off), greedy and sampled: the paged engine gives the
    dense engine's streams (chip_smoke's phase 3n holds them equal on the
    card). With the prefix cache on, a tail prefill reads its history
    back quantized, so its streams need not equal a cold prefill's."""
    _, tcfg, _, tp = served
    lens = (40, 40, 24, 24, 24, 9, 9, 9)

    def reqs():
        rng = np.random.default_rng(21)
        return [Request(uid=i, prompt=rng.integers(0, 250, n).astype(
            np.int32), max_new_tokens=5,
            temperature=0.8 if i % 4 == 3 else 0.0,
            top_k=8 if i % 4 == 3 else 0, seed=i)
            for i, n in enumerate(lens)]

    kw = dict(slots=4, cache_len=64, block_size=16, prefill_chunk=64,
              prefix_cache=False, decode_block=4, weights_layout="w4a8",
              device="cpu")
    streams = []
    for layout in ("dense", "paged"):
        eng = ServeEngine(tcfg, tp, kv_layout=layout, **kw)
        rs = reqs()
        for r in rs:
            eng.submit(r)
        eng.run_until_drained()
        streams.append([r.generated for r in rs])
    assert streams[0] == streams[1]
