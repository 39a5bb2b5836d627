"""The port's whisper-large-v3 slice (an encoder-decoder: LayerNorm, a GELU
MLP with biases, learned absolute positions, a bidirectional encoder over
precomputed frames, cross-attention over a frozen int8 cache) against the
JAX package: the config, LayerNorm and the GELU MLP, the encoder, the
forward (with and without collected statistics), prefill and decode, the
reference's own whisper cases, the refusals, the bridge and checkpoint
round-trips and the encoder's activation scales under
``merge_act_scales``.

Same params (the reference's, calibrated, bridged), same tokens and
frames (numpy, seeded); the JAX side runs op by op (``jax.disable_jit``).
The reduced config is the reference's (2 encoder and 2 decoder layers, d
64, 4 heads of 16, encoder_seq 32). Tolerances: LayerNorm's mean and
variance bitwise, its output within one bf16 ulp with at most
``LN_SHARE`` of the values differing (its rsqrt is within one ulp of
XLA:CPU's, ROADMAP Queue 3 item 1); the GELU MLP, the encoder, the
forward's logits, prefill's cache codes, scales and logits and four
decode steps' logits bitwise (measured); in calibration mode (the
activations unquantized, so a bf16 GEMM near a tie rounds one ulp apart
in XLA's dot and torch's, as ``test_torch_qwen3_train.py``'s teacher)
the logits within ``CALIB_RTOL`` relative L2 and the statistics within
``STAT_RTOL``; teacher forcing at A16-C16-W16 within the reference's
2e-2; the round-trips bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import blocks as JB
from repro.models import common as JC
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models.model import _encode as j_encode
from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import qat as tqat
from repro_torch.core.precision import parse_policy as t_parse_policy
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import decode_step, forward, init_cache, \
    init_params, prefill
from repro_torch.models.model import _encode as t_encode
from repro_torch.serve.engine import ServeEngine

ARCH = "whisper-large-v3"
POLICY = "A8d-C8-W4"
LN_SHARE = 1e-2
STAT_RTOL = 2.0 ** -7
CALIB_RTOL = 1e-2


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


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.fixture(scope="module")
def served():
    cfg, tcfg = get_reduced_config(ARCH), t_reduced(ARCH)
    params = jqat.calibrate_weight_scales(jinit(cfg, jax.random.PRNGKey(0)),
                                          parse_policy(POLICY))
    return cfg, tcfg, params, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _inputs(cfg, B, S, seed):
    """Tokens and bf16 frames from one numpy generator: the reference's
    batch and the port's."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(toks),
          "frames": jnp.asarray(frames).astype(jnp.bfloat16)}
    tb = {"tokens": torch.from_numpy(toks),
          "frames": torch.from_numpy(frames).to(torch.bfloat16)}
    return jb, tb


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_for_field(reduced):
    c = t_reduced(ARCH) if reduced else t_get_config(ARCH)
    r = get_reduced_config(ARCH) if reduced else get_config(ARCH)
    for f in dataclasses.fields(c):
        assert getattr(c, f.name) == getattr(r, f.name), f.name
    assert c.param_counts() == r.param_counts()
    assert c.is_encdec and c.norm_type == "ln" and c.mlp_type == "gelu"
    if not reduced:
        assert (c.encoder_layers, c.encoder_seq, c.resolved_head_dim,
                c.max_position_embeddings) == (32, 1500, 64, 36_864)


@pytest.mark.parametrize("d", [64, 1280, 100])
def test_layer_norm_matches_reference(d):
    """The mean and the variance bitwise (XLA:CPU's summation order), the
    output within one bf16 ulp, at most LN_SHARE of it differing."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((64, d)) * 3 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jp = {"w": jnp.asarray(w).astype(jnp.bfloat16),
          "b": jnp.asarray(b).astype(jnp.bfloat16)}
    tp = {"w": torch.from_numpy(w).to(torch.bfloat16),
          "b": torch.from_numpy(b).to(torch.bfloat16)}
    with jax.disable_jit():
        xf = jx.astype(jnp.float32)
        jmu = jnp.mean(xf, axis=-1, keepdims=True)
        jvar = jnp.var(xf, axis=-1, keepdims=True)
        want = JC.layer_norm(jx, jp, 1e-6)
    txf = tx.float()
    tmu = TC._row_mean(txf)
    c = txf - tmu
    np.testing.assert_array_equal(tmu.numpy(), np.asarray(jmu))
    np.testing.assert_array_equal(TC._row_mean(c * c).numpy(),
                                  np.asarray(jvar))
    got = _f32(TC.layer_norm(tx, tp, 1e-6))
    ref = _f32(want)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-6)
    assert np.mean(got != ref) <= LN_SHARE
    assert np.array_equal(_f32(TC.norm(tx, tp, "ln", 1e-6)), got)


def test_gelu_mlp_matches_reference(served):
    """The GELU MLP (w1 + bias, tanh-approximate GELU in f32, w2 + bias)
    under A8d-C8-W4, bitwise."""
    cfg, tcfg, params, tp = served
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], params["segments"][0]["0"]["mlp"])
    with jax.disable_jit():
        want = JB.mlp_fwd(cfg, jqat.make_ctx(POLICY), jp,
                          jnp.asarray(x).astype(jnp.bfloat16))
    got = TB.mlp_fwd(tcfg, tqat.make_ctx(POLICY), tp["layers"][0]["mlp"],
                     torch.from_numpy(x).to(torch.bfloat16))
    assert set(tp["layers"][0]["mlp"]) == {"w1", "w2"}
    assert "b" in tp["layers"][0]["mlp"]["w1"]
    np.testing.assert_array_equal(_f32(got), _f32(want))
    u = rng.standard_normal(4096).astype(np.float32) * 4
    with jax.disable_jit():
        jg = jax.nn.gelu(jnp.asarray(u))
    np.testing.assert_array_equal(
        TC._gelu(torch.from_numpy(u), TC._tanh).numpy(), np.asarray(jg))


def test_encoder_matches_reference(served):
    cfg, tcfg, params, tp = served
    jb, tb = _inputs(cfg, 2, 8, 5)
    with jax.disable_jit():
        want = j_encode(cfg, jqat.make_ctx(POLICY), params, jb, None)
    got = t_encode(tcfg, tqat.make_ctx(POLICY), tp, tb, None)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("policy,mode", [("A8d-C8-W4", "train"),
                                         ("A8s-C8-W4", "calib")])
def test_forward_matches_op_by_op_reference(served, policy, mode):
    """Logits bitwise; in calibration mode every statistic within
    STAT_RTOL, the encoder's under the reference's keys."""
    cfg, tcfg, params, tp = served
    jb, tb = _inputs(cfg, 2, 12, 1)
    collect = mode == "calib"
    with jax.disable_jit():
        jl, jaux = jforward(cfg, params, jqat.make_ctx(policy, mode=mode),
                            jb, collect_stats=collect)
    with torch.no_grad():
        tl, taux = forward(tcfg, tp, tqat.make_ctx(policy, mode=mode), tb,
                           collect_stats=collect)
    if not collect:
        np.testing.assert_array_equal(_f32(tl), _f32(jl))
        return
    # unquantized activations: a bf16 GEMM near a tie rounds apart
    g, w = _f32(tl), _f32(jl)
    assert np.linalg.norm(g - w) <= CALIB_RTOL * np.linalg.norm(w)
    want = dict(bridge.flatten(jax.tree.map(np.asarray, jaux["qstats"])))
    got = {}
    for path, v in bridge.flatten(taux["qstats"]):
        parts = path.split("/")
        if parts[0] == "layers":
            key = "segments/0/0/" + "/".join(parts[2:])
        elif parts[:2] == ["encoder", "layers"]:
            key = "encoder/" + "/".join(parts[3:])
        else:
            key = path
        got.setdefault(key, []).append(float(v))
    assert got.keys() == want.keys()
    assert "encoder/0attn/wq/s_in" in want and "encoder/0mlp/w2/s_in" in want
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(v, np.float32).reshape(-1),
                                   rtol=STAT_RTOL, err_msg=k)


@pytest.mark.parametrize("layout", ["bf16", "w4a8"])
def test_prefill_and_decode_match_reference(served, layout):
    """Prefill (an exact-length wave of 2) and 4 decode steps through the
    bf16 linears and through the w4a8 exports: logits, the self and the
    cross caches' int8 codes and scales bitwise."""
    cfg, tcfg, params, tp = served
    jctx = jqat.make_ctx(POLICY, weights_layout=layout, w4a8_backend="ref")
    tctx = tqat.make_ctx(POLICY, weights_layout=layout)
    if layout == "w4a8":
        params = jqat.attach_w4a8_exports(params, parse_policy(POLICY))
        tp = tqat.attach_w4a8_exports(tp, t_parse_policy(POLICY))
    jb, tb = _inputs(cfg, 2, 10, 7)
    feed = [np.array([[3 + i], [77 + i]], np.int32) for i in range(4)]
    with jax.disable_jit():
        jl, jc = jprefill(cfg, params, jctx, jb, cache_budget=20)
        ref = [jl]
        for f in feed:
            jl, jc = jdecode(cfg, params, jctx, jnp.asarray(f), jc)
            ref.append(jl)
    tl, tc = prefill(tcfg, tp, tctx, tb, cache_budget=20)
    got = [tl]
    for f in feed:
        tl, tc = decode_step(tcfg, tp, tctx, torch.from_numpy(f), tc)
        got.append(tl)
    for step, (g, w) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(_f32(g), _f32(w), err_msg=str(step))
    for i in range(cfg.n_layers):
        for part in ("self", "cross"):
            tcache = tc["layers"][i] if part == "self" else \
                tc["layers"][i]["cross"]
            jcache = jc["segments"][0]["0"][part]
            for k in ("k_q", "v_q", "s_k", "s_v", "length"):
                np.testing.assert_array_equal(
                    _f32(tcache[k]), _f32(jcache[k][i]),
                    err_msg=f"{i} {part} {k}")
    assert tc["layers"][0]["cross"]["k_q"].dtype == torch.int8
    assert tc["layers"][0]["cross"]["length"].tolist() == [cfg.encoder_seq] * 2
    assert tc["position"].tolist() == [14, 14]


def test_whisper_uses_encoder():
    """The reference's case: the decoder's logits depend on the frames."""
    cfg = t_reduced(ARCH)
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    ctx = tqat.make_ctx("A16-C16-W16", mode="off")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen)
    f1 = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen)
    f2 = torch.randn(f1.shape, generator=gen)
    with torch.no_grad():
        l1, _ = forward(cfg, params, ctx, {"tokens": tokens, "frames": f1})
        l2, _ = forward(cfg, params, ctx, {"tokens": tokens, "frames": f2})
    assert float((l1 - l2).abs().max()) > 1e-3


def test_decode_matches_teacher_forcing():
    """The reference's teacher-forcing case on whisper: f32 params,
    quantization off; decode over the self and cross caches matches the
    parallel forward at each position to 2e-2."""
    cfg = t_reduced(ARCH)
    params = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    ctx = tqat.make_ctx("A16-C16-W16", mode="off")
    gen = torch.Generator().manual_seed(4)
    S = 20
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen)
    frames = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen)
    with torch.no_grad():
        logits_all, _ = forward(cfg, params, ctx,
                                {"tokens": toks, "frames": frames})
        split = S - 4
        lg, cache = prefill(cfg, params, ctx, {"tokens": toks[:, :split],
                                               "frames": frames},
                            cache_budget=S + 4)
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   logits_all[:, split - 1].numpy(),
                                   atol=2e-2, rtol=2e-2)
        for t in range(split, S):
            lg, cache = decode_step(cfg, params, ctx, toks[:, t:t + 1],
                                    cache)
            np.testing.assert_allclose(lg[:, 0].numpy(),
                                       logits_all[:, t].numpy(),
                                       atol=2e-2, rtol=2e-2)


def test_init_cache_has_a_cross_cache(served):
    cfg, tcfg, _, _ = served
    cache = init_cache(tcfg, tqat.make_ctx(POLICY), 3, 40, device="cpu")
    jcache = JB.init_attn_cache(cfg, 3, cfg.encoder_seq)
    for c in cache["layers"]:
        assert c["k_q"].shape == (3, tcfg.n_kv_heads, 40, 16)
        for k in ("k_q", "v_q", "s_k", "s_v", "length"):
            assert tuple(c["cross"][k].shape) == jcache[k].shape, k
        assert c["cross"]["k_q"].dtype == torch.int8


def test_pool_lengths_and_engine_refused(served):
    """The reference's refusals (right-padded and paged prefill, a paged
    cache) and the engine, whose requests carry no frames."""
    cfg, tcfg, params, tp = served
    _, tb = _inputs(cfg, 2, 8, 2)
    ctx = tqat.make_ctx(POLICY)
    with pytest.raises(ValueError, match="encoder"):
        prefill(tcfg, tp, ctx, {**tb, "lengths": torch.tensor([8, 5])})
    with pytest.raises(ValueError, match="encoder"):
        prefill(tcfg, tp, ctx, tb, page_size=16)
    with pytest.raises(ValueError, match="cross-attention"):
        init_cache(tcfg, ctx, 2, 32, device="cpu", num_blocks=8,
                   page_size=16)
    for layout in ("dense", "paged"):
        with pytest.raises(ValueError, match="encoder-decoder"):
            ServeEngine(tcfg, tp, kv_layout=layout, slots=2, cache_len=32,
                        device="cpu")
    with pytest.raises(ValueError):
        jprefill(cfg, params, jqat.make_ctx(POLICY),
                 {"tokens": jnp.zeros((2, 8), jnp.int32),
                  "frames": jnp.zeros((2, cfg.encoder_seq, cfg.d_model)),
                  "lengths": jnp.array([8, 5])})


def test_bridge_and_checkpoint_round_trip(tmp_path):
    """The reference's tree (``encoder/segments/0/0/...``, ``pos_embed``,
    the encoder's ``pos_embed`` and ``final_norm``, LayerNorm biases, the
    decoder's ``ln_x``/``xattn``) splits into the port's tree and stacks
    back bitwise; the port's own init has the reference's tree; a
    checkpoint restores it bitwise."""
    cfg, tcfg = get_reduced_config(ARCH), t_reduced(ARCH)
    params = jinit(cfg, jax.random.PRNGKey(1))
    want = {k: _bits(v) for k, v in bridge.flatten(
        jax.tree.map(np.asarray, params))}
    for k in ("pos_embed/w", "encoder/pos_embed/w", "encoder/final_norm/b",
              "encoder/segments/0/0/mlp/w1/b", "segments/0/0/ln_x/b",
              "segments/0/0/xattn/wq/w", "final_norm/b"):
        assert k in want, k
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    assert len(tp["encoder"]["layers"]) == cfg.encoder_layers
    assert "segments" not in tp["encoder"]
    got = {k: _bits(v) for k, v in bridge.flatten(
        bridge.params_to_numpy(tp, ml_dtypes.bfloat16))}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    own = bridge.params_to_numpy(init_params(tcfg, device="cpu"))
    assert {k: np.shape(v) for k, v in bridge.flatten(own)} == \
        {k: np.shape(v) for k, v in want.items()}
    ck = Checkpointer(str(tmp_path))
    ck.save(2, tp, {"step": 2})
    restored, _ = ck.restore(init_params(tcfg, seed=5, device="cpu"))
    back, orig = dict(bridge.flatten(restored)), dict(bridge.flatten(tp))
    assert back.keys() == orig.keys()
    for k, v in orig.items():
        assert torch.equal(back[k], v), k


def test_merge_act_scales_leaves_the_encoder_alone(served):
    """The reference collects the encoder's statistics under "0attn" and
    "0mlp", keys that do not mirror its params, so merge_act_scales writes
    no encoder activation scale; the port mirrors that. Both packages
    change the same leaves, the decoder's, to the same values."""
    cfg, tcfg, params, tp = served
    policy = "A8s-C8-W4"
    jb, tb = _inputs(cfg, 2, 12, 9)
    with jax.disable_jit():
        _, jaux = jforward(cfg, params, jqat.make_ctx(policy, mode="calib"),
                           jb, collect_stats=True)
        jm = jqat.merge_act_scales(params, [jaux["qstats"]],
                                   parse_policy(policy))
    with torch.no_grad():
        _, taux = forward(tcfg, tp, tqat.make_ctx(policy, mode="calib"), tb,
                          collect_stats=True)
    tm = tqat.merge_act_scales(tp, [taux["qstats"]], t_parse_policy(policy))

    def changed(before, after):
        a = dict(bridge.flatten(before))
        return {k for k, v in bridge.flatten(after)
                if not np.array_equal(_f32(v), _f32(a[k]))}

    jchanged = changed(jax.tree.map(np.asarray, params),
                       jax.tree.map(np.asarray, jm))
    tchanged = changed(bridge.params_to_numpy(tp),
                       bridge.params_to_numpy(tm))
    assert jchanged == tchanged
    assert jchanged and not any(k.startswith("encoder/") for k in jchanged)
    assert "segments/0/0/xattn/wq/s_in" in jchanged
    jflat = dict(bridge.flatten(jax.tree.map(np.asarray, jm)))
    for k, v in bridge.flatten(bridge.params_to_numpy(tm)):
        if k in jchanged:
            np.testing.assert_allclose(np.asarray(v, np.float32),
                                       _f32(jflat[k]), rtol=STAT_RTOL,
                                       err_msg=k)
