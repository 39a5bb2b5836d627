"""The port's mixtral slice (mixtral-8x7b: top-2 MoE with capacity
dispatch, sliding-window attention on rings) against the JAX package: the
config, the model stack (forward, prefill and decode through a ring that
wraps), the serve engine, the w4a8 export of an MoE tree and the serve
CLI. Training, PTQ and the rotation on the MoE tree:
``test_torch_mixtral_train.py``; the MoE block alone:
``test_torch_moe.py``.

Same params (the reference's, calibrated, bridged), same tokens through
both, the reduced config (2 layers, d 64, 4 experts, top 2, d_ff 64,
window 32, head dim 16, 4 query heads on 2 KV heads); the JAX side runs
op by op (``jax.disable_jit``). Tolerances, each with its reason:

* prefill and decode logits and every cache leaf (the rings' int8 K/V
  and scales) through 4 decode steps past the 32-token window, padded
  prefill waves, the engine's greedy streams against the reference
  engine run op by op, and one decode step's logits after an admission:
  bitwise (measured);
* the forward's logits within one bf16 ulp (rtol 2^-7) or ``FWD_ATOL``,
  at most ``FWD_SHARE`` of them differing at all: a bf16 GEMM whose f32
  accumulator lands near a bf16 tie rounds one ulp apart in XLA's dot and
  torch's GEMM (ROADMAP, Queue 3 properties; measured at S 40: 1 value
  of 20480, 2.4e-7 apart), and its ``moe_aux`` within ``AUX_RTOL`` (the
  f32 means' summation order, ``test_torch_moe.py``);
* the mirror of the reference's teacher-forcing test (capacity factor
  100, f32 params, quantization off): its own 2e-2.
"""
import contextlib
import dataclasses
import io

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
from repro.models import init_params as jinit
from repro.models import prefill as jax_prefill
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import qat as tqat
from repro_torch.core.precision import parse_policy as t_parse_policy
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (clone_cache, decode_step, forward,
                                init_cache, init_params, prefill)
from repro_torch.models import blocks as TB
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "mixtral-8x7b"
POLICY = "A8d-C8-W4"
AUX_RTOL = 1e-6
FWD_SHARE = 1e-3
FWD_ATOL = 1e-6
ENGINE = dict(slots=2, cache_len=64, decode_block=4)


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
    """Every field the port's ModelConfig has equals the reference's."""
    c = t_reduced(ARCH) if reduced else t_get_config(ARCH)
    r = get_reduced_config(ARCH) if reduced else get_config(ARCH)
    for f in dataclasses.fields(c):
        assert getattr(c, f.name) == getattr(r, f.name), f.name
    assert c.is_moe and c.supports_long_context
    assert c.layer_kinds() == r.layer_kinds()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch):
    for c, r in ((t_get_config(arch), get_config(arch)),
                 (t_reduced(arch), get_reduced_config(arch))):
        assert c.param_counts() == r.param_counts()
    full = t_get_config(ARCH).param_counts()
    assert full["total"] == 46_702_526_464
    assert full["active"] == 12_879_659_008


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
    assert float(aux["moe_aux"]) > 0.0


def _layer_ref(jc, i):
    return {k: v[i] for k, v in jc["segments"][0]["0"]["self"].items()}


def test_prefill_and_decode_through_a_wrapping_ring(served):
    """A 30-token prompt, then 4 decode steps: the 32-row ring (the
    window) wraps at step 2. Logits and every cache leaf of every layer
    at every step: bitwise."""
    cfg, tcfg, params, tp = served
    jctx, tctx = jqat.make_ctx(POLICY), tqat.make_ctx(POLICY)
    toks = _tokens(cfg, (2, 30), 7)
    with jax.disable_jit():
        jl, jc = jax_prefill(cfg, params, jctx, {"tokens": jnp.asarray(toks)},
                             cache_budget=48)
        feed = [np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
                [:, None]]
        ref = [(jl, jc)]
        for i in range(4):
            jl, jc = jax_decode_step(cfg, params, jctx,
                                     jnp.asarray(feed[-1]), jc)
            ref.append((jl, jc))
            feed.append((feed[-1] * 7 + i + 1) % cfg.vocab_size)
    tl, tc = prefill(tcfg, tp, tctx, {"tokens": torch.from_numpy(toks)},
                     cache_budget=48)
    assert tc["layers"][0]["k_q"].shape == (2, 2, cfg.sliding_window, 16)
    for step, (jl, jc) in enumerate(ref):
        if step:
            tl, tc = decode_step(tcfg, tp, tctx,
                                 torch.from_numpy(feed[step - 1]), tc)
        np.testing.assert_array_equal(_f32(tl), _f32(jl),
                                      err_msg=f"step {step}")
        for i, layer in enumerate(tc["layers"]):
            jlayer = _layer_ref(jc, i)
            assert layer.keys() == jlayer.keys()
            for k, v in layer.items():
                np.testing.assert_array_equal(
                    _f32(v), _f32(jlayer[k]), err_msg=f"{step} {i} {k}")
    assert int(tc["layers"][0]["length"][0]) == 34 > cfg.sliding_window


def test_padded_prefill_matches_reference(served):
    """A right-padded wave of two prompts (capacity from the padded
    length, as in the reference): logits at each row's last real token
    and the rings bitwise."""
    cfg, tcfg, params, tp = served
    jctx, tctx = jqat.make_ctx(POLICY), tqat.make_ctx(POLICY)
    toks = _tokens(cfg, (2, 30), 9)
    lens = np.array([17, 30], np.int32)
    with jax.disable_jit():
        jl, jc = jax_prefill(cfg, params, jctx,
                             {"tokens": jnp.asarray(toks),
                              "lengths": jnp.asarray(lens)},
                             cache_budget=48)
    tl, tc = prefill(tcfg, tp, tctx, {"tokens": torch.from_numpy(toks),
                                      "lengths": torch.from_numpy(lens)},
                     cache_budget=48)
    np.testing.assert_array_equal(_f32(tl), _f32(jl))
    for i, layer in enumerate(tc["layers"]):
        for k, v in _layer_ref(jc, i).items():
            np.testing.assert_array_equal(_f32(layer[k]), _f32(v), err_msg=k)


def test_paged_layout_refused_for_the_window(served):
    """The paged pool needs full attention: a sliding window is refused,
    as in the reference, so neither the pool nor spec decoding apply."""
    _, tcfg, _, tp = served
    ctx = tqat.make_ctx(POLICY)
    with pytest.raises(ValueError, match="full-attention"):
        init_cache(tcfg, ctx, 2, 64, device="cpu", num_blocks=8,
                   page_size=16)
    with pytest.raises(ValueError, match="full-attention"):
        ServeEngine(tcfg, tp, kv_layout="paged", device="cpu", **ENGINE)


def test_moe_routing_active():
    """The reference's ``test_moe_routing_active`` on the port: MoE
    models route through several experts (aux > 0)."""
    cfg = t_reduced(ARCH)
    params = init_params(cfg, seed=1, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _, aux = forward(cfg, params, tqat.make_ctx(POLICY),
                         {"tokens": toks})
    assert float(aux["moe_aux"]) > 0.0


def test_swa_bounds_cache():
    """The reference's ``test_swa_bounds_cache``: the sliding window
    bounds a global layer's decode ring, not cache_len."""
    cfg = t_reduced(ARCH)
    cache = init_cache(cfg, tqat.make_ctx(POLICY), 2, 1000, device="cpu")
    assert cache["layers"][0]["k_q"].shape[2] == cfg.sliding_window


def test_decode_matches_teacher_forcing(monkeypatch):
    """The reference's ``test_decode_matches_teacher_forcing`` for mixtral
    on the port: unbounded capacity (dropping makes MoE prefill
    prefix-inconsistent by design), f32 params, quantization off; greedy
    decode over the cache matches the parallel forward at each position
    to the reference test's 2e-2."""
    monkeypatch.setattr(TB, "MOE_CAPACITY_FACTOR", 100.0)
    cfg = t_reduced(ARCH)
    params = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    ctx = tqat.make_ctx("A16-C16-W16", mode="off")
    S = 24
    toks = torch.randint(0, cfg.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        logits_all, _ = forward(cfg, params, ctx, {"tokens": toks})
        split = S - 4
        lg, cache = prefill(cfg, params, ctx, {"tokens": toks[:, :split]},
                            cache_budget=S + 4)
        np.testing.assert_allclose(_f32(lg[:, 0]),
                                   _f32(logits_all[:, split - 1]),
                                   atol=2e-2, rtol=2e-2)
        for t in range(split, S):
            lg, cache = decode_step(cfg, params, ctx, toks[:, t:t + 1],
                                    cache)
            np.testing.assert_allclose(_f32(lg[:, 0]),
                                       _f32(logits_all[:, t]),
                                       atol=2e-2, rtol=2e-2)


# --------------------------------------------------------------------------
# the w4a8 export of an MoE tree
# --------------------------------------------------------------------------

def test_w4a8_export_skips_banks_and_packs_the_router(served):
    """``attach_w4a8_exports`` skips the expert banks next to a router and
    packs the router at the body's 4 bits, as the reference does:
    the packed codes and scales bitwise; ``drop_exported_weights`` keeps
    the banks' weights; the byte accounting equals the reference's."""
    cfg, tcfg, params, tp = served
    jexp = jqat.attach_w4a8_exports(params, parse_policy(POLICY))
    texp = tqat.attach_w4a8_exports(tp, t_parse_policy(POLICY))
    for i, layer in enumerate(texp["layers"]):
        moe = layer["moe"]
        jmoe = jax.tree.map(lambda a: a[i], jexp["segments"][0]["0"]["moe"])
        for k in ("wg", "wu", "wd"):
            assert "w4a8" not in moe[k] and "w4a8" not in jmoe[k]
        for k in ("wq", "s_w"):
            np.testing.assert_array_equal(
                _f32(moe["router"]["w4a8"][k]),
                np.asarray(jmoe["router"]["w4a8"][k], np.float32), err_msg=k)
    kept = tqat.drop_exported_weights(texp)
    assert "w" not in kept["layers"][0]["moe"]["router"]
    assert all("w" in kept["layers"][0]["moe"][k] for k in ("wg", "wu", "wd"))
    assert "w" not in kept["layers"][0]["attn"]["wq"]
    assert tqat.w4a8_weight_bytes(texp) == jqat.w4a8_weight_bytes(jexp)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _serve(eng, cls, prompts, max_new_tokens):
    reqs = [cls(uid=i, prompt=p, max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    return [r.generated for r in reqs], stats


@pytest.mark.parametrize("layout", ["bf16", "w4a8"])
def test_engine_matches_reference(served, layout):
    """Padded admission waves (mixtral is attention-only), two prompts
    whose 32-row rings wrap while they decode, greedy streams and
    counters equal to the reference engine's run op by op, and one decode
    step's logits after an admission bitwise."""
    cfg, tcfg, params, tp = served
    prompts = [_tokens(cfg, n, 11 + n) for n in (30, 9, 28, 14)]

    def engines():
        return (JServeEngine(cfg, params, weights_layout=layout,
                             w4a8_backend="ref", **ENGINE),
                ServeEngine(tcfg, tp, weights_layout=layout, device="cpu",
                            **ENGINE))

    jeng, teng = engines()
    assert teng._pad_ok and not teng._cache_bound
    got, stats = _serve(teng, Request, prompts, max_new_tokens=6)
    with jax.disable_jit():
        ref, ref_stats = _serve(jeng, JRequest, prompts, max_new_tokens=6)
    assert got == ref
    for k in ("tokens_out", "decode_steps", "prefill_calls",
              "prompt_tokens_prefilled", "requests_finished"):
        assert stats[k] == ref_stats[k], k

    jeng, teng = engines()
    for i, p in enumerate(prompts[:2]):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=5))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    with jax.disable_jit():
        jeng._admit()
        jlogits, _ = jax_decode_step(cfg, jeng.params, jeng.ctx,
                                     jeng.state["tokens"],
                                     jeng.state["cache"])
    teng._admit()
    assert sorted(teng._slot_req) == sorted(jeng._slot_req)
    tlogits, _ = decode_step(tcfg, teng.params, teng.ctx,
                             teng.state["tokens"],
                             clone_cache(teng.state["cache"]))
    np.testing.assert_array_equal(_f32(tlogits), _f32(jlogits))


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = serve_main(["--arch", ARCH, "--device", "cpu", "--requests",
                            "4", "--slots", "2", "--vary-prompts",
                            "--prompt-len", "40", "--max-new", "4",
                            "--weights", "w4a8"])
    assert stats["tokens_out"] == 16
    assert "arch=mixtral-8x7b-reduced" in out.getvalue()


def test_capacity_constants_are_the_reference_s():
    assert TB.MOE_CAPACITY_FACTOR == JB.MOE_CAPACITY_FACTOR
    assert TB.MOE_CHUNK_S == JB.MOE_CHUNK_S
