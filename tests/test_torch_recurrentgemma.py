"""The port's recurrentgemma slice (recurrentgemma-2b: RG-LRU and local
attention, 2 : 1) against the JAX package: the config, the model stack
(forward, prefill and decode through a ring that wraps), the serve engine
and the serve CLI. Training, SmoothQuant's fold and the bridge of the
26-layer stack: ``test_torch_recurrentgemma_train.py``; the RG-LRU block
alone and the kernels' plain versions at this architecture's shapes:
``test_torch_rglru.py``.

Same params (the reference's, bridged), same tokens through both, the
reduced config (3 layers, d 64, local window 16, head dim 16, 4 query
heads on 1 KV head) and the same at 5 layers (a full pattern and a
2-layer remainder segment); the JAX side runs op by op
(``jax.disable_jit``). On the CPU the port's RG-LRU evaluates its gates
with XLA:CPU's exp, tanh, logistic, log1p and sqrt
(``models/recurrent.py``), so those are bitwise too. Tolerances, each
with its reason:

* prefill and decode logits and every cache leaf (the rings' int8 K/V
  and scales, the RG-LRU's ``state_q`` codes, ``s_state`` and
  ``conv_buf``) through 10 decode steps past the 16-token window, the
  engine's greedy streams against the reference engine run op by op, and
  one decode step's logits after an admission: bitwise (measured);
* forward logits within one bf16 ulp (rtol 2^-7) or ``FWD_ATOL`` for
  logits near zero, at most ``FWD_SHARE`` of them differing at all: a
  bf16 GEMM whose f32 accumulator lands near a bf16 tie rounds one ulp
  apart in XLA's dot and torch's GEMM (ROADMAP, Queue 3 properties), and
  a logit near zero keeps the head's f32 reorder gap (64 terms, at most
  about 1e-7 here); measured 1 value of 6144 at 3 and at 5 layers, 3e-8
  and 1.5e-8 apart.

The compiled reference disagrees with its own op-by-op run here (its
fused gates), so no stream is compared with it.
"""
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jax_prefill
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import qat as tqat
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (clone_cache, decode_step, forward,
                                init_cache, prefill)
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "recurrentgemma-2b"
POLICY = "A8d-C8-W4"
PERIOD = 3                       # the block pattern's length
FWD_SHARE = 1e-3
FWD_ATOL = 1e-6
ENGINE = dict(slots=2, cache_len=32, decode_block=4)


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


def _rel(got, want):
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _configs(n_layers=3):
    return (get_reduced_config(ARCH).replace(n_layers=n_layers),
            t_reduced(ARCH).replace(n_layers=n_layers))


@pytest.fixture(scope="module")
def served():
    cfg, tcfg = _configs()
    params = jqat.calibrate_weight_scales(jinit(cfg, jax.random.PRNGKey(0)),
                                          parse_policy(POLICY))
    return cfg, tcfg, params, _port(params)


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

def test_config_dims_and_pattern():
    cfg = t_get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.local_window, cfg.resolved_lru_width) == \
        (26, 2560, 10, 1, 256, 7680, 256_000, 2048, 2560)
    assert cfg.supports_long_context and cfg.tie_embeddings
    kinds = cfg.layer_kinds()
    assert kinds.count("rglru") == 18 and kinds.count("local_attn") == 8
    for c, r in ((cfg, get_config(ARCH)),
                 (t_reduced(ARCH), get_reduced_config(ARCH))):
        assert c.layer_kinds() == r.layer_kinds()
        for f in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "local_window", "lru_width", "conv1d_width",
                  "block_pattern", "tie_embeddings", "rope_theta",
                  "norm_eps", "sliding_window"):
            assert getattr(c, f) == getattr(r, f), f


# --------------------------------------------------------------------------
# the model stack
# --------------------------------------------------------------------------

def _layer_ref(jc, cfg, i):
    """Layer i's cache leaves in the reference's segmented tree."""
    n_full = cfg.n_layers // PERIOD * PERIOD
    if i < n_full:
        lay, r = jc["segments"][0][str(i % PERIOD)], i // PERIOD
    else:
        lay, r = jc["segments"][1 if n_full else 0][str(i - n_full)], 0
    lay = lay.get("self", lay)
    return {k: v[r] for k, v in lay.items()}


@pytest.mark.parametrize("n_layers", [3, 5])
def test_forward_matches_op_by_op_reference(n_layers):
    cfg, tcfg = _configs(n_layers)
    params = jqat.calibrate_weight_scales(jinit(cfg, jax.random.PRNGKey(2)),
                                          parse_policy(POLICY))
    tp = _port(params)
    assert len(tp["layers"]) == n_layers
    toks = np.random.default_rng(n_layers).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    with jax.disable_jit():
        want, _ = jforward(cfg, params, jqat.make_ctx(POLICY),
                           {"tokens": jnp.asarray(toks)})
    got, _ = forward(tcfg, tp, tqat.make_ctx(POLICY),
                     {"tokens": torch.from_numpy(toks)})
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=FWD_ATOL)
    assert np.mean(g != w) <= FWD_SHARE


def test_prefill_and_decode_through_a_wrapping_ring(served):
    """A 12-token prompt, then 10 decode steps: the local layer's ring of
    16 rows (the window) wraps at step 4. Logits and every cache leaf of
    every layer at every step: bitwise."""
    cfg, tcfg, params, tp = served
    jctx, tctx = jqat.make_ctx(POLICY), tqat.make_ctx(POLICY)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    with jax.disable_jit():
        jl, jc = jax_prefill(cfg, params, jctx, {"tokens": jnp.asarray(toks)},
                             cache_budget=40)
        feed = [np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
                [:, None]]
        ref = [(jl, jc)]
        for i in range(10):
            jl, jc = jax_decode_step(cfg, params, jctx,
                                     jnp.asarray(feed[-1]), jc)
            ref.append((jl, jc))
            feed.append((feed[-1] * 7 + i + 1) % cfg.vocab_size)
    tl, tc = prefill(tcfg, tp, tctx, {"tokens": torch.from_numpy(toks)},
                     cache_budget=40)
    ring = tc["layers"][2]
    assert ring["k_q"].shape == (2, 1, cfg.local_window, 16)
    assert set(tc["layers"][0]) == {"state_q", "s_state", "conv_buf"}
    for step, (jl, jc) in enumerate(ref):
        if step:
            tl, tc = decode_step(tcfg, tp, tctx,
                                 torch.from_numpy(feed[step - 1]), tc)
        np.testing.assert_array_equal(_f32(tl), _f32(jl),
                                      err_msg=f"step {step}")
        for i, layer in enumerate(tc["layers"]):
            jlayer = _layer_ref(jc, cfg, i)
            assert layer.keys() == jlayer.keys()
            for k, v in layer.items():
                np.testing.assert_array_equal(
                    _f32(v), _f32(jlayer[k]), err_msg=f"{step} {i} {k}")
    assert int(tc["layers"][2]["length"][0]) == 22 > cfg.local_window


def test_paged_and_padded_prefill_refused(served):
    """The paged pool and right-padded prefill need an attention-only,
    full-attention decoder, as in the reference."""
    _, tcfg, _, tp = served
    ctx = tqat.make_ctx(POLICY)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        prefill(tcfg, tp, ctx, {"tokens": toks,
                                "lengths": torch.tensor([4, 8])},
                cache_budget=16)
    with pytest.raises(ValueError, match="full-attention"):
        init_cache(tcfg, ctx, 2, 32, device="cpu", num_blocks=8,
                   page_size=16)
    with pytest.raises(ValueError, match="full-attention"):
        ServeEngine(tcfg, tp, kv_layout="paged", device="cpu", **ENGINE)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _serve(eng, cls, prompts, max_new_tokens=6):
    reqs = [cls(uid=i, prompt=p, max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    return [r.generated for r in reqs], stats


@pytest.mark.parametrize("layout", ["bf16", "w4a8"])
def test_engine_matches_reference(served, layout):
    """Exact-length admission groups (a recurrent layer would fold padding
    into its state), a 20-token prompt whose ring has wrapped,
    greedy streams and counters equal to the reference engine's run op by
    op (w4a8; the bf16 layout's numerics are the stack's, checked above),
    and one decode step's logits after an admission bitwise."""
    cfg, tcfg, params, tp = served

    def engines():
        return (JServeEngine(cfg, params, weights_layout=layout,
                             w4a8_backend="ref", **ENGINE),
                ServeEngine(tcfg, tp, weights_layout=layout, device="cpu",
                            **ENGINE))

    prompts = _prompts(cfg, (9, 20, 9))
    jeng, teng = engines()
    assert not teng._pad_ok and not teng._cache_bound
    got, stats = _serve(teng, Request, prompts, max_new_tokens=4)
    assert stats["prefill_calls"] == 2               # exact-length groups
    assert len({tuple(s) for s in got}) > 1
    if layout == "w4a8":
        with jax.disable_jit():
            ref, ref_stats = _serve(jeng, JRequest, prompts,
                                    max_new_tokens=4)
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
    assert sorted(teng._slot_req) == sorted(jeng._slot_req) == [0]
    tlogits, _ = decode_step(tcfg, teng.params, teng.ctx,
                             teng.state["tokens"],
                             clone_cache(teng.state["cache"]))
    np.testing.assert_array_equal(_f32(tlogits)[0], _f32(jlogits)[0])


def test_slot_reuse_overwrites_ring_and_state(served):
    """A slot that served a long request, its ring wrapped and its RG-LRU
    state moved, then serves another: admission copies the new prompt's
    ring, state and conv history over every leaf, so the second stream
    and its first decode step equal a fresh engine's."""
    _, tcfg, _, tp = served
    a, b = _prompts(tcfg, (20, 11), seed=9)
    eng = ServeEngine(tcfg, tp, device="cpu", slots=1, cache_len=32)
    first, _ = _serve(eng, Request, [a, b], max_new_tokens=8)
    fresh = ServeEngine(tcfg, tp, device="cpu", slots=1, cache_len=32)
    alone, _ = _serve(fresh, Request, [b], max_new_tokens=8)
    assert first[1] == alone[0]
    for e in (eng, fresh):
        e.submit(Request(uid=7, prompt=b, max_new_tokens=3))
        e._admit()
    for x, y in zip(eng.state["cache"]["layers"],
                    fresh.state["cache"]["layers"]):
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = serve_main(["--arch", ARCH, "--device", "cpu", "--requests",
                            "4", "--slots", "2", "--vary-prompts",
                            "--max-new", "4", "--weights", "w4a8"])
    assert stats["tokens_out"] == 16
    assert "arch=recurrentgemma-2b-reduced" in out.getvalue()
