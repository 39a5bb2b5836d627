"""The port's xLSTM slice (xlstm-125m) against the JAX package: the
config, the model stack (prefill and decode) and the serve engine; and
the port's mirrors of the reference's xlstm cases (``test_models.py``,
``test_serve_v2.py``, ``test_data_serve.py``, ``test_arch_smoke.py``).
Training, the bridge and checkpoints: ``test_torch_xlstm_train.py``.

Same params (the reference's, bridged), same tokens through both, the
reduced config (2 layers, d 64, pattern (mLSTM, sLSTM)). The reduced
sLSTM's up-projection is int(4/3 * 64) = 85 wide, and neither package
packs an odd d_in into int4, so the w4a8 cases run the same config with
``slstm_proj_factor`` 1.5 (96) on both sides. Tolerances, each with its
reason:

* prefill and decode logits of the whole stack, its cache codes and
  scales, and the engine's logits after one admission, against the
  reference run op by op: bitwise under both weight layouts (measured: 0
  differing logits; the per-token int8 requantizations absorb the
  blocks' f32 ulps at these inputs, see ``tests/test_torch_recurrent.py``
  for the blocks' own bounds); the sLSTM's f32 ``c`` within a few ulps
  (``C_TOL``, the sigmoid and tanh of torch and XLA:CPU);
* greedy streams and counters against the compiled reference engine:
  equal (measured; the streams vary, so equality is not a constant
  stream's), paired with the logit check above;
* f32 params, quantization off (the reference's teacher-forcing logic
  test): prefill and decode logits within 2e-2 of the parallel forward,
  as in the reference; and the port's forward (its teacher route, the
  sLSTM scan with f32 h) within ``F32_RTOL`` of the reference's (measured
  1.4e-7).
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
from repro_torch.core.precision import parse_policy as tparse
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (clone_cache, decode_step, forward,
                                init_cache, init_params, prefill)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig

ARCH = "xlstm-125m"
POLICY = "A8d-C8-W4"
C_TOL = dict(rtol=4e-7, atol=3e-7)
F32_RTOL = 2e-6
ENGINE = dict(slots=2, cache_len=32, decode_block=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(layout):
    cfg, tcfg = get_reduced_config(ARCH), t_reduced(ARCH)
    if layout == "w4a8":
        cfg = cfg.replace(slstm_proj_factor=1.5)
        tcfg = tcfg.replace(slstm_proj_factor=1.5)
    return cfg, tcfg


def _port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def served():
    out = {}
    for layout in ("bf16", "w4a8"):
        cfg, tcfg = _configs(layout)
        params = jqat.calibrate_weight_scales(
            jinit(cfg, jax.random.PRNGKey(0)), parse_policy(POLICY))
        out[layout] = (cfg, tcfg, params, _port(params))
    return out


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


# --------------------------------------------------------------------------
# config (the xlstm rows of test_arch_smoke.py)
# --------------------------------------------------------------------------

def test_config_dims_and_long_context():
    cfg = t_get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (12, 768, 4, 4, 0, 50_304)
    assert cfg.supports_long_context
    assert not t_get_config("qwen2.5-3b").supports_long_context
    ref = get_config(ARCH)
    for c, r in ((cfg, ref), (t_reduced(ARCH), get_reduced_config(ARCH))):
        assert c.layer_kinds() == r.layer_kinds()
        for f in ("d_model", "n_heads", "head_dim", "vocab_size",
                  "mlstm_proj_factor", "slstm_proj_factor", "block_pattern",
                  "tie_embeddings", "norm_eps"):
            assert getattr(c, f) == getattr(r, f), f
    assert cfg.layer_kinds() == ("mlstm",) * 5 + ("slstm",) + \
        ("mlstm",) * 5 + ("slstm",)


# --------------------------------------------------------------------------
# the model stack
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["bf16", "w4a8"])
def test_prefill_and_decode_match_op_by_op_reference(served, layout):
    cfg, tcfg, params, tp = served[layout]
    jp = params
    if layout == "w4a8":
        jp = jqat.attach_w4a8_exports(params, parse_policy(POLICY))
        tp = tqat.attach_w4a8_exports(tp, tparse(POLICY))
    jctx = jqat.make_ctx(POLICY, weights_layout=layout, w4a8_backend="ref")
    tctx = tqat.make_ctx(POLICY, weights_layout=layout)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (3, 20)).astype(np.int32)
    with jax.disable_jit():
        jl, jc = jax_prefill(cfg, jp, jctx, {"tokens": jnp.asarray(toks)},
                             cache_budget=32)
        feed = [np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
                [:, None]]
        ref = [(jl, jc)]
        for i in range(3):
            jl, jc = jax_decode_step(cfg, jp, jctx, jnp.asarray(feed[-1]),
                                     jc)
            ref.append((jl, jc))
            feed.append((feed[-1] * 7 + i + 1) % cfg.vocab_size)
    tl, tc = prefill(tcfg, tp, tctx, {"tokens": torch.from_numpy(toks)},
                     cache_budget=32)
    for step, (jl, jc) in enumerate(ref):
        if step:
            tl, tc = decode_step(tcfg, tp, tctx,
                                 torch.from_numpy(feed[step - 1]), tc)
        np.testing.assert_array_equal(_f32(tl), _f32(jl),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(tc["position"].numpy(),
                                      np.asarray(jc["position"]))
        for i, layer in enumerate(tc["layers"]):
            jlayer = jc["segments"][0][str(i)]
            for k, v in layer.items():
                check = (np.testing.assert_array_equal if k != "c" else
                         lambda a, b, err_msg: np.testing.assert_allclose(
                             a, b, err_msg=err_msg, **C_TOL))
                check(_f32(v), _f32(jlayer[k][0]), err_msg=f"{step} {i} {k}")


def test_decode_matches_teacher_forcing():
    """The reference's logic test (f32 params, quantization off, C16):
    prefill + 4 teacher-forced decode steps against the parallel forward;
    and the port's forward against the reference's."""
    cfg, tcfg = _configs("bf16")
    params = jinit(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = _port(params)
    ctx = tqat.make_ctx("A16-C16-W16", mode="off")
    B, S = 1, 24
    tokens = jax.random.randint(jax.random.PRNGKey(0), (B, S), 0,
                                cfg.vocab_size)
    tt = torch.from_numpy(np.array(tokens))
    with torch.no_grad():
        logits_all, _ = forward(tcfg, tp, ctx, {"tokens": tt})
        split = S - 4
        lg_p, cache = prefill(tcfg, tp, ctx, {"tokens": tt[:, :split]},
                              cache_budget=S + 4)
        np.testing.assert_allclose(_f32(lg_p[:, 0]),
                                   _f32(logits_all[:, split - 1]),
                                   atol=2e-2, rtol=2e-2)
        for t in range(split, S):
            lg_d, cache = decode_step(tcfg, tp, ctx, tt[:, t:t + 1], cache)
            np.testing.assert_allclose(_f32(lg_d[:, 0]),
                                       _f32(logits_all[:, t]),
                                       atol=2e-2, rtol=2e-2)
    with jax.disable_jit():
        want, _ = jforward(cfg, params, jqat.make_ctx("A16-C16-W16",
                                                      mode="off"),
                           {"tokens": tokens})
    assert _rel(logits_all, want) <= F32_RTOL


def test_lengths_and_paged_refused_on_recurrent_arch(served):
    """Right-padded prefill and the paged pool need an attention-only
    decoder (a scan folds padding into its state), as in the reference;
    speculative decoding and optimistic admission need the pool."""
    cfg, tcfg, params, tp = served["bf16"]
    ctx = tqat.make_ctx(POLICY)
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention-only"):
        prefill(tcfg, tp, ctx, {"tokens": toks,
                                "lengths": torch.tensor([4, 8])},
                cache_budget=16)
    with pytest.raises(ValueError, match="attention-only"):
        prefill(tcfg, tp, ctx, {"tokens": toks}, page_size=16)
    with pytest.raises(ValueError, match="full-attention"):
        init_cache(tcfg, ctx, 2, 32, device="cpu", num_blocks=8,
                   page_size=16)
    with pytest.raises(ValueError, match="full-attention"):
        ServeEngine(tcfg, tp, kv_layout="paged", device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="full-attention"):
        ServeEngine(tcfg, tp, kv_layout="paged", spec=SpecConfig(k=2),
                    admission="optimistic", device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, tp, spec=SpecConfig(k=2), device="cpu", **ENGINE)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _prompts(cfg, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _serve(eng, cls, prompts, max_new_tokens=5):
    reqs = [cls(uid=i, prompt=p, max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    return [r.generated for r in reqs], stats


@pytest.mark.parametrize("layout", ["bf16", "w4a8"])
def test_engine_matches_reference(served, layout):
    cfg, tcfg, params, tp = served[layout]

    def engines():
        return (JServeEngine(cfg, params, weights_layout=layout,
                             w4a8_backend="ref", **ENGINE),
                ServeEngine(tcfg, tp, weights_layout=layout, device="cpu",
                            **ENGINE))

    prompts = _prompts(cfg, (6, 9, 6, 9, 6))
    jeng, teng = engines()
    assert not teng._pad_ok and not teng._cache_bound
    ref, ref_stats = _serve(jeng, JRequest, prompts)
    got, stats = _serve(teng, Request, prompts)
    assert got == ref
    assert len({tuple(s) for s in got}) > 1          # not one constant stream
    for k in ("tokens_out", "decode_steps", "prefill_calls",
              "prompt_tokens_prefilled", "requests_finished"):
        assert stats[k] == ref_stats[k], k
    assert stats["prefill_calls"] == 3               # exact-length groups

    # one decode step's logits from each engine's post-admission state
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


def test_recurrent_arch_exact_length_admission():
    """Recurrent archs cannot absorb padding: admission groups equal
    lengths, and everything still drains (test_serve_v2.py's case)."""
    tcfg = t_reduced(ARCH)
    eng = ServeEngine(tcfg, init_params(tcfg, seed=0, device="cpu"),
                      slots=2, cache_len=32, device="cpu")
    assert not eng._pad_ok
    reqs = [Request(uid=i, prompt=np.arange(n, dtype=np.int32),
                    max_new_tokens=3) for i, n in enumerate((4, 6, 4))]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert all(len(r.generated) == 3 for r in reqs)
    assert stats["tokens_out"] == 9
    assert stats["prefill_calls"] == 2               # {4, 4}, then {6}


def test_slot_reuse():
    """One slot serves three requests in turn (test_data_serve.py's
    case); a prompt beyond cache_len is admitted, since recurrent state
    does not grow with the context."""
    tcfg = t_reduced(ARCH)
    eng = ServeEngine(tcfg, init_params(tcfg, seed=0, device="cpu"),
                      slots=1, cache_len=32, device="cpu")
    for i in range(3):
        eng.submit(Request(uid=i, prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=2))
    eng.submit(Request(uid=3, prompt=np.arange(40, dtype=np.int32) % 256,
                       max_new_tokens=2))
    stats = eng.run_until_drained()
    # each request: 1 token from prefill + 1 decoded token
    assert stats["tokens_out"] == 8


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = serve_main(["--arch", ARCH, "--device", "cpu", "--requests",
                            "4", "--slots", "2", "--vary-prompts",
                            "--max-new", "4"])
    assert stats["tokens_out"] == 16
    assert "arch=xlstm-125m-reduced" in out.getvalue()
