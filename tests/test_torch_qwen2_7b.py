"""The port's qwen2-7b slice (a dense GQA decoder with QKV bias and an
untied head, G 7 at full width) against the JAX package: the config,
the forward, prefill and decode, the dense engine under w4a8 (the untied
head packed at 8 bits), the plain w4a8 version at the long K of its
down projection, and the serve and train CLIs.

Same params (the reference's, calibrated, bridged), same tokens; the
JAX side runs op by op (``jax.disable_jit``). The reduced config is the
reference's (2 layers, d 64, 4 heads on 2, head dim 16, d_ff 128).
Tolerances: the forward's logits within one bf16 ulp or ``FWD_ATOL``,
at most ``FWD_SHARE`` differing (a bf16 GEMM near a tie, as
``test_torch_mixtral.py`` holds it); prefill, decode, the engine's
streams and one engine decode step's logits: bitwise (measured); the
w4a8 integer accumulator: exact.
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
from repro.kernels.w4a8 import ref as jw4ref
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
from repro_torch.core.precision import parse_policy as t_parse_policy
from repro_torch.kernels.w4a8.ref import (K_SLICE, w4a8_accumulate_ref,
                                          w4a8_matmul_ref)
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import clone_cache, decode_step, forward, prefill
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "qwen2-7b"
POLICY = "A8d-C8-W4"
FWD_SHARE = 1e-3
FWD_ATOL = 1e-6
ENGINE = dict(slots=2, cache_len=64, decode_block=4)


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


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_for_field(reduced):
    c = t_reduced(ARCH) if reduced else t_get_config(ARCH)
    r = get_reduced_config(ARCH) if reduced else get_config(ARCH)
    for f in dataclasses.fields(c):
        assert getattr(c, f.name) == getattr(r, f.name), f.name
    assert c.qkv_bias and not c.tie_embeddings and not c.qk_norm
    if not reduced:
        assert (c.resolved_head_dim, c.n_heads // c.n_kv_heads,
                c.kv_dim) == (128, 7, 512)


def test_forward_matches_op_by_op_reference(served):
    cfg, tcfg, params, tp = served
    toks = _tokens(cfg, (2, 30), 1)
    with jax.disable_jit():
        want, _ = jforward(cfg, params, jqat.make_ctx(POLICY),
                           {"tokens": jnp.asarray(toks)})
    got, _ = forward(tcfg, tp, tqat.make_ctx(POLICY),
                     {"tokens": torch.from_numpy(toks)})
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=FWD_ATOL)
    assert np.mean(g != w) <= FWD_SHARE


@pytest.mark.parametrize("layout", ["bf16", "w4a8"])
def test_prefill_and_decode_match_reference(served, layout):
    """A padded wave and 3 decode steps, through the bf16 linears and
    through the w4a8 exports (the untied head packed): logits and the
    cache codes bitwise."""
    cfg, tcfg, params, tp = served
    jctx = jqat.make_ctx(POLICY, weights_layout=layout, w4a8_backend="ref")
    tctx = tqat.make_ctx(POLICY, weights_layout=layout)
    if layout == "w4a8":
        params = jqat.attach_w4a8_exports(params, parse_policy(POLICY))
        tp = tqat.attach_w4a8_exports(tp, t_parse_policy(POLICY))
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
    for k in ("k_q", "v_q", "s_v"):
        np.testing.assert_array_equal(
            _f32(tc["layers"][1][k]),
            _f32(jc["segments"][0]["0"]["self"][k][1]), err_msg=k)


def test_engine_matches_reference(served):
    """Dense w4a8 serving (padded admission waves, the untied head packed)
    against the reference engine run op by op: greedy streams and
    counters, and one decode step's logits after an admission, bitwise;
    the same streams from a tree whose bf16 linears were dropped and whose
    exports were attached again."""
    cfg, tcfg, params, tp = served
    prompts = [_tokens(cfg, n, 11 + n) for n in (30, 9, 28)]

    def run(eng, cls):
        reqs = [cls(uid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained()
        return [r.generated for r in reqs], stats

    teng = ServeEngine(tcfg, tp, weights_layout="w4a8", device="cpu",
                       **ENGINE)
    got, st = run(teng, Request)
    jeng = JServeEngine(cfg, params, weights_layout="w4a8",
                        w4a8_backend="ref", **ENGINE)
    with jax.disable_jit():
        ref, rst = run(jeng, JRequest)
    assert got == ref
    for k in ("tokens_out", "decode_steps", "prefill_calls"):
        assert st[k] == rst[k], k
    dropped = ServeEngine(tcfg, tqat.drop_exported_weights(teng.params),
                          weights_layout="w4a8", device="cpu", **ENGINE)
    assert "w" not in dropped.params["head"]
    assert run(dropped, Request)[0] == got

    jeng = JServeEngine(cfg, params, weights_layout="w4a8",
                        w4a8_backend="ref", **ENGINE)
    teng = ServeEngine(tcfg, tp, weights_layout="w4a8", device="cpu",
                       **ENGINE)
    for i, p in enumerate(prompts[:2]):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=5))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    with jax.disable_jit():
        jeng._admit()
        jlogits, _ = jax_decode_step(cfg, jeng.params, jeng.ctx,
                                     jeng.state["tokens"],
                                     jeng.state["cache"])
    teng._admit()
    tlogits, _ = decode_step(tcfg, teng.params, teng.ctx,
                             teng.state["tokens"],
                             clone_cache(teng.state["cache"]))
    np.testing.assert_array_equal(_f32(tlogits), _f32(jlogits))


@pytest.mark.parametrize("K", [K_SLICE, 18944])
def test_w4a8_accumulator_at_the_down_projection_s_k(K):
    """The plain w4a8 version sums a K past 16512 in exact fp32 slices
    (qwen2-7b's down projection: K 18944): the int32 accumulator equals
    the exact int64 product and the reference's, and the scaled output
    the reference's bitwise."""
    rng = np.random.default_rng(K)
    M, N = 5, 24
    x_q = rng.integers(-127, 128, (M, K)).astype(np.int8)
    x_q[0] = 127                              # the largest partial sums
    w_p = rng.integers(0, 256, (N, K // 2)).astype(np.uint8)
    w_p[0] = 0x77                             # int4 7 in both nibbles
    s_x = (rng.random((M, 1)) * 0.05 + 1e-3).astype(np.float32)
    s_w = (rng.random(N) * 0.05 + 1e-3).astype(np.float32)
    tx, tw = torch.from_numpy(x_q), torch.from_numpy(w_p)
    acc = w4a8_accumulate_ref(tx, tw)
    lo = (w_p & 0xF).astype(np.int64)
    hi = (w_p >> 4).astype(np.int64)
    w_i = np.stack([np.where(lo > 7, lo - 16, lo),
                    np.where(hi > 7, hi - 16, hi)], -1).reshape(N, K)
    exact = x_q.astype(np.int64) @ w_i.T
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), exact)
    assert int(exact[0, 0]) == 127 * 7 * K
    want = jw4ref.w4a8_matmul_ref(jnp.asarray(x_q), jnp.asarray(w_p),
                                  jnp.asarray(s_x), jnp.asarray(s_w))
    got = w4a8_matmul_ref(tx, tw, torch.from_numpy(s_x),
                          torch.from_numpy(s_w))
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = serve_main(["--arch", ARCH, "--device", "cpu", "--requests",
                            "4", "--slots", "2", "--vary-prompts",
                            "--max-new", "4", "--weights", "w4a8"])
    assert stats["tokens_out"] == 16
    assert "arch=qwen2-7b-reduced" in out.getvalue()


def test_train_cli_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                    "--teacher-steps", "2", "--batch-size", "2",
                    "--seq-len", "24"])
    lines = [ln for ln in out.getvalue().splitlines() if "kd-loss" in ln]
    assert [ln.split(":")[0].strip() for ln in lines] == ["step 0", "step 1"]
