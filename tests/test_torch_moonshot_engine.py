"""The port's paged engine serving moonshot-v1-16b-a3b (an MoE on the
pool for the first time) against the JAX package's engine: prefix
sharing on and off (hits, COW of the split block, tail-waves) and one
decode step's logits after an admission wave, at the reduced config (2
layers, d 64, 8 experts top 2) under w4a8; the default draft of an MoE
target and the serve CLI on the pool. Optimistic admission and
speculative decoding: ``test_torch_moonshot_spec.py``.

Same params (the reference's, calibrated, bridged) and requests through
both engines; the reference engine runs op by op (``jax.disable_jit``,
``w4a8_backend="ref"``): its compiled run flips a greedy near tie in
the prefix-off run, as ``tests/test_torch_engine.py`` found for
qwen2.5. Streams, counters and the decode step's logits: equal,
bitwise.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jinit
from repro.serve import spec as jspec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import clone_cache, decode_step
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig

ARCH = "moonshot-v1-16b-a3b"
POLICY = "A8d-C8-W4"
PAGED = dict(slots=2, cache_len=64, kv_layout="paged", block_size=16,
             num_blocks=32, max_seq_len=96, decode_block=4)


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


def _prompts(n=3, prefix_len=40, tail=5):
    """n prompts sharing a 40-token prefix (2 full 16-token blocks and a
    split block), each with its own 5-token tail."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 250, prefix_len).astype(np.int32)
    return [np.concatenate([prefix, ((np.arange(tail) * (i + 3) + i) % 250
                                     ).astype(np.int32)]) for i in range(n)]


def _shared(cls, n=2, max_new=4, **kw):
    return [cls(uid=i, prompt=p, max_new_tokens=max_new, **kw)
            for i, p in enumerate(_prompts(n))]


def _drain(eng, reqs, staged=True):
    """The first request warms the prefix cache, the rest follow."""
    if staged:
        eng.submit(reqs[0])
        eng.run_until_drained()
        rest = reqs[1:]
    else:
        rest = reqs
    for r in rest:
        eng.submit(r)
    stats = eng.run_until_drained(max_steps=50_000)
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], stats


def _engines(served, spec=None, **kw):
    cfg, tcfg, params, tp = served
    opts = {**PAGED, **kw}
    jeng = JServeEngine(cfg, params, weights_layout="w4a8",
                        w4a8_backend="ref",
                        spec=None if spec is None else jspec.SpecConfig(
                            **spec), **opts)
    teng = ServeEngine(tcfg, tp, weights_layout="w4a8", device="cpu",
                       spec=None if spec is None else SpecConfig(**spec),
                       **opts)
    return jeng, teng


COUNTERS = ("tokens_out", "decode_steps", "prefill_calls", "prefill_chunks",
            "prefix_hit_tokens", "cow_copies", "prompt_tokens_prefilled")


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_paged_engine_matches_reference(served, prefix_cache):
    """Shared-prefix requests on the pool, prefix sharing on (hits, COW of
    the split block, tail-waves) and off: streams and counters equal to
    the reference engine's."""
    jeng, teng = _engines(served, prefix_cache=prefix_cache)
    got, st = _drain(teng, _shared(Request))
    with jax.disable_jit():
        ref, rst = _drain(jeng, _shared(JRequest))
    assert got == ref
    for k in COUNTERS:
        assert st[k] == rst[k], k
    if prefix_cache:
        assert st["prefix_hit_tokens"] > 0 and st["cow_copies"] > 0
        assert st["tail_waves"] > 0
    teng.alloc.check()
    assert teng.alloc.allocated_blocks == 0


def test_paged_decode_step_logits_match_reference(served):
    """After one admission wave on the pool, one decode step's logits
    through each package's own engine state: bitwise."""
    cfg, tcfg, _, _ = served
    jeng, teng = _engines(served)
    for i, p in enumerate(_prompts(2)):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=5))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    with jax.disable_jit():
        jeng.step()
    teng.step()
    assert sorted(teng._slot_req) == sorted(jeng._slot_req)
    with jax.disable_jit():
        jeng._ensure_decode_blocks()
        jeng._push_tables()
    teng._ensure_decode_blocks()
    teng._push_tables()
    with jax.disable_jit():
        jl, _ = jax_decode_step(cfg, jeng.params, jeng.ctx,
                                jeng.state["tokens"], jeng.state["cache"])
    tl, _ = decode_step(tcfg, teng.params, teng.ctx, teng.state["tokens"],
                        clone_cache(teng.state["cache"]))
    np.testing.assert_array_equal(_f32(tl), _f32(jl))


def test_default_draft_is_half_the_moe_target(served):
    _, tcfg, _, tp = served
    eng = ServeEngine(tcfg, tp, device="cpu", spec=SpecConfig(k=4),
                      **PAGED)
    assert eng.draft_cfg.n_layers == tcfg.n_layers // 2
    assert eng.draft_params["layers"] == tp["layers"][:1]
    assert t_get_config(ARCH).n_layers // 2 == 24


def test_serve_cli_paged_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = serve_main(["--arch", ARCH, "--device", "cpu", "--requests",
                            "4", "--slots", "2", "--kv-layout", "paged",
                            "--max-new", "4", "--weights", "w4a8"])
    assert stats["tokens_out"] == 16
    assert "arch=moonshot-v1-16b-a3b-reduced" in out.getvalue()
