"""The port's paged engine serving moonshot-v1-16b-a3b against the JAX
package's engine, continued from ``test_torch_moonshot_engine.py``:
optimistic admission with a preemption and swap, and speculative
decoding greedy and sampled (k 2, a one-layer draft), at the reduced
config (2 layers, d 64, 8 experts top 2) under w4a8.

Same params (the reference's, calibrated, bridged) and requests through
both engines; the reference engine runs op by op (``jax.disable_jit``,
``w4a8_backend="ref"``): its compiled run flips a greedy near tie in
the sampled spec run, as ``tests/test_torch_engine.py`` found for
qwen2.5. Streams and counters: equal. Spec streams are held to the
reference's spec engine, not to plain decode: a verify-wave routes its
window at a C-token chunk's capacity (mirrored, ``models.spec_verify``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import init_params as jinit
from repro.serve import spec as jspec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_reduced
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


def test_optimistic_admission_preempts_as_reference(served):
    """Optimistic admission on a pool too small for every resident: at
    least one preemption, swap bytes out == in, streams and counters equal
    to the reference engine's."""
    kw = dict(num_blocks=3, admission="optimistic", prefix_cache=False)

    def reqs(cls):
        return [cls(uid=i, prompt=((np.arange(10) * (i + 2) + i) % 250
                                   ).astype(np.int32), max_new_tokens=8)
                for i in (0, 9)]

    jeng, teng = _engines(served, **kw)
    got, st = _drain(teng, reqs(Request), staged=False)
    with jax.disable_jit():
        ref, rst = _drain(jeng, reqs(JRequest), staged=False)
    assert st["preemptions"] >= 1
    assert st["swap_out_bytes"] == st["swap_in_bytes"] > 0
    assert got == ref
    for k in ("preemptions", "swap_out_bytes", "swap_in_bytes",
              "tokens_out", "max_residents"):
        assert st[k] == rst[k], k


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_decoding_matches_reference(served, temperature):
    """Speculative decoding (k 2, a one-layer draft) over shared-prefix
    requests: streams and spec counters equal to the reference engine's.
    They are not held to plain decode's: the verify-wave's capacity
    differs from decode's."""
    spec = dict(k=2, draft_layers=1)
    kw = dict(temperature=temperature, top_k=8 if temperature else 0,
              seed=2)
    jeng, teng = _engines(served, spec=spec)
    got, st = _drain(teng, _shared(Request, **kw))
    with jax.disable_jit():
        ref, rst = _drain(jeng, _shared(JRequest, **kw))
    assert got == ref
    for k in ("spec_waves", "spec_drafted", "spec_accepted",
              "spec_rolled_back", "spec_draft_prefill_tokens",
              "tokens_out", "prefix_hit_tokens", "cow_copies"):
        assert st[k] == rst[k], k
    assert teng.draft_cfg.n_layers == 1 and teng.draft_cfg.is_moe
