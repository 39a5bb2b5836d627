"""The port's engines serving the qwen3 slice (qk-norm; see
``test_torch_qwen3.py`` for the variants) against the JAX package's:
the paged engine with prefix sharing (hits, COW, tail-waves) under
w4a8, and the dense and paged layouts' streams from one cold prefill
window each (chip_smoke's phase 3k holds them equal on the card).

The reference engine runs op by op (``jax.disable_jit``,
``w4a8_backend="ref"``) where the port is held to it: its compiled run
flips a greedy near tie on these prompts (``tests/test_torch_engine.py``
found the same for qwen2.5); the reference's own dense and paged engines
are held to each other compiled. Streams and counters: equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import init_params as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import qat as tqat
from repro_torch.serve.engine import Request, ServeEngine

POLICY = "A8d-C8-W4"
WIDE = dict(n_heads=8, head_dim=16)
VARIANTS = ("qwen3-14b", "qwen3-32b-wide")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SERVED = {}


def _served(variant):
    if variant not in _SERVED:
        arch = variant.replace("-wide", "")
        kw = WIDE if variant.endswith("-wide") else {}
        cfg = get_reduced_config(arch).replace(**kw)
        tcfg = t_reduced(arch).replace(**kw)
        params = jqat.calibrate_weight_scales(
            jinit(cfg, jax.random.PRNGKey(0)), parse_policy(POLICY))
        _SERVED[variant] = (cfg, tcfg, params, bridge.params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))
    return _SERVED[variant]


PAGED = dict(slots=2, cache_len=64, kv_layout="paged", block_size=16,
             num_blocks=32, max_seq_len=96, decode_block=4)


def _shared(cls, n=3):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 250, 40).astype(np.int32)
    return [cls(uid=i, prompt=np.concatenate(
        [prefix, ((np.arange(5) * (i + 3) + i) % 250).astype(np.int32)]),
        max_new_tokens=6) for i in range(n)]


def _drain(eng, reqs):
    eng.submit(reqs[0])
    eng.run_until_drained()
    for r in reqs[1:]:
        eng.submit(r)
    stats = eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], stats


@pytest.mark.parametrize("variant", VARIANTS)
def test_paged_engine_matches_reference(variant):
    """Shared-prefix requests (hits, COW of the split block, tail-waves)
    on the pool under w4a8: streams and counters equal to the reference
    engine's run op by op."""
    cfg, tcfg, params, tp = _served(variant)
    jeng = JServeEngine(cfg, params, weights_layout="w4a8",
                        w4a8_backend="ref", **PAGED)
    teng = ServeEngine(tcfg, tp, weights_layout="w4a8", device="cpu",
                       **PAGED)
    got, st = _drain(teng, _shared(Request))
    with jax.disable_jit():
        ref, rst = _drain(jeng, _shared(JRequest))
    assert got == ref
    assert st["prefix_hit_tokens"] > 0 and st["cow_copies"] > 0
    assert st["tail_waves"] > 0
    for k in ("tokens_out", "decode_steps", "prefill_calls",
              "prefill_chunks", "prefix_hit_tokens", "cow_copies"):
        assert st[k] == rst[k], k


@pytest.mark.parametrize("variant", VARIANTS)
def test_dense_and_paged_streams_equal(variant):
    """Prompts of three lengths, each admitted in one cold prefill window
    (prefix cache off), greedy and sampled: the port's paged engine gives
    the dense engine's streams, also on a tree whose bf16 linears were
    dropped after the export (chip_smoke's phase 3k), as the reference's
    two engines give each other's."""
    cfg, tcfg, params, tp = _served(variant)
    lens = (40, 40, 24, 24, 24, 9, 9, 9)

    def reqs(cls):
        rng = np.random.default_rng(21)
        return [cls(uid=i, prompt=rng.integers(0, 250, n).astype(np.int32),
                    max_new_tokens=5, temperature=0.8 if i % 4 == 3 else 0.0,
                    top_k=8 if i % 4 == 3 else 0, seed=i)
                for i, n in enumerate(lens)]

    kw = dict(slots=4, cache_len=64, block_size=16, prefill_chunk=64,
              prefix_cache=False, decode_block=4)
    dense = ServeEngine(tcfg, tp, weights_layout="w4a8", device="cpu", **kw)
    dropped = tqat.drop_exported_weights(dense.params)
    streams = {}
    for name, eng in (
            ("dense", dense),
            ("paged", ServeEngine(tcfg, dropped, weights_layout="w4a8",
                                  device="cpu", kv_layout="paged", **kw)),
            ("jdense", JServeEngine(cfg, params, weights_layout="w4a8",
                                    w4a8_backend="ref", **kw)),
            ("jpaged", JServeEngine(cfg, params, weights_layout="w4a8",
                                    w4a8_backend="ref", kv_layout="paged",
                                    **kw))):
        rs = reqs(JRequest if name.startswith("j") else Request)
        for r in rs:
            eng.submit(r)
        eng.run_until_drained()
        streams[name] = [r.generated for r in rs]
    assert streams["dense"] == streams["paged"]
    assert streams["jdense"] == streams["jpaged"]
