"""The port's sampler against jax's: threefry bits, ``fold_in``, the
partitionable ``random_bits`` layout, ``uniform``, ``gumbel`` and
``categorical``, then whole sampled streams of the port's engine against
the JAX package's engine.

Tolerances: the random bits, keys and uniforms are integer (or exact
bit-cast) arithmetic and must be bitwise equal. The gumbel noise goes
through ``log`` twice, and XLA's and torch's ``log`` may round the last
bit differently: it must agree within 2 ulps of max(|g|, 1) (measured
when this test was written: at most 1). Sampled streams are then equal
except at near-ties; the tested requests have none, and the reference
engine runs op by op, as the other bitwise engine checks do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import init_params as jax_init_params
from repro.serve import sampling as jsampling
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.serve import sampling
from repro_torch.serve.engine import Request, ServeEngine

SEEDS = [(0, 0), (3, 7), (2 ** 32 - 1, 12345), (11, 2 ** 31 + 5)]
COUNTS = (0, 1, 31, 2 ** 31 - 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_key(seed, uid):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), uid)


@pytest.mark.parametrize("seed,uid", SEEDS)
def test_keys_and_fold_in_bitwise(seed, uid):
    jk = _jax_key(seed, uid)
    key = sampling.slot_key(seed, uid)
    assert key == tuple(int(x) for x in np.asarray(jk))
    got = sampling.fold_step(torch.tensor([key] * len(COUNTS)),
                             torch.tensor(COUNTS, dtype=torch.int32))
    want = np.stack([np.asarray(jax.random.fold_in(jk, c)) for c in COUNTS])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed,uid", SEEDS)
def test_random_bits_and_uniform_bitwise(seed, uid):
    V = 1003                                        # odd, like a vocab cut
    keys = [np.asarray(jax.random.fold_in(_jax_key(seed, uid), c))
            for c in COUNTS[:3]]
    tkeys = torch.tensor(np.stack(keys).astype(np.int64))
    bits = sampling.random_bits(tkeys, V).numpy()
    uni = sampling.uniform(tkeys, V).numpy()
    tiny = np.finfo(np.float32).tiny
    for i, k in enumerate(keys):
        want = np.asarray(jax.random.bits(k, (V,), jnp.uint32))
        np.testing.assert_array_equal(bits[i], want.astype(np.int64))
        want_u = np.asarray(jax.random.uniform(k, (V,), minval=tiny,
                                               maxval=1.0))
        np.testing.assert_array_equal(uni[i], want_u)


@pytest.mark.parametrize("seed,uid", SEEDS)
def test_gumbel_within_two_ulps(seed, uid):
    V = 4096
    k = np.asarray(jax.random.fold_in(_jax_key(seed, uid), 3))
    want = np.asarray(jax.random.gumbel(k, (V,)))
    got = sampling.gumbel(torch.tensor(k.astype(np.int64))[None], V)[0]
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got.numpy() - want) <= 2 * ulp)


def test_sample_tokens_equal_to_reference():
    """Greedy, temperature and top-k rows on fixed logits draw the
    reference's tokens, over many keys."""
    rng = np.random.default_rng(0)
    B, V = 6, 512
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 0.7, 1.5, 0.9, 0.9], np.float32)
    top_k = np.array([0, 1, 4, 16, 0, 64], np.int32)
    base = np.stack([np.asarray(_jax_key(9, r)) for r in range(B)])
    for step in range(12):
        jk = jsampling.fold_step(jnp.asarray(base),
                                 jnp.full((B,), step, jnp.int32))
        want = np.asarray(jsampling.sample_tokens(
            jnp.asarray(logits), jk, jnp.asarray(temp), jnp.asarray(top_k)))
        tk = sampling.fold_step(torch.tensor(base.astype(np.int64)),
                                torch.full((B,), step, dtype=torch.int32))
        np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                      tk.numpy())
        got = sampling.sample_tokens(torch.from_numpy(logits), tk,
                                     torch.from_numpy(temp),
                                     torch.from_numpy(top_k))
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# whole engines
# --------------------------------------------------------------------------

POLICY = "A8d-C8-W4"
ENGINE = dict(slots=2, cache_len=48, decode_block=4)


@pytest.fixture(scope="module")
def served():
    cfg = get_reduced_config("qwen2.5-3b")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    params = jqat.calibrate_weight_scales(params, parse_policy(POLICY))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    return cfg, params, tparams


def _serve(eng, cls, prompts, **req):
    reqs = [cls(uid=i, prompt=p, seed=7, **req)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("top_k", [16, 0])
def test_engine_sampled_streams_equal_reference(served, top_k):
    """Temperature 0.9 streams of the port's dense engine equal the JAX
    dense engine's (run op by op), token for token."""
    cfg, params, tparams = served
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 14)]
    kw = dict(max_new_tokens=6, temperature=0.9, top_k=top_k)
    with jax.disable_jit():
        ref = _serve(JServeEngine(cfg, params, weights_layout="w4a8",
                                  w4a8_backend="ref", kv_layout="dense",
                                  **ENGINE), JRequest, prompts, **kw)
    got = _serve(ServeEngine(t_get_reduced_config("qwen2.5-3b"), tparams,
                             weights_layout="w4a8", device="cpu", **ENGINE),
                 Request, prompts, **kw)
    assert got == ref
    assert len({t for s in got for t in s}) > 3      # varied, not constant
