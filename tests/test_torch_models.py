"""Parity of the port's model (prefill + decode steps) with the JAX
package at the reduced qwen2.5-3b config, under both weight layouts.

Same params (the JAX package's, calibrated, bridged), same tokens through
both. Tolerance, per reference run:

* The JAX functions run op by op (``jax.disable_jit``): every op then is
  one XLA kernel with the same f32/bf16 semantics as the port's torch op,
  and logits, cache codes and cache scales are bitwise equal — zero
  flips, over prefill and several decode steps.
* Compiled (``jax.jit``), XLA fuses elementwise chains and may contract a
  multiply-add into an FMA, which moves some values by an ulp; dynamic
  per-token quantization then turns a moved absmax into shifted codes
  for the whole token, and the shift grows through the layers. The
  compiled reference therefore disagrees with its own op-by-op run as
  much as with the port. Against it the test holds what an ulp can move:
  the first layer's cache codes are equal except for +-1 flips at
  rounding boundaries (counted, at most 1% of codes; measured at this
  input: none of 6144 under either layout).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.core import qat as tqat
from repro_torch.core.precision import parse_policy as t_parse_policy
from repro_torch.models import decode_step, prefill

POLICY = "A8d-C8-W4"
CACHE_LEN = 32
DECODE_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = get_reduced_config("qwen2.5-3b")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    params = jqat.calibrate_weight_scales(params, parse_policy(POLICY))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    return cfg, params, tparams


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _layer_cache(jcache, i):
    return jax.tree.map(lambda a: np.asarray(a[i]),
                        jcache["segments"][0]["0"]["self"])


def _setup(models, layout):
    cfg, params, tparams = models
    jparams, tp = params, tparams
    if layout == "w4a8":
        jparams = jqat.attach_w4a8_exports(params, parse_policy(POLICY))
        tp = tqat.attach_w4a8_exports(tparams, t_parse_policy(POLICY))
    jctx = jqat.make_ctx(POLICY, weights_layout=layout, w4a8_backend="ref")
    tctx = tqat.make_ctx(POLICY, weights_layout=layout)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    lens = np.array([16, 9, 3], np.int32)          # right-padded rows
    return cfg, jparams, tp, jctx, tctx, toks, lens


def _run_jax(cfg, jparams, jctx, toks, lens, feed):
    logits, cache = jax_prefill(
        cfg, jparams, jctx,
        {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lens)},
        cache_budget=CACHE_LEN)
    out = [(logits, cache)]
    for t in feed:
        logits, cache = jax_decode_step(cfg, jparams, jctx, jnp.asarray(t),
                                        cache)
        out.append((logits, cache))
    return out


@pytest.mark.parametrize("layout", ["bf16", "w4a8"])
def test_prefill_and_decode_match_op_by_op_reference(models, layout):
    cfg, jparams, tp, jctx, tctx, toks, lens = _setup(models, layout)
    tcfg = t_get_reduced_config("qwen2.5-3b")
    # greedy feed from the reference's own prefill, identical for both
    with jax.disable_jit():
        first = _run_jax(cfg, jparams, jctx, toks, lens, [])[0][0]
        feed = [np.asarray(jnp.argmax(first[:, -1], -1)).astype(np.int32)
                [:, None]]
        for i in range(1, DECODE_STEPS):
            feed.append((feed[-1] * 7 + i) % cfg.vocab_size)
        ref = _run_jax(cfg, jparams, jctx, toks, lens, feed)
    logits, cache = prefill(
        tcfg, tp, tctx,
        {"tokens": torch.from_numpy(toks), "lengths": torch.from_numpy(lens)},
        cache_budget=CACHE_LEN)
    for step, (jl, jc) in enumerate(ref):
        if step:
            logits, cache = decode_step(tcfg, tp, tctx,
                                        torch.from_numpy(feed[step - 1]),
                                        cache)
        assert logits.shape == jl.shape
        np.testing.assert_array_equal(_f32(jl), _f32(logits),
                                      err_msg=f"logits, step {step}")
        np.testing.assert_array_equal(np.asarray(jc["position"]),
                                      cache["position"].numpy())
        flips = 0
        for i, layer in enumerate(cache["layers"]):
            jlayer = _layer_cache(jc, i)
            for key in ("k_q", "v_q"):
                flips += int(np.sum(jlayer[key] != layer[key].numpy()))
            for key in ("s_k", "s_v", "length"):
                np.testing.assert_array_equal(jlayer[key], layer[key].numpy())
        assert flips == 0, f"{flips} cache-code flips at step {step}"


@pytest.mark.parametrize("layout", ["bf16", "w4a8"])
def test_first_layer_cache_codes_against_compiled_reference(models, layout):
    cfg, jparams, tp, jctx, tctx, toks, lens = _setup(models, layout)
    jlogits, jcache = jax.jit(
        lambda p, t, l: jax_prefill(cfg, p, jctx,
                                    {"tokens": t, "lengths": l},
                                    cache_budget=CACHE_LEN))(
        jparams, jnp.asarray(toks), jnp.asarray(lens))
    tlogits, tcache = prefill(
        t_get_reduced_config("qwen2.5-3b"), tp, tctx,
        {"tokens": torch.from_numpy(toks), "lengths": torch.from_numpy(lens)},
        cache_budget=CACHE_LEN)
    jl0 = _layer_cache(jcache, 0)
    flips = total = 0
    for key in ("k_q", "v_q"):
        d = jl0[key].astype(np.int32) - tcache["layers"][0][key].numpy()
        assert np.abs(d).max() <= 1, f"{key}: code moved by {np.abs(d).max()}"
        flips += int(np.count_nonzero(d))
        total += d.size
    assert flips <= total // 100, f"{flips} of {total} first-layer flips"
    assert np.all(np.isfinite(_f32(tlogits)))
    assert tlogits.shape == jlogits.shape


# the cos/sin tables are glibc's f32 sinf/cosf, which XLA:CPU computes:
# bitwise equal (an f64 cos/sin rounded to f32 differed in 8 cos and 21
# sin of 3072 entries at 48 positions, 192 and 306 of 32768 at 512;
# torch's f32 cos/sin in 160/63 and 1932/821)
ROPE_MISMATCH_BOUND = {48: (0, 0), 512: (0, 0)}


@pytest.mark.parametrize("n_pos", sorted(ROPE_MISMATCH_BOUND))
def test_rope_frequencies_and_angles_bitwise_tables_counted(n_pos):
    """The port's RoPE frequencies and angles are bitwise equal to the
    reference's (``repro.models.common.rope_tables``, whose frequency
    expression is repeated here to read them); the cos/sin tables differ
    in at most the counted entries (none), each by one f32 ulp."""
    from repro.models.common import rope_tables as jax_rope_tables
    from repro_torch.models.common import rope_freqs, rope_tables
    hd, theta = 128, 1e6
    half = hd // 2
    jfreqs = np.asarray(theta ** (-jnp.arange(0, half, dtype=jnp.float32)
                                  / half))
    tfreqs = rope_freqs(hd, theta, "cpu").numpy()
    np.testing.assert_array_equal(jfreqs, tfreqs)
    pos = np.arange(n_pos, dtype=np.int32)
    jang = np.asarray(jnp.asarray(pos).astype(jnp.float32)[..., None]
                      * jnp.asarray(jfreqs))
    tang = (torch.from_numpy(pos).float()[..., None]
            * torch.from_numpy(tfreqs)).numpy()
    np.testing.assert_array_equal(jang, tang)
    jc, js = map(np.asarray, jax_rope_tables(jnp.asarray(pos), hd, theta))
    tc, ts = (t.numpy() for t in rope_tables(torch.from_numpy(pos), hd,
                                             theta))
    for name, j, t, bound in (("cos", jc, tc, ROPE_MISMATCH_BOUND[n_pos][0]),
                              ("sin", js, ts, ROPE_MISMATCH_BOUND[n_pos][1])):
        n_diff = int(np.sum(j != t))
        assert n_diff <= bound, f"{name}: {n_diff} entries differ > {bound}"
        np.testing.assert_array_max_ulp(j, t, maxulp=1)


# widths of the reduced configs, of xlstm-125m and qwen2.5-3b, of a head
# and of an MLP, and ragged ones (a partial 32-element window)
NORM_WIDTHS = (16, 48, 64, 85, 128, 768, 1536, 2048, 11008)


@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_rms_norm_variance_bitwise_with_op_by_op_reference(d):
    """The CPU variance of ``rms_norm`` and ``head_rms_norm`` is bitwise
    the reference's op by op at every width (XLA:CPU's windowed order,
    ``models/common.py:_xla_cpu_row_sum``), on random rows of which
    ``torch.mean`` gets about half wrong. The f32 rsqrt that follows is
    XLA's x86 estimate and a Newton step, not reproduced bit for bit: the
    port's correctly rounded one is within one ulp, so each normalized
    value is bitwise where the two rsqrt agree and within one bf16 ulp
    elsewhere."""
    from repro.models.common import head_rms_norm as jhead
    from repro.models.common import rms_norm as jrms
    from repro_torch.models.common import _mean_sq, head_rms_norm, rms_norm
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((256, d)) * 3).astype(np.float32)
    w = (rng.standard_normal(d) * 0.1 + 1).astype(np.float32)
    xb, wb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(
        jnp.bfloat16)
    with jax.disable_jit():
        xf = xb.astype(jnp.float32)
        jvar = np.asarray(jnp.mean(xf * xf, axis=-1, keepdims=True))
        jr = np.asarray(jax.lax.rsqrt(jnp.asarray(jvar) + 1e-6))
        jy = _f32(jrms(xb, {"w": wb}))
        jh = _f32(jhead(xb, wb, 1e-6))
    tx = torch.from_numpy(np.asarray(xf)).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    txf = tx.float()
    tvar = _mean_sq(txf).numpy()
    np.testing.assert_array_equal(tvar, jvar)
    old = torch.mean(txf * txf, dim=-1, keepdim=True).numpy()
    if d > 32:      # rows the previous torch.mean summed apart
        assert np.mean(old != jvar) >= 0.2
    tr = torch.rsqrt((torch.from_numpy(tvar) + 1e-6).double()).float().numpy()
    np.testing.assert_array_max_ulp(tr, jr, maxulp=1)
    same = (tr == jr)[:, 0]
    for got, want in ((_f32(rms_norm(tx, {"w": tw})), jy),
                      (_f32(head_rms_norm(tx, tw, 1e-6)), jh)):
        np.testing.assert_array_equal(got[same], want[same])
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
