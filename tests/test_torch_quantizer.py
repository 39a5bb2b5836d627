"""Parity of the port's quantizers and w4a8 export with the JAX package.

Integer codes, per-token scales, packed nibbles and export scales are
exact in both packages (fp32 math, round half to even), so every check
here is equality, not a tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core import quantizer as jq
from repro.core.precision import parse_policy
from repro.models import init_params as jax_init_params
from repro_torch import bridge
from repro_torch.core import qat as tqat
from repro_torch.core import quantizer as tq
from repro_torch.core.precision import parse_policy as t_parse_policy

POLICY = "A8d-C8-W4"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return bridge.to_torch(np.asarray(a), "cpu")


def _bf16(rng, shape, scale=1.0):
    return np.array(jnp.asarray(rng.standard_normal(shape) * scale,
                                jnp.bfloat16))


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("shape", [(7, 33), (2, 3, 64)])
def test_dynamic_quantize_to_int_exact(bits, shape):
    rng = np.random.default_rng(bits + len(shape))
    x = _bf16(rng, shape, 3.0)
    x[0, ...] = 0                       # all-zero token: eps floor
    jq_codes, js = jq.dynamic_quantize_to_int(jnp.asarray(x), bits,
                                              dtype=jnp.int32)
    tq_codes, ts = tq.dynamic_quantize_to_int(_t(x), bits, dtype=torch.int32)
    np.testing.assert_array_equal(np.asarray(jq_codes), tq_codes.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("bits", [8, 16])
def test_dynamic_fake_quant_exact(bits):
    rng = np.random.default_rng(bits)
    x = _bf16(rng, (5, 3, 16), 2.0)
    ref = np.asarray(jq.dynamic_fake_quant(jnp.asarray(x), bits)
                     .astype(jnp.float32))
    got = tq.dynamic_fake_quant(_t(x), bits).float().numpy()
    np.testing.assert_array_equal(ref, got)


def test_round_half_to_even_both_sides():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 127.0]], np.float32)
    s = np.ones((1, 1), np.float32)
    ref = np.asarray(jq.quantize_to_int(jnp.asarray(x), jnp.asarray(s), 8))
    got = tq.quantize_to_int(_t(x), _t(s), 8).numpy()
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(got, [[0, 2, 2, 0, -2, 4, 127]])


@pytest.mark.parametrize("shape", [(5, 8), (3, 4, 34)])
def test_pack_unpack_int4_exact(shape):
    rng = np.random.default_rng(len(shape))
    q = rng.integers(-8, 8, shape).astype(np.int8)
    jp = np.asarray(jq.pack_int4(jnp.asarray(q)))
    tp = tq.pack_int4(_t(q)).numpy()
    np.testing.assert_array_equal(jp, tp)
    assert tp.dtype == np.uint8
    # low nibble = even index
    np.testing.assert_array_equal(tp[..., 0] & 0xF, q[..., 0] & 0xF)
    np.testing.assert_array_equal(tq.unpack_int4(_t(tp)).numpy(), q)
    np.testing.assert_array_equal(np.asarray(jq.unpack_int4(jnp.asarray(tp))),
                                  tq.unpack_int4(_t(tp)).numpy())


def test_pack_int4_rejects_odd_last_dim():
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("case", ["placeholder", "calibrated4",
                                  "calibrated8", "bias"])
def test_export_linear_w4_exact(case):
    rng = np.random.default_rng(len(case))
    d_in, d_out = 64, 24
    w = _bf16(rng, (d_in, d_out), d_in ** -0.5)
    s_w = np.ones((1, d_out), np.float32)
    bits = 8 if case == "calibrated8" else 4
    if case.startswith("calibrated"):
        s_w = (rng.random((1, d_out)) * 0.02 + 1e-3).astype(np.float32)
        s_w[0, 3] = 1.0                 # one placeholder channel in the mix
    p = {"w": w, "s_w": s_w}
    if case == "bias":
        p["b"] = _bf16(rng, (d_out,))
    ref = jqat.export_linear_w4({k: jnp.asarray(v) for k, v in p.items()},
                                bits)
    got = tqat.export_linear_w4({k: _t(v) for k, v in p.items()}, bits)
    np.testing.assert_array_equal(np.asarray(ref["wq"]), got["wq"].numpy())
    np.testing.assert_array_equal(np.asarray(ref["s_w"]), got["s_w"].numpy())
    assert set(ref) == set(got)


def test_attach_exports_match_including_tied_head():
    """Every served linear of the reduced model and the tied head (from
    ``embed.w.T`` at head_bits=8) export identical nibbles and scales."""
    cfg = get_reduced_config("qwen2.5-3b")
    params = jax_init_params(cfg, jax.random.PRNGKey(3))
    params = jqat.calibrate_weight_scales(params, parse_policy(POLICY))
    jtree = jqat.attach_w4a8_exports(params, parse_policy(POLICY))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    ttree = tqat.attach_w4a8_exports(tparams, t_parse_policy(POLICY))
    jflat = dict(bridge.flatten(jax.tree.map(np.asarray, jtree)))
    n_checked = 0
    for li, layer in enumerate(ttree["layers"]):
        for path, leaf in bridge.flatten(layer):
            if "/w4a8/" not in f"/{path}/":
                continue
            ref = jflat[f"segments/0/0/{path}"][li]
            if leaf.dtype == torch.bfloat16:        # the bias rides along
                ref, leaf = ref.astype(np.float32), leaf.float()
            np.testing.assert_array_equal(ref, leaf.numpy(), err_msg=path)
            n_checked += 1
    # q, k, v, o, gate, up, down per layer: wq + s_w each, b on q/k/v
    assert n_checked == cfg.n_layers * (7 * 2 + 3)
    for key in ("wq", "s_w"):
        np.testing.assert_array_equal(jflat[f"head/w4a8/{key}"],
                                      ttree["head"]["w4a8"][key].numpy())
    assert ttree["head"]["w4a8"]["wq"].shape == (cfg.vocab_size,
                                                 cfg.d_model // 2)
    jbytes = jqat.w4a8_weight_bytes(jtree)
    assert tqat.w4a8_weight_bytes(ttree) == jbytes


def test_bridge_bf16_and_layer_split():
    cfg = get_reduced_config("qwen2.5-3b")
    params = jax_init_params(cfg, jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, params)
    tp = bridge.params_from_numpy(tree, "cpu")
    assert len(tp["layers"]) == cfg.n_layers
    w = tp["layers"][1]["attn"]["wq"]["w"]
    assert w.dtype == torch.bfloat16
    ref = tree["segments"][0]["0"]["attn"]["wq"]["w"][1].astype(np.float32)
    np.testing.assert_array_equal(ref, w.float().numpy())
    assert tp["embed"]["w"].dtype == torch.bfloat16
    assert tp["layers"][0]["attn"]["s_q"].shape == ()
