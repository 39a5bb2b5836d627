"""The port's MoE block (``blocks.moe_fwd``: GShard top-k routing with
per-batch-row capacity dispatch, chunked over the sequence) against the
JAX package's ``moe_fwd``, at the reduced mixtral config (d 64, 4 experts,
top 2, d_ff 64).

Same params (the reference's, calibrated, bridged) and the same inputs,
made with numpy, through both; the JAX side runs op by op
(``jax.disable_jit``). Tolerances, each with its reason:

* routing (the top-k experts, ties included, the positions within each
  expert, ``keep`` and the capacity): exact, integers on both sides;
* the index dispatch and combine against the reference's one-hot
  einsums: bitwise (a slot holds one token's row; a token's output sums
  at most two exact f32 products of bf16 values);
* ``moe_fwd``'s output: bitwise (measured), with ``MOE_CHUNK_S`` at the
  default and patched to 8 in both packages (three chunks at S 20, the
  last padded), with and without capacity drops;
* the load-balance aux within ``AUX_RTOL``: its f32 means over B x S
  router probabilities are summed in another order than XLA's reduce
  (a few ulps of a sum of 40-80 terms); ``frac_tok`` is the reference's
  bf16 mean, mirrored bitwise;
* gradients of the output and the aux with respect to x, the router and
  the three banks (weights and ``s_w``) within ``GRAD_RTOL`` of each
  leaf's norm: the f32 sums of the GEMMs' backward run in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.core.quantizer import dynamic_fake_quant as jdyn
from repro.models import blocks as JB
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import qat as tqat
from repro_torch.core.quantizer import dynamic_fake_quant
from repro_torch.models import blocks as TB

ARCH = "mixtral-8x7b"
POLICY = "A8d-C8-W4"
AUX_RTOL = 1e-6
GRAD_RTOL = 1e-2


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


def _port(tree):
    return jax.tree.map(lambda a: bridge.to_torch(np.asarray(a), "cpu"),
                        tree)


@pytest.fixture(scope="module")
def moe():
    cfg, tcfg = get_reduced_config(ARCH), t_reduced(ARCH)
    p = JB.init_moe(cfg, jax.random.PRNGKey(3))
    p = jqat.calibrate_weight_scales(p, parse_policy(POLICY))
    return cfg, tcfg, p, _port(p)


def _x(cfg, B, S, seed=0, dtype=jnp.bfloat16):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, bridge.to_torch(np.asarray(jx), "cpu")


def _run(cfg, tcfg, p, tp, jx, tx, monkeypatch, chunk=None, factor=None):
    for mod in (JB, TB):
        if chunk:
            monkeypatch.setattr(mod, "MOE_CHUNK_S", chunk)
        if factor:
            monkeypatch.setattr(mod, "MOE_CAPACITY_FACTOR", factor)
    with jax.disable_jit():
        jy, jaux = JB.moe_fwd(cfg, jqat.make_ctx(POLICY), p, jx)
    ty, taux = TB.moe_fwd(tcfg, tqat.make_ctx(POLICY), tp, tx)
    return jy, jaux, ty, taux


@pytest.mark.parametrize("chunk,factor", [(None, None), (8, None),
                                          (8, 0.5), (None, 0.3)])
def test_moe_fwd_matches_reference(moe, monkeypatch, chunk, factor):
    """y bitwise, the aux to its sums' order, at S 20 in one chunk and in
    three chunks of 8 (the last padded), with the default capacity and
    with one that drops (pairs) tokens."""
    cfg, tcfg, p, tp = moe
    jx, tx = _x(cfg, 2, 20, seed=1)
    jy, jaux, ty, taux = _run(cfg, tcfg, p, tp, jx, tx, monkeypatch, chunk,
                              factor)
    assert ty.shape == (2, 20, cfg.d_model) and ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(ty), _f32(jy))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    assert float(taux) > 0.0


def _ref_route(logits, k, cap):
    """The reference chunk's routing, line for line (jnp)."""
    e = logits.shape[-1]
    B, sc = logits.shape[:2]
    vals, idx = jax.lax.top_k(logits, k)
    gates = jax.nn.softmax(vals, axis=-1)
    oh = jax.nn.one_hot(idx, e, dtype=jnp.bfloat16)
    flat = oh.astype(jnp.float32).reshape(B, sc * k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(B, sc, k, e)
    pos = jnp.sum(pos * oh.astype(jnp.float32), axis=-1)
    return idx, gates, pos, pos < cap


@pytest.mark.parametrize("sc", [1, 3, 8, 20, 64])
def test_capacity_matches_reference(sc):
    """The capacity: round(sc k / e * 1.25), at least 1, up to a multiple
    of 4 from 4 on, at most sc k; computed inside the reference's
    ``moe_fwd``, restated here line for line."""
    cfg = t_reduced(ARCH)
    for c in (cfg, cfg.replace(n_experts=8), cfg.replace(n_experts=64,
                                                         n_experts_active=6)):
        e, k = c.n_experts, c.n_experts_active
        cap = max(1, int(round(sc * k / e * JB.MOE_CAPACITY_FACTOR)))
        cap = min(cap + (-cap) % 4 if cap >= 4 else cap, sc * k)
        assert TB.moe_capacity(c, sc) == cap


@pytest.mark.parametrize("cap", [1, 3, 40])
def test_routing_matches_reference_with_ties_and_drops(cap):
    """top-k indices (forced ties among bf16-valued logits go to the lower
    expert, as ``jax.lax.top_k`` breaks them), gates, positions counted
    along the flattened (s, k) order of each row, and ``keep``: exact."""
    rng = np.random.default_rng(4)
    logits = rng.integers(-2, 3, (3, 17, 8)).astype(np.float32) / 4.0
    logits[0, 0] = 0.5                       # an 8-way tie
    logits[1, 3, [2, 5]] = 9.0               # a tie on top
    with jax.disable_jit():
        jidx, jg, jpos, jkeep = _ref_route(jnp.asarray(logits), 2, cap)
    idx, gates, pos, keep = TB.moe_route(torch.from_numpy(logits), 2, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(gates.numpy(), np.asarray(jg))
    assert idx[0, 0].tolist() == [0, 1] and idx[1, 3].tolist() == [2, 5]
    if cap < 17 * 2 // 8:
        assert not keep.all()


def test_index_dispatch_equals_one_hot_einsums(moe):
    """The port's gathers against the reference's one-hot einsums, both
    computed here in torch from the same routing: the dispatched slots
    and the combined outputs bitwise."""
    cfg, tcfg, _, _ = moe
    e, k = cfg.n_experts, cfg.n_experts_active
    rng = np.random.default_rng(5)
    B, sc, d, cap = 2, 16, cfg.d_model, 6
    x = torch.from_numpy(rng.standard_normal((B, sc, d)).astype(
        np.float32)).to(torch.bfloat16)
    logits = torch.from_numpy(rng.standard_normal((B, sc, e)).astype(
        np.float32)).to(torch.bfloat16).float()
    idx, gates, pos, keep = TB.moe_route(logits, k, cap)
    assert not keep.all()
    oh = torch.nn.functional.one_hot(idx, e).float()
    pos_oh = torch.nn.functional.one_hot(
        torch.clamp_max(pos, cap - 1), cap).float() * keep[..., None]
    dispatch = torch.einsum("bske,bskc->bsec", oh, pos_oh)
    combine = torch.einsum("bske,bskc,bsk->bsec", oh, pos_oh,
                           gates.to(torch.bfloat16).float())
    xe_ref = torch.einsum("bsec,bsd->becd", dispatch, x.float()).to(
        torch.bfloat16)
    ye = torch.from_numpy(rng.standard_normal((e, B, cap, d)).astype(
        np.float32)).to(torch.bfloat16)
    y_ref = torch.einsum("bsec,becd->bsd", combine.to(torch.bfloat16).float(),
                         ye.transpose(0, 1).float()).to(torch.bfloat16)

    bidx = torch.arange(B)
    tok = torch.arange(sc).view(1, sc, 1).expand(B, sc, k)
    slot = torch.where(keep, idx * cap + pos, e * cap)
    table = torch.full((B, e * cap + 1), sc, dtype=torch.long)
    table.scatter_(1, slot.reshape(B, -1), tok.reshape(B, -1))
    table = table[:, :e * cap].reshape(B, e, cap).transpose(0, 1)
    xz = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    xe = xz[bidx[None, :, None], table]
    assert torch.equal(xe.transpose(0, 1), xe_ref)
    ysel = ye[idx, bidx[:, None, None], torch.clamp_max(pos, cap - 1)]
    gk = torch.where(keep, gates.to(torch.bfloat16).float(),
                     torch.zeros_like(gates))
    y = torch.sum(ysel.float() * gk[..., None], dim=2).to(torch.bfloat16)
    assert torch.equal(y, y_ref)


def test_zero_slots_quantize_to_zero():
    """Empty capacity slots are all-zero rows through the dynamic int8
    activation quantizer: zero in both packages, no NaN."""
    x = np.zeros((3, 5, 64), np.float32)
    x[1, 2] = np.linspace(-1, 1, 64)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = jdyn(jx, 8)
    got = dynamic_fake_quant(bridge.to_torch(np.asarray(jx), "cpu"), 8)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert not np.any(_f32(got)[0])


def test_aux_frac_tok_is_a_bf16_mean(moe, monkeypatch):
    """``frac_tok`` is the reference's ``jnp.mean`` of a bf16 sum: the f32
    mean rounded to bf16. At B 3, S 7 (21 tokens: shares like 5/21 are
    not bf16 values) the port's aux equals the reference's within its
    sums' order and differs from the aux of an unrounded mean by more."""
    cfg, tcfg, p, tp = moe
    jx, tx = _x(cfg, 3, 7, seed=6)
    jy, jaux, ty, taux = _run(cfg, tcfg, p, tp, jx, tx, monkeypatch)
    np.testing.assert_array_equal(_f32(ty), _f32(jy))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    ctx = tqat.make_ctx(POLICY)
    logits = tqat.qlinear(ctx, tx, tp["router"], act_bits=8,
                          weight_bits=8).float()
    idx, _, _, _ = TB.moe_route(logits, cfg.n_experts_active, 1)
    counts = torch.nn.functional.one_hot(idx, cfg.n_experts).sum(2).float()
    frac = counts.sum((0, 1)) / 21.0
    probs = torch.softmax(logits, -1).mean((0, 1))
    unrounded = float(cfg.n_experts * torch.sum(frac * probs))
    assert abs(unrounded - float(jaux)) > 10 * AUX_RTOL * abs(float(jaux))


def test_grads_match_reference(moe, monkeypatch):
    """d(sum(y * gy) + aux) with respect to x, the router's and the banks'
    weights and step sizes, in three chunks of 8: within ``GRAD_RTOL`` of
    each leaf's norm."""
    cfg, tcfg, p, tp = moe
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "MOE_CHUNK_S", 8)
    jx, tx = _x(cfg, 2, 20, seed=8)
    gy = np.random.default_rng(9).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)

    def jloss(params, x):
        y, aux = JB.moe_fwd(cfg, jqat.make_ctx(POLICY), params, x)
        return jnp.sum(y.astype(jnp.float32) * gy) + aux

    with jax.disable_jit():
        jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(p, jx)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    tx = tx.clone().requires_grad_(True)
    y, aux = TB.moe_fwd(tcfg, tqat.make_ctx(POLICY), tp, tx)
    (torch.sum(y.float() * torch.from_numpy(gy)) + aux).backward()
    pairs = [("x", tx.grad, jg_x)]
    for name in ("router", "wg", "wu", "wd"):
        for leaf in ("w", "s_w", "s_in"):
            pairs.append((f"{name}/{leaf}", tp[name][leaf].grad,
                          jg_p[name][leaf]))
    for name, got, want in pairs:
        w = _f32(want)
        # a leaf no op read (s_in under a dynamic policy) has no gradient
        # in torch and a zero one in JAX
        g = np.zeros_like(w) if got is None else _f32(got)
        assert g.shape == w.shape, name
        err = np.linalg.norm(g - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) + 1e-6, (
            name, err, np.linalg.norm(w))
