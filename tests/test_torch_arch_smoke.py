"""The reference's ``tests/test_arch_smoke.py`` on the port, over every
architecture the port registers (all ten: an encoder-decoder's batch
carries frames, a VLM's a patch prefix and M-RoPE positions, as the
reference's ``_batch`` builds them), and the reference cases that run on the
reduced qwen3-14b (``test_ptq_rotation.py``'s fixture,
``test_distill_qat.py::test_calibration_collect_and_merge``,
``test_models.py::test_calib_collector_structure_matches_layers``), its
``test_long_context_support_flags`` and ``test_decode_matches_teacher_
forcing`` for the archs this slice adds.

Smoke cases assert shapes and finiteness; the full configs equal the
reference's field for field; the bridge and the checkpointer round-trip
the new archs' trees bitwise (qk-norm leaves, untied heads, 64-expert
banks). The reference's tolerances are kept: the rotation keeps the
function to atol 1e-2 (bf16 attention probabilities round differently in
a rotated basis), SmoothQuant's fold to 2e-2, teacher forcing to 2e-2.
"""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced_config as j_reduced
from repro.models import init_params as jinit
from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.core import qat as tqat
from repro_torch.core.analysis import rotation as trot
from repro_torch.core.precision import parse_policy
from repro_torch.core.ptq import rtn, smoothquant
from repro_torch.data import SyntheticConfig, calibration_batches
from repro_torch.models import blocks as TB
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.tree import tree_map

NEW_ARCHS = ("moonshot-v1-16b-a3b", "qwen3-14b", "qwen3-32b", "qwen2-7b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, B, S, seed=0):
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _batch(cfg, B=2, S=16, seed=0):
    """The reference's ``_batch`` without labels: tokens, a VLM's patch
    prefix (bf16) and (3, B, S + vision_tokens) positions, an
    encoder-decoder's frames (bf16)."""
    gen = torch.Generator().manual_seed(seed + 1)
    b = {"tokens": _tokens(cfg, B, S, seed)}
    if cfg.family == "vlm":
        b["patches"] = torch.randn((B, cfg.vision_tokens, cfg.d_model),
                                   generator=gen).to(torch.bfloat16)
        b["positions"] = torch.arange(S + cfg.vision_tokens).repeat(3, B, 1)
    if cfg.is_encdec:
        b["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                  generator=gen).to(torch.bfloat16)
    return b


def _out_len(cfg, S):
    return S + (cfg.vision_tokens if cfg.family == "vlm" else 0)


@pytest.mark.parametrize("arch", ARCH_IDS)
class TestArchSmoke:
    def test_forward_shapes_and_finite(self, arch):
        cfg = get_reduced_config(arch)
        params = init_params(cfg, seed=0, device="cpu")
        with torch.no_grad():
            logits, aux = forward(cfg, params, tqat.make_ctx("A8d-C8-W4"),
                                  _batch(cfg, 2, 16))
        assert logits.shape == (2, _out_len(cfg, 16), cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
        assert (float(aux["moe_aux"]) > 0.0) == cfg.is_moe

    def test_prefill_decode(self, arch):
        cfg = get_reduced_config(arch)
        params = init_params(cfg, seed=0, device="cpu")
        ctx = tqat.make_ctx("A8d-C8-W4")
        B, S = 2, 16
        with torch.no_grad():
            logits, cache = prefill(cfg, params, ctx, _batch(cfg, B, S),
                                    cache_budget=_out_len(cfg, S) + 8)
            assert logits.shape == (B, 1, cfg.vocab_size)
            tok = torch.argmax(logits[:, -1].float(), -1).to(
                torch.int32)[:, None]
            _, cache = decode_step(cfg, params, ctx, tok, cache)
            l2, cache = decode_step(cfg, params, ctx, tok, cache)
        assert l2.shape == (B, 1, cfg.vocab_size)
        assert bool(torch.isfinite(l2.float()).all())
        assert cache["position"].tolist() == [_out_len(cfg, S) + 2] * B

    def test_full_config_equals_reference(self, arch):
        """Every field of the full config equals the reference's, which
        carries the assigned dimensions (``test_full_config_exact_dims``)."""
        c, r = get_config(arch), j_get_config(arch)
        for f in dataclasses.fields(c):
            assert getattr(c, f.name) == getattr(r, f.name), f.name
        assert c.param_counts() == r.param_counts()

    def test_full_config_exact_dims(self, arch):
        """The reference's table of the assigned dimensions."""
        cfg = get_config(arch)
        expected = {
            "qwen2.5-3b": (36, 2048, 16, 2, 11008, 151_936),
            "qwen2-7b": (28, 3584, 28, 4, 18944, 152_064),
            "qwen3-14b": (40, 5120, 40, 8, 17408, 151_936),
            "qwen3-32b": (64, 5120, 64, 8, 25600, 151_936),
            "whisper-large-v3": (32, 1280, 20, 20, 5120, 51_866),
            "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163_840),
            "mixtral-8x7b": (32, 4096, 32, 8, 14336, 32_000),
            "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256_000),
            "qwen2-vl-2b": (28, 1536, 12, 2, 8960, 151_936),
            "xlstm-125m": (12, 768, 4, 4, 0, 50_304),
        }[arch]
        got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.d_ff, cfg.vocab_size)
        assert got == expected


def test_all_ten_archs_registered():
    assert len(ARCH_IDS) == 10 and sorted(ARCH_IDS) == sorted(J_ARCH_IDS)


def test_long_context_support_flags():
    assert not get_config("qwen3-32b").supports_long_context
    assert not get_config("moonshot-v1-16b-a3b").supports_long_context
    assert get_config("mixtral-8x7b").supports_long_context
    assert get_config("recurrentgemma-2b").supports_long_context
    assert get_config("xlstm-125m").supports_long_context


def test_q_dim_exceeds_d_model_in_qwen3_32b():
    cfg = get_config("qwen3-32b")
    assert cfg.q_dim == 8192 > cfg.d_model == 5120 and cfg.qk_norm


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_teacher_forcing(arch, monkeypatch):
    """The reference's case on the port: unbounded MoE capacity (dropping
    makes MoE prefill prefix-inconsistent by design), f32 params,
    quantization off; decode over the cache matches the parallel forward
    at each position to 2e-2."""
    monkeypatch.setattr(TB, "MOE_CAPACITY_FACTOR", 100.0)
    cfg = get_reduced_config(arch)
    params = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    ctx = tqat.make_ctx("A16-C16-W16", mode="off")
    S = 24
    toks = _tokens(cfg, 1, S, seed=4)
    with torch.no_grad():
        logits_all, _ = forward(cfg, params, ctx, {"tokens": toks})
        split = S - 4
        lg, cache = prefill(cfg, params, ctx, {"tokens": toks[:, :split]},
                            cache_budget=S + 4)
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   logits_all[:, split - 1].numpy(),
                                   atol=2e-2, rtol=2e-2)
        for t in range(split, S):
            lg, cache = decode_step(cfg, params, ctx, toks[:, t:t + 1],
                                    cache)
            np.testing.assert_allclose(lg[:, 0].numpy(),
                                       logits_all[:, t].numpy(),
                                       atol=2e-2, rtol=2e-2)


# --------------------------------------------------------------------------
# the reference's cases on the reduced qwen3-14b (qk-norm)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen3():
    """``test_ptq_rotation.py``'s fixture: the reduced qwen3-14b in f32,
    two calibration batches of 4 x 32 and the first as a batch."""
    cfg = get_reduced_config("qwen3-14b")
    params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    cb = calibration_batches(SyntheticConfig(vocab_size=cfg.vocab_size,
                                             seq_len=32, batch_size=4), 2)
    batch = {"tokens": torch.from_numpy(np.asarray(cb[0]["tokens"]))}
    return cfg, params, cb, batch


def test_rotation_function_preserving_qk_norm(qwen3):
    """The residual rotation leaves q_norm and k_norm alone (they act on
    head_dim, inside the rotated projections) and keeps the function."""
    cfg, params, _, batch = qwen3
    ctx = tqat.make_ctx("A16-C16-W16", mode="off")
    with torch.no_grad():
        l0, _ = forward(cfg, params, ctx, batch)
        rot = trot.rotate_residual(cfg, params,
                                   torch.Generator().manual_seed(7))
        l1, _ = forward(cfg, rot, ctx, batch)
    np.testing.assert_allclose(l0.numpy(), l1.numpy(), atol=1e-2)
    for i in range(cfg.n_layers):
        for k in ("q_norm", "k_norm"):
            assert torch.equal(rot["layers"][i]["attn"][k]["w"],
                               params["layers"][i]["attn"][k]["w"])


def test_rotation_report_separates_qat_from_rotation_qk_norm(qwen3):
    cfg, params, _, _ = qwen3
    rot = trot.rotate_residual(cfg, params, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(0)
    perturbed = tree_map(
        lambda x: x + 0.05 * torch.std(x) * torch.randn(
            x.shape, generator=gen, dtype=x.dtype) if x.dim() >= 2 else x,
        params)
    assert trot.rotational_share(trot.rotation_report(cfg, params,
                                                      rot)) > 0.8
    assert trot.rotational_share(trot.rotation_report(cfg, params,
                                                      perturbed)) < 0.5


def test_rtn_improves_with_bits_qk_norm(qwen3):
    cfg, params, cb, batch = qwen3
    with torch.no_grad():
        l0, _ = forward(cfg, params, tqat.make_ctx("A16-C16-W16",
                                                   mode="off"), batch)

        def agreement(name):
            pol = parse_policy(name)
            q = rtn.rtn_quantize(cfg, params, pol, cb)
            lq, _ = forward(cfg, q, tqat.make_ctx(pol), batch)
            return float((lq.argmax(-1) == l0.argmax(-1)).float().mean())

        assert agreement("A8s-C8-W8") >= agreement("A8s-C8-W4")


def test_smoothquant_folds_and_runs_qk_norm(qwen3):
    cfg, params, cb, batch = qwen3
    ctx_off = tqat.make_ctx("A16-C16-W16", mode="off")
    with torch.no_grad():
        folded = smoothquant.fold_smoothing(cfg, params, 0.5, cb)
        l0, _ = forward(cfg, params, ctx_off, batch)
        l1, _ = forward(cfg, folded, ctx_off, batch)
        np.testing.assert_allclose(l0.numpy(), l1.numpy(), rtol=2e-2,
                                   atol=2e-2)
        w0 = params["layers"][0]["attn"]["wq"]["w"]
        w1 = folded["layers"][0]["attn"]["wq"]["w"]
        assert bool(((w0 - w1).abs() > 1e-6).any())
        pol = parse_policy("A8s-C8-W4")
        q = smoothquant.smoothquant_quantize(cfg, params, pol, cb,
                                             alpha=0.4)
        lq, _ = forward(cfg, q, tqat.make_ctx(pol), batch)
    assert bool(torch.isfinite(lq).all())


def test_calibration_collect_and_merge_qk_norm():
    cfg = get_reduced_config("qwen3-14b")
    params = init_params(cfg, seed=1, device="cpu")
    policy = parse_policy("A8s-C8-W4")
    with torch.no_grad():
        _, aux = forward(cfg, params, tqat.make_ctx(policy, mode="calib"),
                         {"tokens": _tokens(cfg, 2, 16, seed=1)},
                         collect_stats=True)
    merged = tqat.merge_act_scales(params, [aux["qstats"]], policy)
    s0 = params["layers"][0]["attn"]["wq"]["s_in"]
    s1 = merged["layers"][0]["attn"]["wq"]["s_in"]
    assert bool((s0 != s1).any()) and bool((s1 > 0).all())


def test_calib_collector_structure_matches_layers_qk_norm():
    """One statistic a site and layer (the reference stacks them along the
    scan axis: a leading dim of n_layers)."""
    cfg = get_reduced_config("qwen3-14b").replace(n_layers=4)
    params = init_params(cfg, seed=1, device="cpu")
    with torch.no_grad():
        _, aux = forward(cfg, params, tqat.make_ctx("A8s-C8-W4",
                                                    mode="calib"),
                         {"tokens": _tokens(cfg, 2, 16, seed=2)},
                         collect_stats=True)
    layers = aux["qstats"]["layers"]
    assert len(layers) == 4
    for st in layers:
        assert st["attn"]["wq"]["s_in"].shape == ()
        assert st["attn"]["s_q"].shape == ()
        assert "q_norm" not in st["attn"] and "k_norm" not in st["attn"]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-14b", {}), ("qwen3-32b", {"n_heads": 8, "head_dim": 16}),
    ("qwen2-7b", {}), ("moonshot-v1-16b-a3b", {"n_experts": 64,
                                               "n_experts_active": 6})])
def test_bridge_and_checkpoint_round_trip(arch, kw, tmp_path):
    """The reference's tree (``segments/0/0/attn/{q_norm,k_norm}/w``, the
    untied ``head/{w,s_w,s_in}``, (L, 64, d_in, d_out) banks) splits into
    the port's per-layer tree and stacks back bitwise; the port's own
    init has the reference's tree; a checkpoint restores it bitwise."""
    cfg = j_reduced(arch).replace(**kw)
    tcfg = get_reduced_config(arch).replace(**kw)
    params = jinit(cfg, jax.random.PRNGKey(1))
    want = {k: _bits(v) for k, v in bridge.flatten(
        jax.tree.map(np.asarray, params))}
    for k in ({"segments/0/0/attn/q_norm/w", "head/w", "head/s_in"}
              if cfg.qk_norm else {"head/w", "head/s_w"}):
        assert k in want, k
    if cfg.is_moe:
        assert want["segments/0/0/moe/wg/w"].shape == (2, 64, 64, 64)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got = {k: _bits(v) for k, v in bridge.flatten(
        bridge.params_to_numpy(tp, ml_dtypes.bfloat16))}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    own = bridge.params_to_numpy(init_params(tcfg, device="cpu"))
    assert {k: np.shape(v) for k, v in bridge.flatten(own)} == \
        {k: np.shape(v) for k, v in want.items()}
    ck = Checkpointer(str(tmp_path))
    ck.save(2, tp, {"step": 2})
    restored, _ = ck.restore(init_params(tcfg, seed=5, device="cpu"))
    back, orig = dict(bridge.flatten(restored)), dict(bridge.flatten(tp))
    assert back.keys() == orig.keys()
    for k, v in orig.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("kw", [{}, {"n_heads": 8, "head_dim": 16}])
def test_rotation_and_fold_keep_the_function_at_wide_q(kw):
    """At q_dim > d_model (qwen3-32b's 8192 > 5120, reduced: 8 heads of 16
    on d 64) the rotation and SmoothQuant's fold keep the function, to
    the reference tests' tolerances."""
    cfg = get_reduced_config("qwen3-32b").replace(**kw)
    params = init_params(cfg, seed=2, device="cpu", dtype=torch.float32)
    cb = calibration_batches(SyntheticConfig(vocab_size=cfg.vocab_size,
                                             seq_len=32, batch_size=4), 2)
    batch = {"tokens": torch.from_numpy(np.asarray(cb[0]["tokens"]))}
    ctx = tqat.make_ctx("A16-C16-W16", mode="off")
    with torch.no_grad():
        l0, _ = forward(cfg, params, ctx, batch)
        rot = trot.rotate_residual(cfg, params,
                                   torch.Generator().manual_seed(7))
        np.testing.assert_allclose(forward(cfg, rot, ctx, batch)[0].numpy(),
                                   l0.numpy(), atol=1e-2)
        folded = smoothquant.fold_smoothing(cfg, params, 0.5, cb)
        np.testing.assert_allclose(
            forward(cfg, folded, ctx, batch)[0].numpy(), l0.numpy(),
            rtol=2e-2, atol=2e-2)
