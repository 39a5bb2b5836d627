"""Speculative decoding in the port's paged engine (CPU, plain versions):
draft, verify-wave, rollback.

Mirrors the reference's ``tests/test_spec_decode.py`` (``TestTokenParity``,
``TestRejectionSampling``, ``TestRollbackAccounting``,
``TestDraftConstruction``) and holds the pieces against the JAX package:

* inside the port, exact-mode spec streams equal plain paged decode
  streams, greedy and sampled, for an agreeing draft and for one that is
  wrong every wave, across prefix-shared (COW) blocks, across
  preempt/swap, and at an EOS inside the window; the verify-wave's logits
  equal sequential decode steps' bitwise (on the CPU every op of both
  paths computes each row the same way);
* against the JAX package: ``accept_exact``, ``accept_rejection`` and
  ``token_probs`` on the same seeded inputs (bitwise, probabilities within
  1e-6); the plain ``kvq_spec_verify_attn_ref`` against the reference's
  XLA version and its Pallas kernel in interpret mode within one bf16 ulp
  (rtol 2^-7, atol 1e-4, bf16 q); and the engine on short prompts against
  the JAX engine (compiled, ``w4a8_backend="ref"``): the same committed
  streams and the same ``spec_*`` counters. The prompts are short (5 and
  11 tokens) and few tokens are drawn, so the compiled reference's
  greedy near-tie flips (``tests/test_torch_engine.py``) stay out of
  reach; the streams then agree exactly.

The sabotaged draft follows the reference's test: an untied sharp random
head (scaled 40x), so proposals diverge and every wave rolls back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.kernels.kvq_attn import ops as jops
from repro.kernels.kvq_attn import ref as jref
from repro.models import init_params as jax_init_params
from repro.serve import sampling as jsampling
from repro.serve import spec as jspec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.core.qat import export_linear_w4, init_linear
from repro_torch.kernels.kvq_attn.ref import kvq_spec_verify_attn_ref
from repro_torch.models import (clone_cache, decode_step, init_cache,
                                prefill, spec_verify)
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import (SpecConfig, accept_exact,
                                    accept_rejection, make_draft)

POLICY = "A8d-C8-W4"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    cfg = get_reduced_config("qwen2.5-3b")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    params = jqat.calibrate_weight_scales(params, parse_policy(POLICY))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    return cfg, params, tparams


def _req(uid, prompt, cls=Request, **kw):
    return cls(uid=uid, prompt=np.asarray(prompt, np.int32), **kw)


def _mixed_reqs(n=5, temperature=0.0, top_k=0, seed=3, cls=Request):
    rng = np.random.default_rng(7)
    return [_req(i, rng.integers(0, 250, int(rng.integers(6, 30))), cls,
                 max_new_tokens=int(rng.integers(3, 14)),
                 temperature=temperature, top_k=top_k, seed=seed)
            for i in range(n)]


ENGINE = dict(slots=4, cache_len=64, kv_layout="paged", block_size=8,
              num_blocks=64, max_seq_len=96, decode_block=4)


def _engine(served, spec, **kw):
    return ServeEngine(t_get_reduced_config("qwen2.5-3b"), served[2],
                       spec=spec, weights_layout="w4a8", device="cpu",
                       **{**ENGINE, **kw})


def _sabotage(eng, scale=40.0):
    """Give the draft an untied sharp random head: proposals diverge
    from the target and acceptance collapses (maximal rollback)."""
    eng.draft_cfg = eng.draft_cfg.replace(tie_embeddings=False)
    gen = torch.Generator().manual_seed(123)
    cfg = eng.cfg
    head = init_linear(gen, cfg.d_model, cfg.vocab_size)
    head["w"] = head["w"] * scale
    head["w4a8"] = export_linear_w4(head, eng.ctx.policy.head_bits)
    eng.draft_params = {**eng.draft_params, "head": head}


def _run(eng, reqs, max_steps=50_000):
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_drained(max_steps=max_steps)
    assert all(r.done for r in reqs)
    assert eng.alloc.allocated_blocks == 0
    eng.alloc.check()
    return [r.generated for r in reqs], stats


class TestTokenParity:
    def test_greedy_parity_and_counters(self, served):
        g_plain, _ = _run(_engine(served, None), _mixed_reqs())
        g_spec, st = _run(_engine(served, SpecConfig(k=3, draft_layers=1)),
                          _mixed_reqs())
        assert g_spec == g_plain
        assert st["spec_drafted"] > 0
        assert st["tokens_out"] == sum(len(g) for g in g_spec)

    def test_sampled_exact_mode_parity(self, served):
        kw = dict(temperature=1.5, top_k=0)
        g_plain, _ = _run(_engine(served, None), _mixed_reqs(**kw))
        g_spec, _ = _run(_engine(served, SpecConfig(k=3, draft_layers=1)),
                         _mixed_reqs(**kw))
        assert g_spec == g_plain

    @pytest.mark.parametrize("kw", [dict(), dict(temperature=1.5)])
    def test_adversarial_draft_parity_with_maximal_rollback(self, served,
                                                            kw):
        """A draft that is wrong every wave: acceptance 0, every wave
        rolls back its whole suffix, and the output is still plain
        decode's (greedy and hot-sampled)."""
        g_plain, _ = _run(_engine(served, None), _mixed_reqs(**kw))
        eng = _engine(served, SpecConfig(k=3, draft_layers=1))
        _sabotage(eng)
        g_spec, st = _run(eng, _mixed_reqs(**kw))
        assert g_spec == g_plain
        assert st["spec_accept_rate"] == 0.0
        assert st["spec_rolled_back"] == st["spec_drafted"] > 0

    def test_self_draft_accepts_everything(self, served):
        """The target as its own draft proposes plain decode's tokens:
        the accept rate is 1 and the streams are plain decode's."""
        cfg = served[0]
        g_plain, _ = _run(_engine(served, None), _mixed_reqs())
        g_spec, st = _run(
            _engine(served, SpecConfig(k=3, draft_layers=cfg.n_layers)),
            _mixed_reqs())
        assert g_spec == g_plain
        assert st["spec_accept_rate"] == 1.0

    def test_parity_with_shared_prefix_and_cow_mid_wave(self, served):
        """Prefix-hit followers share the warm chain's split block; the
        spec wave's writes COW it mid-run and the tokens still match the
        spec-off engine."""
        def shared(n=4):
            rng = np.random.default_rng(3)
            prefix = rng.integers(0, 250, 40).astype(np.int32)
            return [_req(i, np.concatenate(
                        [prefix, ((np.arange(5) * (i + 3) + i)
                                  % 250).astype(np.int32)]),
                        max_new_tokens=7, temperature=1.2, seed=11)
                    for i in range(n)]

        def staged(spec):
            eng = _engine(served, spec, slots=6, block_size=16,
                          num_blocks=48)
            rs = shared()
            _run(eng, rs[:1])
            g, st = _run(eng, rs[1:])
            return [rs[0].generated] + g, st

        g_plain, _ = staged(None)
        g_spec, st = staged(SpecConfig(k=3, draft_layers=1))
        assert g_spec == g_plain
        assert st["cow_copies"] >= 3 and st["prefix_hit_tokens"] > 0

    def test_sampled_preempt_swap_resume_parity(self, served):
        """Tight pool + optimistic admission: spec residents are swapped
        out mid-stream (the draft cache is rebuilt from tokens on
        restore) and still produce the uninterrupted solo stream."""
        def mk(uid, plen, mn):
            return _req(uid, (np.arange(plen) * 7 + uid) % 250,
                        max_new_tokens=mn, temperature=0.7, top_k=8, seed=5)

        solo_req = mk(9, 10, 30)
        _run(_engine(served, None, slots=1, num_blocks=32), [solo_req])
        eng = _engine(served, SpecConfig(k=3, draft_layers=1), num_blocks=8,
                      admission="optimistic", prefix_cache=False)
        reqs = [mk(0, 10, 30), mk(9, 10, 30), mk(2, 10, 30)]
        _, st = _run(eng, reqs)
        assert st["preemptions"] >= 1
        assert st["swap_out_bytes"] == st["swap_in_bytes"] > 0
        assert reqs[1].generated == solo_req.generated

    def test_eos_inside_window_stops_like_plain_decode(self, served):
        """An EOS landing mid-window truncates the commit at it, exactly
        where plain decode stops."""
        g_plain, _ = _run(_engine(served, None),
                          _mixed_reqs(n=3, temperature=1.5))
        eos = g_plain[0][min(2, len(g_plain[0]) - 1)]

        def with_eos():
            rs = _mixed_reqs(n=3, temperature=1.5)
            for r in rs:
                r.eos_id = int(eos)
            return rs

        ge_plain, _ = _run(_engine(served, None), with_eos())
        ge_spec, _ = _run(_engine(served, SpecConfig(k=4, draft_layers=1)),
                          with_eos())
        assert ge_spec == ge_plain
        assert any(len(a) < len(b) for a, b in zip(ge_plain, g_plain))

    @pytest.mark.parametrize("temperature", [0.0, 1.5])
    def test_streams_and_counters_match_reference_engine(self, served,
                                                         temperature):
        """Short prompts through the JAX paged engine with the same spec
        config: the same streams and spec counters."""
        cfg, params, _ = served
        kw = dict(slots=2, cache_len=32, kv_layout="paged", block_size=8,
                  num_blocks=16, max_seq_len=32, decode_block=4)
        spec = dict(k=2, draft_layers=1)

        def reqs(cls):
            return [_req(i, (np.arange(n) * 5 + 3 * i) % 250, cls,
                         max_new_tokens=6, temperature=temperature, seed=2)
                    for i, n in enumerate((5, 11))]

        jeng = JServeEngine(cfg, params, weights_layout="w4a8",
                            w4a8_backend="ref",
                            spec=jspec.SpecConfig(**spec), **kw)
        jr = reqs(JRequest)
        for r in jr:
            jeng.submit(r)
        ref = jeng.run_until_drained()
        eng = _engine(served, SpecConfig(**spec), **kw)
        tr = reqs(Request)
        got, st = _run(eng, tr)
        assert got == [r.generated for r in jr]
        for k in ("spec_waves", "spec_drafted", "spec_accepted",
                  "spec_rolled_back", "spec_draft_prefill_tokens",
                  "tokens_out", "decode_steps"):
            assert st[k] == ref[k], k


class TestVerifyWave:
    def test_verify_logits_equal_sequential_decode(self, served):
        """``spec_verify`` over a window against C ``decode_step`` calls
        consuming the same tokens: bitwise equal logits and pools."""
        tcfg = t_get_reduced_config("qwen2.5-3b")
        eng = _engine(served, None)
        params, ctx = eng.params, eng.ctx
        S, bs, NB, T, C = 3, 8, 40, 8, 5
        cache = init_cache(tcfg, ctx, S, 64, device="cpu", num_blocks=NB,
                           page_size=bs, table_len=T)
        rng = np.random.default_rng(0)
        tbl = torch.from_numpy(rng.permutation(NB)[:S * T].reshape(S, T)
                               ).to(torch.int32)
        cache["block_tbl"].copy_(tbl)
        lens = [13, 5, 20]
        toks = torch.zeros((S, 32), dtype=torch.int32)
        for s, n in enumerate(lens):
            toks[s, :n] = torch.from_numpy(rng.integers(0, 250, n))
        _, cn = prefill(tcfg, params, ctx,
                        {"tokens": toks,
                         "lengths": torch.tensor(lens, dtype=torch.int32)},
                        page_size=bs)
        for dst, src in zip(cache["layers"], cn["layers"]):
            for k in ("k_q", "v_q", "s_k", "s_v"):
                dst[k][tbl[:, :32 // bs].long()] = src[k]
            dst["length"].copy_(src["length"])
        cache["position"].copy_(cn["position"])
        window = torch.from_numpy(rng.integers(0, 250, (S, C))).to(
            torch.int32)
        seq_cache = clone_cache(cache)
        seq = []
        for j in range(C):
            lg, seq_cache = decode_step(tcfg, params, ctx, window[:, j:j + 1],
                                        seq_cache)
            seq.append(lg[:, 0])
        ver_cache = clone_cache(cache)
        vl, ver_cache = spec_verify(
            tcfg, params, ctx, window, ver_cache,
            torch.arange(S, dtype=torch.int32),
            ver_cache["position"].clone(),
            torch.full((S,), C, dtype=torch.int32), hist_blocks=T)
        assert torch.equal(vl, torch.stack(seq, dim=1))
        for k in seq_cache["pool"]:
            assert torch.equal(seq_cache["pool"][k][:, :NB],
                               ver_cache["pool"][k][:, :NB]), k
        assert torch.equal(seq_cache["position"], ver_cache["position"])

    @pytest.mark.parametrize("bs", [8, 16])
    def test_plain_version_matches_reference_and_pallas(self, bs):
        """The plain verify attention against the reference's XLA version
        and its Pallas kernel (interpret mode): per-query extents, a
        window straddling a block boundary, sentinels and a parked row."""
        B, C, H, Hkv, D, T = 4, 5, 4, 2, 16, 4
        NB = B * T + 3
        rng = np.random.default_rng(bs)
        k = rng.integers(-127, 128, (NB, Hkv, bs, D)).astype(np.int8)
        v = rng.integers(-127, 128, (NB, Hkv, bs, D)).astype(np.int8)
        sk = rng.uniform(0.01, 0.2, (NB, Hkv, bs)).astype(np.float32)
        sv = rng.uniform(0.01, 0.2, (NB, Hkv, bs)).astype(np.float32)
        hist = [T * bs - C, None, bs - 2, bs + 3]
        lens = np.array([[0] * C if h is None else [h + 1 + c
                                                     for c in range(C)]
                         for h in hist], np.int32)
        tbl = rng.permutation(NB)[:B * T].reshape(B, T).astype(np.int32)
        used = -(-lens.max(axis=1) // bs)
        tbl = np.where(np.arange(T)[None] < used[:, None], tbl, NB)
        q = jnp.asarray(rng.standard_normal((B, C, H, D)),
                        jnp.bfloat16)
        jargs = [q] + [jnp.asarray(a) for a in (k, v, sk, sv, tbl, lens)]
        want_ref = np.asarray(jref.kvq_spec_verify_attn_ref(*jargs),
                              np.float32)
        want_pallas = np.asarray(jops.kvq_spec_verify_attn(
            *jargs, use_pallas=True), np.float32)

        def sink(a):
            return torch.from_numpy(np.concatenate(
                [a, np.zeros((1,) + a.shape[1:], a.dtype)]))

        tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(
            torch.bfloat16)
        got = kvq_spec_verify_attn_ref(
            tq, sink(k), sink(v), sink(sk), sink(sv), torch.from_numpy(tbl),
            torch.from_numpy(lens)).float().numpy()
        assert got.shape == (B, C, H, D)
        assert np.isfinite(got).all() and not got[1].any()
        np.testing.assert_allclose(got, want_ref, rtol=2 ** -7, atol=1e-4)
        np.testing.assert_allclose(got, want_pallas, rtol=2 ** -7,
                                   atol=1e-4)

    @pytest.mark.parametrize("bs", [16, 48, 64, 24])
    def test_plain_version_at_split_boundaries(self, bs):
        """The plain verify attention against the reference's XLA version
        and its Pallas kernel (interpret mode) on windows around the CUDA
        kernels' split boundary (``ops.SPLIT``): one straddling it, one
        ending on a multiple of it, one starting right after it, and a
        parked row; one bf16 ulp as above."""
        from repro_torch.kernels.kvq_attn.ops import SPLIT as S
        B, C, H, Hkv, D = 4, 5, 4, 2, 16
        hist = [S - 3, 2 * S - 5, None, S]
        lens = np.array([[0] * C if h is None else [h + 1 + c
                                                     for c in range(C)]
                         for h in hist], np.int32)
        T = -(-int(lens.max()) // bs)
        NB = B * T + 3
        rng = np.random.default_rng(bs + 1)
        k = rng.integers(-127, 128, (NB, Hkv, bs, D)).astype(np.int8)
        v = rng.integers(-127, 128, (NB, Hkv, bs, D)).astype(np.int8)
        sk = rng.uniform(0.01, 0.2, (NB, Hkv, bs)).astype(np.float32)
        sv = rng.uniform(0.01, 0.2, (NB, Hkv, bs)).astype(np.float32)
        tbl = rng.permutation(NB)[:B * T].reshape(B, T).astype(np.int32)
        used = -(-lens.max(axis=1) // bs)
        tbl = np.where(np.arange(T)[None] < used[:, None], tbl, NB)
        q = jnp.asarray(rng.standard_normal((B, C, H, D)), jnp.bfloat16)
        jargs = [q] + [jnp.asarray(a) for a in (k, v, sk, sv, tbl, lens)]

        def sink(a):
            return torch.from_numpy(np.concatenate(
                [a, np.zeros((1,) + a.shape[1:], a.dtype)]))

        tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(
            torch.bfloat16)
        got = kvq_spec_verify_attn_ref(
            tq, sink(k), sink(v), sink(sk), sink(sv), torch.from_numpy(tbl),
            torch.from_numpy(lens)).float().numpy()
        assert np.isfinite(got).all() and not got[2].any()
        for want in (jref.kvq_spec_verify_attn_ref(*jargs),
                     jops.kvq_spec_verify_attn(*jargs, use_pallas=True)):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=2 ** -7, atol=1e-4)


class TestRejectionSampling:
    def test_self_draft_rejection_reproduces_plain_decode(self, served):
        """Self-draft + coupled keys: p == q, every proposal survives the
        rejection test, and the sampled stream equals plain decode."""
        cfg = served[0]
        kw = dict(temperature=1.2, top_k=8)
        g_plain, _ = _run(_engine(served, None), _mixed_reqs(**kw))
        spec = SpecConfig(k=3, draft_layers=cfg.n_layers,
                          accept_mode="rejection")
        g_spec, st = _run(_engine(served, spec), _mixed_reqs(**kw))
        assert g_spec == g_plain
        assert st["spec_accept_mode"] == "rejection"

    def test_rejection_preserves_target_distribution(self):
        """The acceptance math on synthetic p/q over a tiny vocabulary:
        the committed-token distribution at the first position matches
        sampling from p directly (total variation < 2%)."""
        V, N = 8, 20_000
        rng = np.random.default_rng(0)
        p_row = torch.from_numpy(rng.dirichlet(np.ones(V)).astype(np.float32))
        q_row = torch.from_numpy(rng.dirichlet(np.ones(V)).astype(np.float32))
        keys = torch.stack([torch.zeros(N, dtype=torch.int64),
                            torch.arange(N, dtype=torch.int64)], dim=1)
        n_gen = torch.zeros((N,), dtype=torch.int32)
        step0 = tsampling.fold_step(keys, n_gen)
        draft = tsampling.categorical(
            step0, torch.log(q_row).expand(N, V)).to(torch.int32)[:, None]
        target = tsampling.categorical(
            step0, torch.log(p_row).expand(N, V)).to(torch.int32)[:, None]
        target = torch.cat([target, target], dim=1)
        n_acc, committed = accept_rejection(
            draft, q_row.expand(N, 1, V), p_row.expand(N, 2, V), target,
            keys, n_gen, torch.ones((N,), dtype=torch.int32))
        emp = np.bincount(committed[:, 0].numpy(), minlength=V) / N
        tv = 0.5 * np.abs(emp - p_row.numpy()).sum()
        assert tv < 0.02, f"total variation {tv:.3f} vs target p"
        acc = float((n_acc > 0).float().mean())
        assert abs(acc - float(torch.minimum(p_row, q_row).sum())) < 0.02

    def _wave_inputs(self, S=6, k=3, V=32, seed=0):
        rng = np.random.default_rng(seed)
        p = rng.dirichlet(np.ones(V) * 0.3, (S, k + 1)).astype(np.float32)
        q = rng.dirichlet(np.ones(V) * 0.3, (S, k)).astype(np.float32)
        draft = rng.integers(0, V, (S, k)).astype(np.int32)
        draft[::2] = np.argmax(p[::2, :k], -1)    # some rows match
        target = rng.integers(0, V, (S, k + 1)).astype(np.int32)
        target[1::3, :k] = draft[1::3]
        seeds = rng.integers(0, 2 ** 31, S)
        keys = np.stack([np.asarray(jax.random.PRNGKey(int(s)))
                         for s in seeds]).astype(np.uint32)
        n_gen = rng.integers(0, 20, S).astype(np.int32)
        n_draft = np.array([k, k, 1, 0, 2, k][:S], np.int32)
        return draft, q, p, target, keys, n_gen, n_draft

    def test_accept_exact_matches_reference(self):
        draft, _, _, target, _, _, n_draft = self._wave_inputs()
        want = np.asarray(jspec.accept_exact(
            jnp.asarray(draft), jnp.asarray(target), jnp.asarray(n_draft)))
        got = accept_exact(torch.from_numpy(draft), torch.from_numpy(target),
                           torch.from_numpy(n_draft))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_accept_rejection_matches_reference(self, seed):
        draft, q, p, target, keys, n_gen, n_draft = self._wave_inputs(
            seed=seed)
        j_acc, j_com = jspec.accept_rejection(
            *(jnp.asarray(a) for a in (draft, q, p, target, keys, n_gen,
                                       n_draft)))
        t_acc, t_com = accept_rejection(
            torch.from_numpy(draft), torch.from_numpy(q),
            torch.from_numpy(p), torch.from_numpy(target),
            torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(n_gen), torch.from_numpy(n_draft))
        np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
        np.testing.assert_array_equal(t_com.numpy(), np.asarray(j_com))

    def test_token_probs_and_fold_keys_match_reference(self):
        rng = np.random.default_rng(4)
        logits = rng.standard_normal((4, 40)).astype(np.float32) * 3
        temp = np.array([0.0, 0.7, 1.5, 1.0], np.float32)
        top_k = np.array([0, 0, 5, 1], np.int32)
        want = np.asarray(jsampling.token_probs(
            jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k)))
        got = tsampling.token_probs(torch.from_numpy(logits),
                                    torch.from_numpy(temp),
                                    torch.from_numpy(top_k)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got[0], np.eye(40)[logits[0].argmax()])
        keys = np.stack([np.asarray(jax.random.PRNGKey(s))
                         for s in (1, 2, 3)]).astype(np.uint32)
        want_k = np.asarray(jax.vmap(lambda kk: jax.random.fold_in(
            kk, 0x5BEC))(jnp.asarray(keys)))
        got_k = tsampling.fold_keys(torch.from_numpy(keys.astype(np.int64)),
                                    0x5BEC).numpy()
        np.testing.assert_array_equal(got_k, want_k.astype(np.int64))


class TestRollbackAccounting:
    def test_written_and_trim_track_accepted_extent(self, served):
        """After every spec step ``_written`` equals the device counters
        and the slot owns exactly the blocks covering it (the wave's
        over-allocation was trimmed)."""
        eng = _engine(served, SpecConfig(k=3, draft_layers=1))
        _sabotage(eng)                  # rejections: real rollback
        reqs = _mixed_reqs(n=3, temperature=1.5)
        for r in reqs:
            eng.submit(r)
        for _ in range(60):
            eng.step()
            n_gen = eng.state["n_gen"].numpy()
            pos = eng.state["cache"]["position"].numpy()
            for s, r in eng._slot_req.items():
                w = len(r.prompt) + int(n_gen[s]) - 1
                assert eng._written[s] == w == int(pos[s])
                assert len(eng.alloc.owned(s)) == \
                    eng.alloc.blocks_for_tokens(w)
                for layer in eng.state["cache"]["layers"]:
                    assert int(layer["length"][s]) == w
            eng.alloc.check()
            if all(r.done for r in reqs):
                break
        assert all(r.done for r in reqs)

    def test_finished_at_admission_residents_drain_and_do_not_skew_stats(
            self, served):
        """Requests that finish at prefill (max_new == 1) never enter a
        wave: they are still harvested, and count as neither drafted nor
        rolled back."""
        eng = _engine(served, SpecConfig(k=3, draft_layers=1))
        one = [_req(i, np.arange(6) + i, max_new_tokens=1)
               for i in range(3)]
        g, st = _run(eng, one, max_steps=200)
        assert [len(x) for x in g] == [1, 1, 1]
        assert st["spec_drafted"] == st["spec_accepted"] == 0
        eng2 = _engine(served, SpecConfig(k=3, draft_layers=1))
        base, st_base = _run(_engine(served, SpecConfig(k=3, draft_layers=1)),
                             _mixed_reqs(n=3))
        reqs = _mixed_reqs(n=3) + [_req(9, np.arange(5), max_new_tokens=1)]
        g2, st2 = _run(eng2, reqs, max_steps=500)
        assert g2[:3] == base
        assert st2["spec_accept_rate"] == st_base["spec_accept_rate"]

    def test_trim_matches_reference_allocator(self):
        """The port's ``BlockAllocator.trim`` (rollback) against the
        reference's on one sequence of grow / share / trim / release, with
        a shared prefix chain and a reserve debit: equal tables, free
        blocks, refcount checks and released counts."""
        from repro.serve.block_alloc import BlockAllocator as JAlloc
        from repro_torch.serve.block_alloc import BlockAllocator as TAlloc
        prompt = np.arange(20, dtype=np.int32)
        allocs = [cls(num_blocks=12, block_size=4, slots=3, table_len=8,
                      prefix_cache=True) for cls in (JAlloc, TAlloc)]
        trace = []
        for a in allocs:
            out = []
            a.reserve(0, 30)
            a.ensure(0, 20)
            a.register_prefix(0, prompt, 20)
            hit = a.lookup(np.concatenate([prompt, [7, 7]]))
            a.register(1, shared=hit[0])
            a.ensure(1, 31)
            out.append(a.trim(1, 21))           # rollback past the shared
            a.ensure(0, 29)
            out.append(a.trim(0, 22))           # inside a fresh block
            out.append(a.trim(0, 22))           # idempotent
            out.append(a.release(1))
            a.check()
            out.append((a.tables.copy(), a.free_blocks, a.allocated_blocks,
                        list(a.owned(0))))
            trace.append(out)
        (jt, tt) = trace
        assert jt[:4] == tt[:4]
        np.testing.assert_array_equal(jt[4][0], tt[4][0])
        assert jt[4][1:] == tt[4][1:]

    def test_stats_counters_consistent(self, served):
        g, st = _run(_engine(served, SpecConfig(k=3, draft_layers=1)),
                     _mixed_reqs())
        assert st["spec_drafted"] == st["spec_accepted"] \
            + st["spec_rolled_back"]
        assert st["spec_waves"] > 0
        assert st["spec_k"] == 3 and st["spec_draft_layers"] == 1
        assert st["decode_block_mode"] == "spec"
        assert st["decode_block"] == 4
        assert st["tokens_out"] == sum(len(x) for x in g)


class TestDraftConstruction:
    def test_make_draft_shares_embeddings_and_slices_layers(self, served):
        cfg, _, tparams = served
        tcfg = t_get_reduced_config("qwen2.5-3b")
        dcfg, dparams = make_draft(tcfg, tparams, SpecConfig(draft_layers=1))
        assert dcfg.n_layers == 1
        assert dparams["embed"] is tparams["embed"]      # shared, not copied
        assert dparams["head"] is tparams["head"]
        assert dparams["final_norm"] is tparams["final_norm"]
        assert len(dparams["layers"]) == 1
        assert dparams["layers"][0] is tparams["layers"][0]
        jcfg, _ = jspec.make_draft(cfg, served[1],
                                   jspec.SpecConfig(draft_layers=1))
        assert jcfg.n_layers == dcfg.n_layers
        assert SpecConfig().resolved_layers(tcfg) == \
            jspec.SpecConfig().resolved_layers(cfg)

    def test_self_draft_is_the_target_verbatim(self, served):
        tcfg = t_get_reduced_config("qwen2.5-3b")
        dcfg, dparams = make_draft(tcfg, served[2],
                                   SpecConfig(draft_layers=tcfg.n_layers))
        assert dcfg is tcfg and dparams is served[2]

    def test_spec_requires_paged_layout(self, served):
        with pytest.raises(ValueError, match="paged"):
            ServeEngine(t_get_reduced_config("qwen2.5-3b"), served[2],
                        slots=2, cache_len=64, spec=SpecConfig(k=2),
                        device="cpu")

    def test_invalid_spec_config(self):
        with pytest.raises(ValueError, match="k must be"):
            SpecConfig(k=0)
        with pytest.raises(ValueError, match="accept_mode"):
            SpecConfig(accept_mode="maybe")
        with pytest.raises(ValueError, match="draft_layers"):
            SpecConfig(draft_layers=99).resolved_layers(
                t_get_reduced_config("qwen2.5-3b"))
