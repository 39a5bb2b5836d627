"""The port's paged quantized KV cache on the CPU: the plain versions of
its three kernels against the JAX package (its XLA references and its
Pallas kernels in interpret mode), the port's copy of the block
allocator, the paged engine's lifecycle, and paged serving against the
dense layout inside the port and against the JAX paged engine.

Tolerances: the gather and the block copy move or multiply values once,
so they must be bitwise equal. Decode attention computes in f32 and
differs from the Pallas kernel only in summation order: within 2e-5
(rtol and atol), the reference's own kernel-vs-XLA tolerance. Paged and
dense decode are bitwise equal inside the port (both take the dense
plain path on the CPU). Against the JAX paged engine run op by op
(``jax.disable_jit``) the block tables, counters, greedy streams, pools
and one decode step's logits are bitwise equal (measured: 0 of 512
logits and 0 codes differ). Until the port's CPU ``rms_norm`` summed
the variance in XLA:CPU's order and took a correctly rounded rsqrt
(``repro_torch/models/common.py``), one bf16 element of layer 0's norm
(token 7 of the warm prompt) came out one ulp apart, the int8
requantization spread it over the pools, and the logits sat 2.87e-2
relative L2 from the op-by-op engine under a 5e-2 bound. The compiled
engine fuses and contracts ops (FMA), which moves ulps the same way
(2.66e-2 from the port, and the last greedy token of request 1 flips),
so the engine is held to its op-by-op run.

Port pool leaves carry one extra trailing block, the write sink for
sentinel destinations (``repro_torch/kernels/kvq_attn/ref.py``); pools
built here append it, and every comparison reads ``pool[:NB]``.
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
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.kernels.kvq_attn import ops, ref
from repro_torch.models import clone_cache, decode_step, init_params
from repro_torch.models.blocks import POOL_KEYS
from repro_torch.serve.block_alloc import BlockAllocator
from repro_torch.serve.engine import Request, ServeEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_sink(a: np.ndarray, axis: int = 0) -> torch.Tensor:
    """A port pool leaf from a reference pool: one zero block appended."""
    shape = list(a.shape)
    shape[axis] = 1
    return torch.from_numpy(np.concatenate([a, np.zeros(shape, a.dtype)],
                                           axis=axis))


def _rand_pool(seed, NB, Hkv, bs, D):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (NB, Hkv, bs, D)).astype(np.int8)
    v = rng.integers(-127, 128, (NB, Hkv, bs, D)).astype(np.int8)
    sk = rng.uniform(0.01, 0.2, (NB, Hkv, bs)).astype(np.float32)
    sv = rng.uniform(0.01, 0.2, (NB, Hkv, bs)).astype(np.float32)
    return k, v, sk, sv


# --------------------------------------------------------------------------
# the plain versions of the kernels
# --------------------------------------------------------------------------

class TestPagedKernelParity:
    # (B, H, Hkv, D, bs, NB, table, lengths): the reference test's case
    # with a parked (all-sentinel, length 0) row added, and the full-width
    # head geometry at the tests' block size
    CASES = [
        (4, 4, 2, 16, 8, 10,
         [[7, 2, 9, 0], [1, 4, 6, 8], [3, 5, 10, 10], [10, 10, 10, 10]],
         [32, 21, 10, 0]),
        (3, 16, 2, 128, 16, 12,
         [[11, 0, 5], [2, 9, 12], [12, 12, 12]], [48, 17, 0]),
    ]

    @pytest.mark.parametrize("case", CASES)
    def test_paged_decode_matches_reference_and_pallas(self, case):
        B, H, Hkv, D, bs, NB, tbl, lens = case
        k, v, sk, sv = _rand_pool(B, NB, Hkv, bs, D)
        q = np.random.default_rng(9).standard_normal((B, H, D)).astype(
            np.float32)
        tbl = np.asarray(tbl, np.int32)
        lens = np.asarray(lens, np.int32)
        jargs = [jnp.asarray(a) for a in (q, k, v, sk, sv, tbl, lens)]
        want_ref = np.asarray(jref.kvq_paged_decode_attn_ref(*jargs))
        want_pallas = np.asarray(jops.kvq_paged_decode_attn(*jargs))
        got = ops.kvq_paged_decode_attn(
            torch.from_numpy(q), _with_sink(k), _with_sink(v),
            _with_sink(sk), _with_sink(sv), torch.from_numpy(tbl),
            torch.from_numpy(lens)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want_pallas, rtol=2e-5, atol=2e-5)
        assert not got[lens == 0].any()          # a parked row is zeros

    def test_sentinel_blocks_and_sink_do_not_leak_into_output(self):
        """Scribbling on every block the slot does not own, the sink
        included, leaves its output bit-identical."""
        B, H, Hkv, D, bs, NB = 1, 2, 1, 8, 4, 6
        k, v, sk, sv = _rand_pool(3, NB, Hkv, bs, D)
        q = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (B, H, D)).astype(np.float32))
        tbl = torch.tensor([[2, 4, NB, NB]], dtype=torch.int32)
        lens = torch.tensor([bs + 1], dtype=torch.int32)
        kp = _with_sink(k)
        rest = (_with_sink(v), _with_sink(sk), _with_sink(sv), tbl, lens)
        out = ops.kvq_paged_decode_attn(q, kp, *rest)
        scrib = kp.clone()
        for b in range(NB + 1):
            if b not in (2, 4):
                scrib[b] = 77
        out2 = ops.kvq_paged_decode_attn(q, scrib, *rest)
        assert torch.equal(out, out2)

    @pytest.mark.parametrize("bs,T", [(4, 3), (16, 5)])
    def test_gather_dequant_bitwise(self, bs, T):
        NB, Hkv, D = 9, 2, 32
        k, _, sk, _ = _rand_pool(bs, NB, Hkv, bs, D)
        tbl = np.array([[5, 1, 3, 0, 8][:T], [8, 7, NB, NB, NB][:T]],
                       np.int32)
        want = np.asarray(jops.gather_dequant_paged_kv(
            jnp.asarray(k), jnp.asarray(sk), jnp.asarray(tbl),
            use_pallas=False))
        want_pallas = np.asarray(jops.gather_dequant_paged_kv(
            jnp.asarray(k), jnp.asarray(sk), jnp.asarray(tbl),
            use_pallas=True))
        got = ops.gather_dequant_paged_kv(_with_sink(k), _with_sink(sk),
                                          torch.from_numpy(tbl)).numpy()
        assert got.shape == (2, Hkv, T * bs, D) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, want_pallas)
        # the plain gather itself, by hand
        g = ref.gather_paged_kv(_with_sink(k), torch.from_numpy(tbl))
        np.testing.assert_array_equal(g[0, :, :bs].numpy(), k[5])
        np.testing.assert_array_equal(
            ref.gather_paged_kv(_with_sink(sk), torch.from_numpy(tbl))
            [1, :, 2 * bs:3 * bs].numpy(), sk[NB - 1])   # sentinel clamps

    # (n, T, bs, table): shapes ragged against the CUDA kernel's tiling
    # (16-row parts of a (bs, D) tile), as the card's check runs them: one
    # entry of a 16-token block; sentinel entries (>= NB) past each row's
    # extent and a row of sentinels only
    RAGGED = [(1, 1, 16, [[6]]),
              (3, 5, 64, [[5, 1, 3, 0, 8], [8, 7, 9, 9, 12],
                          [9, 9, 9, 9, 9]])]

    @pytest.mark.parametrize("n,T,bs,tbl", RAGGED)
    def test_gather_dequant_bitwise_on_ragged_tables(self, n, T, bs, tbl):
        """The plain gather (one leaf, and K and V through one table as
        the tail-wave calls it) bitwise against the reference's XLA
        gather and its Pallas kernel (interpret mode), which is given the
        table clamped as its wrapper clamps sentinels."""
        NB, Hkv, D = 9, 2, 32
        k, v, sk, sv = _rand_pool(n * T + bs, NB, Hkv, bs, D)
        tbl = np.array(tbl, np.int32)
        assert tbl.shape == (n, T)
        want = [np.asarray(jops.gather_dequant_paged_kv(
            jnp.asarray(p), jnp.asarray(s), jnp.asarray(tbl),
            use_pallas=pallas)) for p, s in ((k, sk), (v, sv))
            for pallas in (False, True)]
        ttbl = torch.from_numpy(tbl)
        one = [ops.gather_dequant_paged_kv(_with_sink(p), _with_sink(s),
                                           ttbl).numpy()
               for p, s in ((k, sk), (v, sv))]
        pair = ops.gather_dequant_paged_kv_pair(
            _with_sink(k), _with_sink(sk), _with_sink(v), _with_sink(sv),
            ttbl)
        for i, (o, pr) in enumerate(zip(one, pair)):
            assert o.shape == (n, Hkv, T * bs, D) and o.dtype == np.float32
            np.testing.assert_array_equal(o, want[2 * i])
            np.testing.assert_array_equal(o, want[2 * i + 1])
            np.testing.assert_array_equal(pr.numpy(), o)
        # a sentinel entry reads the last real block, clamped
        if (tbl >= NB).any():
            r, t = map(int, np.argwhere(tbl >= NB)[0])
            np.testing.assert_array_equal(
                one[0][r, :, t * bs:(t + 1) * bs],
                k[NB - 1].astype(np.float32) * sk[NB - 1][..., None])

    def test_pool_block_copy_bitwise(self):
        """The COW clone against the reference's Pallas kernel
        (interpret mode) and XLA scatter: pad pairs (dst >= NB) are
        dropped and untouched blocks preserved."""
        rep, NB, Hkv, bs, D = 2, 6, 2, 4, 8
        rng = np.random.default_rng(4)
        kp = rng.integers(-127, 128, (rep, NB, Hkv, bs, D)).astype(np.int8)
        sk = rng.random((rep, NB, Hkv, bs)).astype(np.float32)
        src = np.array([4, 0, 0], np.int32)
        dst = np.array([1, 5, NB], np.int32)        # last pair = padding
        for pool in (kp, sk):
            want = np.asarray(jops.copy_pool_blocks(
                jnp.asarray(pool), jnp.asarray(src), jnp.asarray(dst),
                use_pallas=True))
            np.testing.assert_array_equal(want, np.asarray(
                jref.copy_pool_blocks_ref(jnp.asarray(pool),
                                          jnp.asarray(src),
                                          jnp.asarray(dst))))
            leaf = _with_sink(pool, axis=1)
            out = ops.copy_pool_blocks(leaf, torch.from_numpy(src),
                                       torch.from_numpy(dst))
            assert out is leaf                      # in place
            np.testing.assert_array_equal(leaf[:, :NB].numpy(), want)

    @pytest.mark.parametrize("pallas", [True, False])
    def test_pool_block_copy_multi_bitwise(self, pallas):
        """The multi-leaf COW clone's plain version on a four-leaf pool
        (int8 k_q/v_q, f32 s_k/s_v) against the JAX ``copy_pool_blocks``
        applied leaf by leaf: the Pallas kernel (interpret mode) on
        in-range pairs with a padding pair, the XLA reference also with a
        src past the pool (clamped to NB - 1); bitwise."""
        rep, NB, Hkv, bs, D = 2, 7, 2, 4, 8
        rng = np.random.default_rng(9)
        pools = [rng.integers(-127, 128, (rep, NB, Hkv, bs, D)).astype(
                     np.int8) for _ in range(2)]
        pools += [rng.random((rep, NB, Hkv, bs)).astype(np.float32)
                  for _ in range(2)]
        if pallas:
            pairs = np.array([[4, 0, 0], [1, 5, NB]], np.int32)
        else:
            pairs = np.array([[4, 0, NB + 3, 0], [1, 5, 2, NB]], np.int32)
        want = [np.asarray(jops.copy_pool_blocks(
            jnp.asarray(pool), jnp.asarray(pairs[0]), jnp.asarray(pairs[1]),
            use_pallas=pallas)) for pool in pools]
        leaves = [_with_sink(pool, axis=1) for pool in pools]
        out = ops.copy_pool_blocks_multi(leaves, torch.from_numpy(pairs))
        assert len(out) == 4 and all(o is x for o, x in zip(out, leaves))
        for leaf, w, pool in zip(leaves, want, pools):
            np.testing.assert_array_equal(leaf[:, :NB].numpy(), w)
            assert not np.array_equal(w, pool)      # the clone happened

    def test_pool_block_copy_multi_refuses_bad_leaf_counts(self):
        """One to ``MAX_COPY_LEAVES`` leaves, on every device."""
        pairs = torch.zeros((2, 1), dtype=torch.int32)
        leaf = torch.zeros((2, 3, 4), dtype=torch.int8)
        for leaves in ([], [leaf] * (ops.MAX_COPY_LEAVES + 1)):
            with pytest.raises(ValueError, match="leaves"):
                ops.copy_pool_blocks_multi(leaves, pairs)
        with pytest.raises(ValueError, match="cpu or cuda"):
            ops.copy_pool_blocks_multi([leaf.to("meta")], pairs.to("meta"))

    def test_commit_chunk_kv_matches_reference(self):
        """The tail-wave's plain scatter commit: per-row offsets, a
        padding position past chunk_len, writes into the sink only."""
        NB, Hkv, bs, D, C = 6, 2, 4, 8, 3
        k, v, sk, sv = _rand_pool(5, NB, Hkv, bs, D)
        rng = np.random.default_rng(6)
        kq1 = rng.integers(-127, 128, (2, Hkv, C, D)).astype(np.int8)
        vq1 = rng.integers(-127, 128, (2, Hkv, C, D)).astype(np.int8)
        s1 = rng.random((2, Hkv, C)).astype(np.float32)
        tbl = np.array([[3, 1, NB], [0, 5, 2]], np.int32)
        off = np.array([2, 5], np.int32)
        cl = np.array([3, 2], np.int32)
        jcache = {"k_q": jnp.asarray(k), "v_q": jnp.asarray(v),
                  "s_k": jnp.asarray(sk), "s_v": jnp.asarray(sv)}
        want = jops.commit_chunk_kv(jcache, *(jnp.asarray(a) for a in (
            kq1, vq1, s1, s1, tbl, off, cl)))
        cache = {"k_q": _with_sink(k), "v_q": _with_sink(v),
                 "s_k": _with_sink(sk), "s_v": _with_sink(sv)}
        ops.commit_chunk_kv(cache, *(torch.from_numpy(a) for a in (
            kq1, vq1, s1, s1, tbl, off, cl)))
        for key in cache:
            np.testing.assert_array_equal(cache[key][:NB].numpy(),
                                          np.asarray(want[key]))


# --------------------------------------------------------------------------
# the plain paged decode around the CUDA kernel's split boundaries
# --------------------------------------------------------------------------

S = ops.SPLIT
NG = 16         # splits a first-level merger takes (csrc/kvq_paged_split.cuh)


class TestPagedPlainAtSplitBoundaries:
    """The plain paged decode against the reference (its XLA version and
    its Pallas kernel in interpret mode) at lengths on and around the
    split boundaries, block sizes dividing SPLIT, equal to it, above it
    and not dividing it; the group boundary (NG splits, where the CUDA
    kernel's second merge level starts) and one-token blocks against the
    XLA version. Same tolerance as ``TestPagedKernelParity`` (2e-5)."""

    @pytest.mark.parametrize("bs,lens,pallas", [
        (16, (0, 1, S - 1, S, S + 1, 3 * S), True),
        (48, (S + 1, 0, S, 1, 3 * S, S - 1), True),
        (16, (NG * S, NG * S + 1, 2 * S, 0), False),
        (64, (S, 2 * S, 2 * S + 1, 0), True),
        (128, (S - 1, S + 1, 4 * S, 0), True),
        (24, (3 * S, S - 1, 0, S + 1), True),
        (16, (NG * S - 1, 0, 1, (NG + 1) * S), False),
        (1, (0, 1, S - 1, S, S + 1, 2 * S), False),
    ])
    def test_plain_matches_reference_at_split_boundaries(self, bs, lens,
                                                         pallas):
        B, H, Hkv, D = len(lens), 4, 2, 16
        T = -(-max(lens) // bs)
        NB = B * T + 3
        k, v, sk, sv = _rand_pool(bs + len(lens), NB, Hkv, bs, D)
        rng = np.random.default_rng(bs)
        q = rng.standard_normal((B, H, D)).astype(np.float32)
        tbl = rng.permutation(NB)[:B * T].reshape(B, T).astype(np.int32)
        used = -(-np.asarray(lens) // bs)
        tbl = np.where(np.arange(T)[None] < used[:, None], tbl, NB)
        lens = np.asarray(lens, np.int32)
        jargs = [jnp.asarray(a) for a in (q, k, v, sk, sv, tbl, lens)]
        got = ops.kvq_paged_decode_attn(
            torch.from_numpy(q), _with_sink(k), _with_sink(v),
            _with_sink(sk), _with_sink(sv), torch.from_numpy(tbl),
            torch.from_numpy(lens)).numpy()
        assert np.isfinite(got).all() and not got[lens == 0].any()
        np.testing.assert_allclose(
            got, np.asarray(jref.kvq_paged_decode_attn_ref(*jargs)),
            rtol=2e-5, atol=2e-5)
        if pallas:
            np.testing.assert_allclose(
                got, np.asarray(jops.kvq_paged_decode_attn(*jargs)),
                rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bs,S", [(64, 1088), (16, 1088), (48, 720)])
def test_paged_plain_on_a_scattered_dense_cache_equals_dense_plain(bs, S):
    """The plain paged decode on a pool built from a dense cache (each
    slot's tokens scattered into blocks through a shuffled table,
    sentinels past its extent) equals the plain dense decode bitwise, at
    lengths on and around the split-KV kernels' 64-token split boundaries
    and an empty row. On the card the dense kernel runs the paged
    kernel's code with the table taken away and must equal it bit for
    bit (``chip_smoke.py``); this is that statement for the plain
    versions: the gather changes no value and no order. The plain
    versions sum over the whole cache extent, masked or not, so the
    cache here is a whole number of blocks: a pool padded past S (S 1025
    in blocks of 64, say) sums over 1088 positions and can move the last
    bit; the kernels walk only a row's own tokens and are held to
    equality at S 1025 on the card."""
    lens = np.array([0, 1, S - 1, 64, 65, 192, 63, S], np.int32)
    B, H, Hkv, D = len(lens), 4, 2, 16
    rng = np.random.default_rng(S + bs)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    k = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, Hkv, S, D)).astype(np.int8)
    sk = rng.uniform(0.01, 0.2, (B, Hkv, S)).astype(np.float32)
    sv = rng.uniform(0.01, 0.2, (B, Hkv, S)).astype(np.float32)
    T = S // bs
    NB = B * T + 5
    tbl = rng.permutation(NB)[:B * T].reshape(B, T).astype(np.int32)
    tbl = np.where(np.arange(T)[None] < -(-lens // bs)[:, None], tbl, NB)

    def pool(x):                        # (B, Hkv, S, ...) -> (NB + 1, ...)
        x = x.reshape((B, Hkv, T, bs) + x.shape[3:]).swapaxes(1, 2)
        out = np.zeros((NB + 1, Hkv, bs) + x.shape[4:], x.dtype)
        out[tbl] = x                    # sentinel rows land in the sink
        return torch.from_numpy(out)

    lengths = torch.from_numpy(lens)
    dense = ref.kvq_decode_attn_ref(q, *map(torch.from_numpy, (k, v, sk, sv)),
                                    lengths)
    paged = ref.kvq_paged_decode_attn_ref(q, pool(k), pool(v), pool(sk),
                                          pool(sv), torch.from_numpy(tbl),
                                          lengths)
    assert not dense[0].any()
    assert torch.equal(paged, dense)


# --------------------------------------------------------------------------
# the port's copy of the block allocator
# --------------------------------------------------------------------------

class TestBlockAllocator:
    def test_reserve_then_exhaustion_refuses(self):
        a = BlockAllocator(num_blocks=4, block_size=8, slots=4, table_len=4)
        assert a.reserve(0, 20)            # 3 blocks
        assert not a.reserve(1, 16)        # 2 blocks > 1 unreserved
        assert a.reserve(1, 8)             # exactly the last block
        assert a.free_blocks == 0

    def test_lazy_allocation_and_peak(self):
        a = BlockAllocator(num_blocks=8, block_size=8, slots=2, table_len=8)
        assert a.reserve(0, 32)            # 4 blocks reserved
        assert a.allocated_blocks == 0     # nothing physical yet
        a.ensure(0, 8)
        assert a.allocated_blocks == 1
        a.ensure(0, 9)                     # crosses a block boundary
        assert a.allocated_blocks == 2
        a.ensure(0, 9)                     # idempotent
        assert a.allocated_blocks == 2
        assert a.peak_blocks == 2

    def test_release_returns_blocks_and_reservation(self):
        a = BlockAllocator(num_blocks=4, block_size=8, slots=2, table_len=4)
        assert a.reserve(0, 32)            # whole pool
        a.ensure(0, 17)                    # 3 blocks physical
        assert not a.reserve(1, 8)
        assert a.release(0) == 3
        assert a.free_blocks == 4
        assert a.reserve(1, 32)

    def test_table_rows_use_sentinel_for_unallocated(self):
        a = BlockAllocator(num_blocks=4, block_size=8, slots=2, table_len=4)
        assert (a.tables == 4).all()
        a.reserve(0, 24)
        a.ensure(0, 10)                    # 2 blocks
        assert (a.tables[0, :2] < 4).all() and (a.tables[0, 2:] == 4).all()
        a.release(0)
        assert (a.tables == 4).all()

    def test_ensure_beyond_reservation_is_an_accounting_bug(self):
        a = BlockAllocator(num_blocks=4, block_size=8, slots=1, table_len=4)
        a.reserve(0, 8)                    # 1 block
        with pytest.raises(RuntimeError, match="reservation"):
            a.ensure(0, 16)


# --------------------------------------------------------------------------
# the paged engine
# --------------------------------------------------------------------------

def _req(uid, plen, **kw):
    return Request(uid=uid, prompt=np.arange(plen, dtype=np.int32), **kw)


@pytest.fixture(scope="module")
def tparams_plain():
    cfg = t_get_reduced_config("qwen2.5-3b")
    return cfg, init_params(cfg, seed=1, device="cpu")


class TestPagedEngineLifecycle:
    def _engine(self, served, **kw):
        cfg, params = served
        kw.setdefault("slots", 4)
        kw.setdefault("cache_len", 64)
        kw.setdefault("kv_layout", "paged")
        kw.setdefault("block_size", 16)
        return ServeEngine(cfg, params, device="cpu", **kw)

    def test_pool_exhaustion_queues_requests(self, tparams_plain):
        """More work than the pool holds at once: later requests wait for
        freed blocks instead of crashing, and everything drains."""
        eng = self._engine(tparams_plain, num_blocks=2, max_seq_len=32)
        reqs = [_req(i, 12, max_new_tokens=6) for i in range(4)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained()
        assert all(r.done and len(r.generated) == 6 for r in reqs)
        assert stats["max_residents"] == 1      # pool admits one at a time
        assert stats["requests_finished"] == 4

    def test_blocks_freed_on_harvest(self, tparams_plain):
        eng = self._engine(tparams_plain)
        for i in range(6):
            eng.submit(_req(i, 8 + i, max_new_tokens=4))
        stats = eng.run_until_drained()
        assert eng.alloc.allocated_blocks == 0
        assert eng.alloc.free_blocks == eng.num_blocks == stats["free_blocks"]
        assert (eng.alloc.tables == eng.num_blocks).all()
        eng.alloc.check()

    def test_lazy_decode_allocation_tracks_residency(self, tparams_plain):
        """Only the blocks decode has reached are allocated: peak pool use
        stays below the worst-case reservation until the end."""
        eng = self._engine(tparams_plain, block_size=4, num_blocks=32)
        r = _req(0, 5, max_new_tokens=40)       # reserves ceil(44/4) = 11
        eng.submit(r)
        eng.step()                              # prefill + first chunk
        assert eng.alloc.allocated_blocks < 11
        eng.run_until_drained()
        assert len(r.generated) == 40

    def test_eos_mid_chunk_then_block_reuse_matches_dense(self,
                                                          tparams_plain):
        """A slot that EOSes mid-chunk keeps committing through its live
        table until harvest, and its freed blocks are then reused by a
        queued request: if post-EOS commits leaked into reallocated
        blocks, the follower's tokens would differ from dense."""
        cfg, params = tparams_plain

        def run(paged, eos_id):
            kw = dict(kv_layout="paged", block_size=16,
                      max_seq_len=64) if paged else {}
            eng = ServeEngine(cfg, params, slots=2, cache_len=64,
                              decode_block=4, device="cpu", **kw)
            stoch = _req(0, 8, max_new_tokens=12, eos_id=eos_id)
            stoch.temperature, stoch.seed = 1.0, 11
            runner = _req(1, 6, max_new_tokens=8)
            follow = _req(2, 10, max_new_tokens=6)   # reuses freed blocks
            for r in (stoch, runner, follow):
                eng.submit(r)
            eng.run_until_drained()
            return [stoch.generated, runner.generated, follow.generated]

        free_run = run(True, -1)[0]
        assert len(free_run) == 12
        first_seen = {}
        for i, t in enumerate(free_run):
            first_seen.setdefault(t, i)
        mid = [(t, i) for t, i in first_seen.items()
               if 0 < i < len(free_run) - 1]
        assert mid, "degenerate sampled stream"
        eos, stop_i = max(mid, key=lambda kv: kv[1])
        dense, paged = run(False, eos), run(True, eos)
        assert paged[0][-1] == eos and len(paged[0]) == stop_i + 1
        assert dense == paged

    def test_submit_rejects_never_admittable_with_block_count(
            self, tparams_plain):
        eng = self._engine(tparams_plain, num_blocks=2, max_seq_len=256)
        with pytest.raises(ValueError, match=r"needs 4 cache blocks"):
            eng.submit(_req(0, 50, max_new_tokens=8))   # 57 tokens
        with pytest.raises(ValueError, match=r"needs 263 cache tokens"):
            eng.submit(_req(1, 200, max_new_tokens=64))

    def test_fragmentation_interleaved_lengths(self, tparams_plain):
        """Interleaved short and long (chunked) requests churning an
        over-subscribed pool: blocks recycle with no leak and every
        request gets its exact token budget."""
        eng = self._engine(tparams_plain, slots=6, block_size=8,
                           num_blocks=24, max_seq_len=96, prefill_chunk=32)
        rr = np.random.default_rng(7)
        reqs = []
        for i in range(16):
            plen = int(rr.integers(3, 40)) if i % 2 else int(
                rr.integers(40, 80))
            budget = int(rr.integers(2, 12))
            reqs.append(_req(i, min(plen, 96 - budget),
                             max_new_tokens=budget))
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained(max_steps=50_000)
        assert [len(r.generated) for r in reqs] == \
            [r.max_new_tokens for r in reqs]
        assert eng.alloc.allocated_blocks == 0
        assert eng.alloc.free_blocks == eng.num_blocks
        assert stats["requests_finished"] == len(reqs)
        assert stats["max_residents"] > 1
        eng.alloc.check()

    def test_paged_equals_dense_streams(self, tparams_plain):
        """Greedy and sampled mixed-length streams are bitwise equal on
        both layouts when nothing is shared (prefix cache off) and every
        prompt fits one admission wave (a chunked prefill reads its
        history back quantized, so it is the serving-cache numerics, not
        a one-shot prefill's)."""
        cfg, params = tparams_plain
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (5, 40, 13, 27, 9)]

        def run(**kw):
            eng = ServeEngine(cfg, params, slots=3, cache_len=64,
                              decode_block=4, weights_layout="w4a8",
                              device="cpu", **kw)
            reqs = [Request(uid=i, prompt=p, max_new_tokens=7, seed=i,
                            temperature=0.8 if i % 2 else 0.0, top_k=8)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            stats = eng.run_until_drained()
            return [r.generated for r in reqs], stats

        dense, _ = run()
        paged, stats = run(kv_layout="paged", block_size=16,
                           prefix_cache=False)
        assert paged == dense
        assert stats["tail_waves"] == 0 and stats["free_blocks"] == 12


# --------------------------------------------------------------------------
# the port's paged engine against the JAX paged engine
# --------------------------------------------------------------------------

POLICY = "A8d-C8-W4"
PAGED = dict(slots=3, cache_len=64, decode_block=4, kv_layout="paged",
             block_size=16, num_blocks=24, max_seq_len=64)


@pytest.fixture(scope="module")
def served():
    cfg = get_reduced_config("qwen2.5-3b")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    params = jqat.calibrate_weight_scales(params, parse_policy(POLICY))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    return cfg, params, tparams


def _shared(cls, n=3, prefix_len=40, tail=5, max_new=6):
    """One prefix (2 full 16-token blocks + an 8-token split block) and n
    distinct tails: every follower prefix-hits and COWs the split block."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 250, prefix_len).astype(np.int32)
    return [cls(uid=i, prompt=np.concatenate(
                [prefix, ((np.arange(tail) * (i + 3) + i) % 250)
                 .astype(np.int32)]), max_new_tokens=max_new)
            for i in range(n)]


def test_paged_engine_matches_reference(served):
    """Warm one request, then admit two followers that prefix-hit the
    chain, COW the split block and ride one tail-wave. Both engines give
    the same streams and counters; from the state right after the
    tail-wave, the block tables and the pools are equal and one decode
    step's logits are bitwise equal (module docstring: the JAX engine
    runs op by op)."""
    cfg, params, tparams = served
    tcfg = t_get_reduced_config("qwen2.5-3b")

    def staged(eng, cls, finish):
        reqs = _shared(cls)
        eng.submit(reqs[0])
        eng.run_until_drained()
        for r in reqs[1:]:
            eng.submit(r)
        if not finish:
            eng._admit()
            eng._advance_tail_jobs()
            eng._ensure_decode_blocks()
            return reqs, None
        return reqs, eng.run_until_drained()

    def engines():
        return (JServeEngine(cfg, params, weights_layout="w4a8",
                             w4a8_backend="ref", **PAGED),
                ServeEngine(tcfg, tparams, weights_layout="w4a8",
                            device="cpu", **PAGED))

    jeng, teng = engines()
    with jax.disable_jit():
        jreqs, jstats = staged(jeng, JRequest, True)
    treqs, tstats = staged(teng, Request, True)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    for k in ("prefix_hit_tokens", "cow_copies", "prefill_chunks",
              "prompt_tokens_prefilled", "decode_steps", "tokens_out",
              "prefix_hit_blocks", "prefix_lookups", "free_blocks",
              "peak_cache_tokens", "prefill_calls", "max_residents"):
        assert tstats[k] == jstats[k], k
    assert tstats["cow_copies"] >= 2 and tstats["prefix_hit_tokens"] > 0
    assert tstats["tail_waves"] == 1             # both followers, one wave

    jeng, teng = engines()
    with jax.disable_jit():
        staged(jeng, JRequest, False)
        jlogits, _ = jax_decode_step(cfg, jeng.params, jeng.ctx,
                                     jeng.state["tokens"],
                                     jeng.state["cache"])
    staged(teng, Request, False)
    live = sorted(teng._slot_req)
    assert live == sorted(jeng._slot_req) == [0, 1]
    np.testing.assert_array_equal(teng.alloc.tables, jeng.alloc.tables)
    jpool = jeng.state["cache"]["segments"][0]["0"]["self"]
    for key in POOL_KEYS:
        want = np.asarray(jpool[key])
        np.testing.assert_array_equal(
            teng.state["cache"]["pool"][key][:, :want.shape[1]].numpy(),
            want, err_msg=key)
    tlogits, _ = decode_step(tcfg, teng.params, teng.ctx,
                             teng.state["tokens"],
                             clone_cache(teng.state["cache"]))
    want = np.asarray(jlogits.astype(np.float32))[live]
    got = tlogits.float().numpy()[live]
    np.testing.assert_array_equal(got, want)


def test_cow_clones_every_pool_leaf_in_one_copy_call(served, monkeypatch):
    """The engine's COW calls the multi-leaf copy once per resolved COW,
    with the four pool leaves themselves (``POOL_KEYS`` order) and the
    pairs as one (2, n) int32 tensor, and never the one-leaf copy; the
    streams equal those of an engine whose COW copies leaf by leaf."""
    from repro_torch.serve import engine as engine_mod
    _, _, tparams = served
    tcfg = t_get_reduced_config("qwen2.5-3b")
    calls = []
    real = ops.copy_pool_blocks_multi

    def record(leaves, pairs):
        calls.append((list(leaves), pairs.clone()))
        return real(leaves, pairs)

    def refuse(*a, **k):
        raise AssertionError("the engine called the one-leaf copy")

    def run(copy):
        monkeypatch.setattr(engine_mod, "copy_pool_blocks_multi", copy)
        monkeypatch.setattr(ops, "copy_pool_blocks", refuse)
        eng = ServeEngine(tcfg, tparams, weights_layout="w4a8",
                          device="cpu", **PAGED)
        reqs = _shared(Request)
        eng.submit(reqs[0])
        eng.run_until_drained()
        for r in reqs[1:]:
            eng.submit(r)
        return eng, reqs, eng.run_until_drained()

    eng, reqs, stats = run(record)
    pool = eng.state["cache"]["pool"]
    assert stats["cow_copies"] >= 2
    assert len(calls) >= 1
    assert sum(pairs.shape[1] for _, pairs in calls) == stats["cow_copies"]
    for leaves, pairs in calls:
        assert len(leaves) == len(POOL_KEYS) == 4
        assert all(x is pool[k] for x, k in zip(leaves, POOL_KEYS))
        assert pairs.dtype == torch.int32 and pairs.shape[0] == 2

    def leaf_by_leaf(leaves, pairs):
        for leaf in leaves:
            ref.copy_pool_blocks_ref(leaf, pairs[0], pairs[1])
        return leaves

    _, reqs_b, _ = run(leaf_by_leaf)
    assert [r.generated for r in reqs] == [r.generated for r in reqs_b]
