"""Parity of the port's w4a8 matmul (plain version, CPU) with the JAX
package's Pallas kernel (interpret mode on CPU) and its XLA reference.

Tolerances: the int32 accumulators are exact (integer math on both
sides). Without a bias the bf16 outputs are bitwise equal: both packages
multiply the exact accumulator by s_x, then by s_w, each product rounded
once in f32. With a bias the reference's XLA graph may contract
``y * s_w + b`` into one FMA, which moves an isolated element by one bf16
ulp (the JAX package's own Pallas-vs-ref test bounds it the same way);
the port rounds every step, as its CUDA kernel does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import pack_int4, unpack_int4
from repro.kernels.w4a8.ops import w4a8_linear as jax_w4a8_linear
from repro.kernels.w4a8.ops import w4a8_matmul as jax_w4a8_matmul
from repro.kernels.w4a8.ref import w4a8_matmul_ref as jax_w4a8_ref
from repro_torch.kernels.w4a8 import ops as w4a8_ops
from repro_torch.kernels.w4a8.ops import w4a8_linear, w4a8_matmul
from repro_torch.kernels.w4a8.ref import w4a8_accumulate_ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(m, k, n, bias, seed):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-8, 8, (n, k)).astype(np.int8)
    s_x = (rng.random((m, 1)) * 0.1 + 1e-3).astype(np.float32)
    s_w = (rng.random((n,)) * 0.1 + 1e-3).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    w_p = np.array(pack_int4(jnp.asarray(w_q)))
    return x_q, w_q, w_p, s_x, s_w, b


def _torch(*arrs):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrs]


def _f32(bf16_array):
    return np.asarray(jnp.asarray(bf16_array).astype(jnp.float32))


# odd everything, sub-tile, exact TPU tile, one past the tile boundary
SHAPES = [(1, 2, 1), (3, 130, 5), (7, 66, 33), (256, 512, 256),
          (257, 514, 259)]


@pytest.mark.parametrize("mkn", SHAPES)
def test_accumulator_exact(mkn):
    x_q, w_q, w_p, *_ = _case(*mkn, False, sum(mkn))
    oracle = x_q.astype(np.int64) @ w_q.astype(np.int64).T
    xt, wt = _torch(x_q, w_p)
    np.testing.assert_array_equal(w4a8_accumulate_ref(xt, wt).numpy(), oracle)
    jax_acc = jnp.dot(jnp.asarray(x_q, jnp.int32),
                      unpack_int4(jnp.asarray(w_p)).T.astype(jnp.int32))
    np.testing.assert_array_equal(np.asarray(jax_acc), oracle)


@pytest.mark.parametrize("mkn", SHAPES)
@pytest.mark.parametrize("bias", [False, True])
def test_matches_jax_pallas_and_ref(mkn, bias):
    x_q, _, w_p, s_x, s_w, b = _case(*mkn, bias, sum(mkn) + 7 * bias)
    got = w4a8_matmul(*_torch(x_q, w_p, s_x, s_w, b))
    assert got.dtype == torch.bfloat16 and got.shape == (mkn[0], mkn[2])
    g32 = got.float().numpy()
    jargs = [None if a is None else jnp.asarray(a)
             for a in (x_q, w_p, s_x, s_w, b)]
    for use_pallas in (True, False):
        ref = _f32(jax_w4a8_matmul(*jargs, use_pallas=use_pallas))
        if b is None:
            np.testing.assert_array_equal(g32, ref)
        else:
            # one bf16 ulp of v is at most |v| * 2**-7
            ulp = 2.0 ** -7 * np.maximum(np.maximum(np.abs(g32), np.abs(ref)),
                                         2.0 ** -126)
            assert np.all(np.abs(g32 - ref) <= ulp)
            assert np.sum(g32 != ref) <= max(1, g32.size // 10_000)
    # against the JAX XLA reference called directly (bias-free: bitwise)
    if b is None:
        np.testing.assert_array_equal(g32, _f32(jax_w4a8_ref(*jargs)))


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_linear_matches_jax(lead):
    """Dynamic int8 activation quantization + matmul over leading dims."""
    rng = np.random.default_rng(len(lead))
    k, n = 64, 24
    x = np.array(jnp.asarray(rng.standard_normal(lead + (k,)), jnp.bfloat16))
    _, _, w_p, _, s_w, _ = _case(1, k, n, False, 11)
    exp_j = {"wq": jnp.asarray(w_p), "s_w": jnp.asarray(s_w[None])}
    exp_t = {"wq": torch.from_numpy(w_p), "s_w": torch.from_numpy(s_w[None])}
    ref = _f32(jax_w4a8_linear(jnp.asarray(x), exp_j, use_pallas=False))
    from repro_torch.bridge import to_torch
    got = w4a8_linear(to_torch(x, "cpu"), exp_t)
    assert got.shape == lead + (n,)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    np.testing.assert_array_equal(
        w4a8_linear(to_torch(x, "cpu"), exp_t, plain=True).float().numpy(),
        ref)


def test_non_cpu_non_cuda_tensor_raises():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches its kernel (CUDA) or raises."""
    x = torch.zeros((2, 32), dtype=torch.int8, device="meta")
    w = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        w4a8_matmul(x, w, torch.ones((2, 1), device="meta"),
                    torch.ones((4,), device="meta"))
    assert w4a8_matmul.launches == 0


# the serving path's K (qwen2.5-3b's d_model and d_ff) at the decode slots,
# the spec verify wave and one admission wave, on a narrow N and on
# xLSTM's gate projection (N = 8): both routes of the CUDA kernel cover
# these M, and both are bitwise this plain version on the card
MAIN_PATH = [(m, k, n) for k in (2048, 11008) for m in (4, 20, 512)
             for n in (16, 8)]


@pytest.mark.parametrize("mkn", MAIN_PATH, ids=lambda t: "x".join(map(str, t)))
def test_main_path_shapes_bitwise_with_jax_pallas_and_ref(mkn):
    """Without a bias the port's plain version, the Pallas kernel
    (interpret mode) and the XLA reference give the same bf16 bits."""
    x_q, _, w_p, s_x, s_w, _ = _case(*mkn, False, sum(mkn) + 3)
    got = w4a8_matmul(*_torch(x_q, w_p, s_x, s_w)).float().numpy()
    jargs = [jnp.asarray(a) for a in (x_q, w_p, s_x, s_w)]
    np.testing.assert_array_equal(
        got, _f32(jax_w4a8_matmul(*jargs, use_pallas=True)))
    np.testing.assert_array_equal(got, _f32(jax_w4a8_ref(*jargs)))


def test_route_is_checked_before_the_device():
    """``w4a8_matmul_route`` names the kernel's routes; an unknown one is
    refused, and a tensor off the card never reaches the launcher."""
    x = torch.zeros((2, 32), dtype=torch.int8)
    w = torch.zeros((4, 16), dtype=torch.uint8)
    args = (x, w, torch.ones((2, 1)), torch.ones((4,)))
    assert set(w4a8_ops.ROUTES) == {"auto", "decode", "mma"}
    with pytest.raises(ValueError, match="route"):
        w4a8_ops.w4a8_matmul_route(*args, route="dp4a")
    for route in w4a8_ops.ROUTES:
        with pytest.raises(ValueError, match="cpu or cuda"):
            w4a8_ops.w4a8_matmul_route(*args, route=route)
    assert w4a8_matmul.launches == 0


# --------------------------------------------------------------------------
# the accumulator-out mode, the epilogue and the row-parallel linear
# --------------------------------------------------------------------------

# qwen2.5-3b's row-parallel linears at tp=2 (wo K 1024, wd K 5504) at the
# decode slots and an admission wave, plus ragged shapes
ROW_SHAPES = SHAPES + [(4, 1024, 16), (512, 5504, 8), (1, 5504, 24)]


@pytest.mark.parametrize("mkn", ROW_SHAPES,
                         ids=lambda t: "x".join(map(str, t)))
def test_accumulate_equals_jax_int32_dot(mkn):
    """``w4a8_accumulate`` (the plain version on CPU tensors: the CUDA
    kernel's accumulator-out mode) against the JAX reference's int32
    ``jnp.dot`` path (``repro/kernels/w4a8/ref.py``, its huge-K branch)."""
    x_q, _, w_p, *_ = _case(*mkn, False, sum(mkn) + 5)
    got = w4a8_ops.w4a8_accumulate(*_torch(x_q, w_p))
    assert got.dtype == torch.int32 and got.shape == (mkn[0], mkn[2])
    jax_acc = jnp.dot(jnp.asarray(x_q).astype(jnp.int32),
                      unpack_int4(jnp.asarray(w_p)).T.astype(jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_acc))


@pytest.mark.parametrize("mkn", ROW_SHAPES[:4],
                         ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("bias", [False, True])
def test_epilogue_of_accumulator_equals_matmul(mkn, bias):
    """The epilogue applied to the accumulator is the fused matmul, bit
    for bit; without a bias also the JAX reference's bits."""
    x_q, _, w_p, s_x, s_w, b = _case(*mkn, bias, sum(mkn) + 9)
    xt, wt, sxt, swt, bt = _torch(x_q, w_p, s_x, s_w, b)
    got = w4a8_ops.w4a8_epilogue(w4a8_ops.w4a8_accumulate(xt, wt), sxt,
                                 swt, bt)
    assert torch.equal(got, w4a8_matmul(xt, wt, sxt, swt, bt))
    if not bias:
        jargs = [jnp.asarray(a) for a in (x_q, w_p, s_x, s_w)]
        np.testing.assert_array_equal(got.float().numpy(),
                                      _f32(jax_w4a8_ref(*jargs)))


class ThreadComm:
    """The collectives of ``runtime.collectives.TPComm`` between threads
    of one process (one thread a rank): each call deposits the rank's
    tensor, waits for every rank, and reduces or gathers the deposits in
    rank order. Records the (kind, dtype) of every call."""

    def __init__(self, rank, shared):
        self.rank, self.sh = rank, shared
        self.size = len(shared["slots"])

    def _exchange(self, t, combine, kind):
        sh = self.sh
        sh["slots"][self.rank] = t.clone()
        sh["barrier"].wait()
        out = combine(list(sh["slots"]))
        if self.rank == 0:
            sh["calls"].append((kind, t.dtype))
        sh["barrier"].wait()
        return out

    def all_reduce_max(self, t):
        t.copy_(self._exchange(t, lambda ts: torch.stack(ts).amax(0),
                               "max"))
        return t

    def all_reduce_sum(self, t):
        t.copy_(self._exchange(t, lambda ts: torch.stack(ts).sum(0).to(
            t.dtype), "sum"))
        return t


def run_ranks(tp, fn):
    """``fn(rank, comm)`` on ``tp`` threads; returns (results, calls)."""
    import threading
    sh = {"slots": [None] * tp, "barrier": threading.Barrier(tp),
          "calls": []}
    out, errs = [None] * tp, []

    def go(r):
        try:
            out[r] = fn(r, ThreadComm(r, sh))
        except Exception as e:              # noqa: BLE001
            errs.append(e)
            sh["barrier"].abort()

    ts = [threading.Thread(target=go, args=(r,)) for r in range(tp)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    if errs:
        raise errs[0]
    return out, sh["calls"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("lead,k", [((4,), 1024), ((2, 3), 128),
                                    ((1,), 5504)])
def test_row_parallel_linear_bitwise_tp1(tp, bias, lead, k):
    """``w4a8_linear_row`` on each rank's K slice (input features and the
    packed weight's columns), the amax and the int32 accumulators reduced
    over the ranks, equals the tp=1 ``w4a8_linear`` bitwise; the bias is
    added once. Only an f32 MAX and an int32 SUM cross ranks: never a
    scaled partial."""
    rng = np.random.default_rng(k + tp)
    n = 24
    x = torch.from_numpy(rng.standard_normal(lead + (k,)).astype(
        np.float32)).to(torch.bfloat16)
    # one token of large magnitude in one rank's slice: its amax must set
    # every rank's scale
    x[(0,) * len(lead) + (k - 3,)] = 40.0
    _, _, w_p, _, s_w, b = _case(1, k, n, bias, tp + 3)
    exp = {"wq": torch.from_numpy(w_p), "s_w": torch.from_numpy(s_w[None])}
    if bias:
        exp["b"] = torch.from_numpy(b)
    want = w4a8_linear(x, exp)
    ks = k // tp

    def rank_fn(r, comm):
        sl = slice(r * ks, (r + 1) * ks)
        loc = dict(exp, wq=exp["wq"][:, r * ks // 2:(r + 1) * ks // 2]
                   .contiguous())
        return w4a8_ops.w4a8_linear_row(x[..., sl].contiguous(), loc, comm,
                                        plain=True)

    got, calls = run_ranks(tp, rank_fn)
    for y in got:
        assert y.shape == want.shape and torch.equal(y, want)
    assert calls == [("max", torch.float32), ("sum", torch.int32)]
    # the outlier lies in the last rank's slice: without the MAX, rank
    # 0's first row would quantize on a scale of its own
    from repro_torch.core.quantizer import dynamic_quantize_to_int
    x2 = x.reshape(-1, k)
    assert dynamic_quantize_to_int(x2[:1, :ks], 8)[1] < \
        dynamic_quantize_to_int(x2[:1], 8)[1]


def test_accumulate_and_epilogue_off_cuda_raise():
    """A tensor neither on the CPU nor on the card reaches no launcher."""
    x = torch.zeros((2, 32), dtype=torch.int8, device="meta")
    w = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        w4a8_ops.w4a8_accumulate(x, w)
    with pytest.raises(ValueError, match="cpu or cuda"):
        w4a8_ops.w4a8_epilogue(torch.zeros((2, 4), dtype=torch.int32,
                                           device="meta"),
                               torch.ones((2, 1), device="meta"),
                               torch.ones((4,), device="meta"))
    assert w4a8_ops.w4a8_accumulate.launches == 0
    assert w4a8_ops.w4a8_epilogue.launches == 0
