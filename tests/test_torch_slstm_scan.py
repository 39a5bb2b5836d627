"""Parity of the port's sLSTM scan (the plain version of the
``slstm_scan`` kernel) with the JAX package's oracle (``slstm_scan_ref``)
and its Pallas kernel (``slstm_scan`` in interpret mode on the CPU), at
the shapes of ``tests/test_kernels.py::TestSLSTMScanKernel``.

Same f32 inputs, made with numpy, through both, with non-zero h0 and c0.
Tolerance: atol 3e-5 on hs, hT and cT, the reference's own kernel-vs-
oracle tolerance. The recurrence is the same f32 math; only the order of
the h . r_h sums (torch's GEMM, XLA's dot, the Pallas kernel's dot)
differs, and the state carries those ulps through the T steps. The
ragged case (T 100) is padded to the Pallas kernel's 128-step tiles by
its wrapper: padded steps must not move hT and cT.

The shapes include those the card's check adds for the CUDA kernel's
two routes: B 11 (two batch tiles of 8 rows) and d 200 (fewer hidden
indices than warps in a resident CTA).

The wrapper's own rules are checked too: CPU tensors take the plain
version without building or counting a kernel, a device the kernel does
not run on raises, and the launch path refuses a grid-barrier scratch
shorter than ``BAR_INTS`` and a route it does not know before it builds
or calls anything.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm_scan.ops import slstm_scan as jax_slstm_scan
from repro.kernels.slstm_scan.ref import slstm_scan_ref as jax_slstm_ref
from repro_torch.kernels.slstm_scan import ops
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

ATOL = 3e-5
DIMS = [(8, 256, 128), (3, 100, 128), (8, 128, 256), (11, 37, 128),
        (5, 64, 200)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 4 * d)).astype(np.float32) * 0.5,
            rng.standard_normal((d, 4 * d)).astype(np.float32) * d ** -0.5,
            rng.standard_normal((B, d)).astype(np.float32) * 0.1,
            rng.standard_normal((B, d)).astype(np.float32) * 0.1)


def _port(arrs):
    return slstm_scan_ref(*(torch.from_numpy(a) for a in arrs))


def _close(got, want):
    for name, g, w in zip(("hs", "hT", "cT"), got, want):
        assert tuple(g.shape) == np.asarray(w).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("dims", DIMS)
def test_plain_matches_reference_oracle(dims):
    arrs = _inputs(*dims, seed=sum(dims))
    _close(_port(arrs), jax_slstm_ref(*map(jnp.asarray, arrs)))


@pytest.mark.parametrize("dims", DIMS)
def test_plain_matches_interpret_mode_kernel(dims):
    """Against the Pallas kernel; at T 100 its wrapper pads 28 steps,
    which write hs but leave hT and cT where step 100 put them."""
    arrs = _inputs(*dims, seed=sum(dims))
    _close(_port(arrs), jax_slstm_scan(*map(jnp.asarray, arrs)))


def test_bf16_input_writes_bf16_hs():
    """gx in bf16: hs comes back in bf16 as the reference's, the state in
    f32; the same values as the f32 run on the rounded input."""
    arrs = _inputs(2, 9, 32, seed=5)
    gx = jnp.asarray(arrs[0]).astype(jnp.bfloat16)
    want = jax_slstm_ref(gx, *map(jnp.asarray, arrs[1:]))
    tgx = torch.from_numpy(np.array(gx.astype(jnp.float32))).to(
        torch.bfloat16)
    got = slstm_scan_ref(tgx, *(torch.from_numpy(a) for a in arrs[1:]))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               atol=2.0 ** -8, rtol=0)
    _close(got[1:], want[1:])


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("a CPU call tried to build or load a kernel")

    monkeypatch.setattr(build, "load", refuse)
    arrs = [torch.from_numpy(a) for a in _inputs(3, 20, 64, seed=1)]
    before = ops.slstm_scan.launches
    got = ops.slstm_scan(*arrs)
    for g, w in zip(got, slstm_scan_ref(*arrs)):
        assert torch.equal(g, w)
    assert ops.slstm_scan.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.slstm_scan(*(a.to("meta") for a in arrs))


def test_launch_refuses_short_barrier_scratch_and_unknown_route(
        monkeypatch):
    """What the wrapper hands the C launcher is checked first: a barrier
    scratch of fewer than ``BAR_INTS`` int32 (or of another dtype) and a
    route number the launcher does not know raise ValueError, and an
    unknown route name raises on every device; nothing is built."""
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("a refused call tried to build or load a "
                             "kernel")

    monkeypatch.setattr(build, "load", refuse)
    gx, r_h, h0, c0 = (torch.from_numpy(a) for a in _inputs(3, 4, 32, 2))
    B, T, d = 3, 4, 32
    state = (torch.zeros((2, B, d)), torch.zeros((B, d)),
             torch.zeros((B, T, d)))
    ok_bar = torch.zeros(ops.BAR_INTS, dtype=torch.int32)
    for bar in (torch.zeros(ops.BAR_INTS - 1, dtype=torch.int32),
                torch.zeros(ops.BAR_INTS, dtype=torch.int64)):
        with pytest.raises(ValueError, match="grid barrier"):
            ops._launch(gx, r_h, *state, bar, ops.ROUTES["resident"])
    for route in (-1, 3):
        with pytest.raises(ValueError, match="route"):
            ops._launch(gx, r_h, *state, ok_bar, route)
    with pytest.raises(ValueError, match="route"):
        ops.slstm_scan(gx, r_h, h0, c0, route="fast")
    assert sorted(ops.ROUTES.values()) == [0, 1, 2]
