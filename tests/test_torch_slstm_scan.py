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

The ``carry="gx"`` mode (the reference model's cell, which the port's
QAT teacher runs) is held to that cell itself,
``src/repro/models/recurrent.py:_slstm_cell`` scanned op by op
(``jax.disable_jit``) with quantization off, on bf16 gx, r_h and h0:
the same rounding points, so it differs only where torch's CPU sigmoid
and tanh and XLA:CPU's round an f32 value an ulp apart and that flips a
bf16 h, which the recurrence then carries. Per shape, the share of hs
values that differ, hs's relative L2 error and cT's largest absolute
error are held to about 2x what was measured (``GX_TOL``; measured at
(2, 16, 64): bitwise, cT 6.0e-8; (8, 128, 64): 9.2e-5 of hs, 8.4e-6,
8.9e-8; (3, 37, 200): 7.1e-2 of hs, 1.06e-3, 1.09e-3). The f32 carry on
the same inputs is 2.5e-3 from the cell, 36-38% of hs apart.

The wrapper's own rules are checked too: CPU tensors take the plain
version without building or counting a kernel, a device the kernel does
not run on raises, and the launch path refuses a grid-barrier scratch
shorter than ``BAR_INTS`` and a route it does not know before it builds
or calls anything.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as jqat
from repro.kernels.slstm_scan.ops import slstm_scan as jax_slstm_scan
from repro.kernels.slstm_scan.ref import slstm_scan_ref as jax_slstm_ref
from repro.models.recurrent import _slstm_cell as jax_slstm_cell
from repro_torch.kernels.slstm_scan import ops
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

ATOL = 3e-5
DIMS = [(8, 256, 128), (3, 100, 128), (8, 128, 256), (11, 37, 128),
        (5, 64, 200)]
# carry="gx" against the reference's cell: (B, T, d) -> (share of hs
# values that differ, hs relative L2, cT absolute), about 2x measured
GX_TOL = {(2, 16, 64): (0.0, 0.0, 1.2e-7),
          (8, 128, 64): (2e-4, 1.7e-5, 1.8e-7),
          (3, 37, 200): (0.15, 2.2e-3, 2.2e-3)}


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


# --------------------------------------------------------------------------
# carry="gx": the reference model's cell
# --------------------------------------------------------------------------

def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _torch_of(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _reference_cell_scan(gx, r_h, h0, c0):
    """``src/repro/models/recurrent.py:_slstm_cell`` scanned over gx's
    time axis op by op, quantization off (``slstm_fwd``'s loop)."""
    cfg = types.SimpleNamespace(d_model=h0.shape[-1])
    ctx = jqat.make_ctx("A16-C16-W16", mode="off")

    def step(carry, g):
        h, c = jax_slstm_cell(cfg, ctx, {"r_h": {"w": r_h}}, g, *carry)
        return (h, c), h

    with jax.disable_jit():
        (h, c), hs = jax.lax.scan(step, (h0, c0), jnp.moveaxis(gx, 1, 0))
    return jnp.moveaxis(hs, 0, 1), h, c


def _gx_case(dims, carry):
    """The plain scan in ``carry`` mode and the reference's cell on the
    same bf16 gx, r_h, h0 and f32 c0."""
    gx, r_h, h0, c0 = _inputs(*dims, seed=sum(dims))
    gx, r_h, h0 = _bf16(gx), _bf16(r_h), _bf16(h0)
    want = _reference_cell_scan(gx, r_h, h0, jnp.asarray(c0))
    got = slstm_scan_ref(_torch_of(gx).bfloat16(), _torch_of(r_h).bfloat16(),
                         _torch_of(h0), torch.from_numpy(c0), carry=carry)
    return got, want


def _hs_gaps(got, want):
    g, w = got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32))
    return float((g != w).mean()), float(np.linalg.norm(g - w)
                                         / np.linalg.norm(w))


@pytest.mark.parametrize("dims", sorted(GX_TOL))
def test_gx_carry_plain_matches_reference_cell(dims):
    """``carry="gx"`` against the reference's ``_slstm_cell`` scan: hs and
    hT in bf16, cT in f32, within ``GX_TOL``; bitwise where no sigmoid or
    tanh rounding flipped a bf16 h (T 16)."""
    got, want = _gx_case(dims, "gx")
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[2].dtype == torch.float32
    share, rel = _hs_gaps(got, want)
    max_share, max_rel, c_atol = GX_TOL[dims]
    assert share <= max_share and rel <= max_rel, (share, rel)
    if max_share == 0.0:
        np.testing.assert_array_equal(
            got[1].float().numpy(), np.asarray(want[1].astype(jnp.float32)))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=c_atol, rtol=0)


@pytest.mark.parametrize("dims", sorted(GX_TOL))
def test_f32_carry_is_farther_from_reference_cell(dims):
    """The repair's point: on the same inputs the f32 carry (the TPU
    kernel's function) sits farther from the reference's cell than the
    gx carry's bound, in both the share of hs that differs (measured
    36-38%) and hs's relative L2 (measured 2.5e-3)."""
    got, want = _gx_case(dims, "f32")
    share, rel = _hs_gaps(got, want)
    max_share, max_rel, _ = GX_TOL[dims]
    assert share > max(max_share, 0.3) and rel > max_rel, (share, rel)


def test_gx_carry_on_f32_input_is_the_f32_carry():
    """With f32 gx every rounding of the gx carry is the identity, so the
    two modes are the same function, bitwise."""
    arrs = [torch.from_numpy(a) for a in _inputs(3, 20, 64, seed=7)]
    for g, w in zip(slstm_scan_ref(*arrs, carry="gx"),
                    slstm_scan_ref(*arrs, carry="f32")):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(g, w)


def test_wrapper_passes_carry_on_cpu_and_refuses_unknown(monkeypatch):
    """The wrapper's ``carry`` reaches the plain version on the CPU (no
    build, no count); an unknown carry raises on every device, and the
    plain version refuses it too."""
    from repro_torch.kernels import build

    def refuse(*a, **k):
        raise AssertionError("a CPU call tried to build or load a kernel")

    monkeypatch.setattr(build, "load", refuse)
    gx, r_h, h0, c0 = (torch.from_numpy(a) for a in _inputs(2, 9, 32, 3))
    gx, r_h = gx.bfloat16(), r_h.bfloat16()
    before = ops.slstm_scan.launches
    got = ops.slstm_scan(gx, r_h, h0, c0, carry="gx")
    for g, w in zip(got, slstm_scan_ref(gx, r_h, h0, c0, carry="gx")):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[1].dtype == torch.bfloat16
    assert ops.slstm_scan.launches == before
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="carry"):
            ops.slstm_scan(*(a.to(dev) for a in (gx, r_h, h0, c0)),
                           carry="bf16")
    with pytest.raises(ValueError, match="carry"):
        slstm_scan_ref(gx, r_h, h0, c0, carry="bf16")
