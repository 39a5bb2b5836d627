"""Parity of the port's step-size calibration with the JAX package's
``core/calibration.py``: the convex-MSE weight scale (Eq. 2, ternary
search), the LSQ initialization, and the activation percentile at sizes
below and above torch.quantile's 2^24-element limit.

This holds the port to the reference function, not to the property that
``tests/test_calibration.py::test_beats_naive_calibrations`` asserts
(which fails on the reference itself). Tolerances:

* the percentile is bitwise equal to ``jnp.quantile`` run op by op: the
  same f32 position arithmetic and order statistics, at any size;
* the MSE scale is within 1e-3 relative, and its objective within 1e-5
  relative of the reference scale's: the objective's f32 sum over d_in
  runs in another order than XLA's, and near the convex minimum the
  objective is flat (a 1e-3 change of s moves it by ~1e-6 relative), so
  the ternary search's comparisons there are decided by rounding and the
  two brackets close on different points of the same flat bottom
  (observed: up to 4e-4);
* the LSQ scale is within 1e-6 relative (a few f32 ulps): a mean over
  d_in in another order, then a division.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro_torch.core import calibration as tcal

MSE_RTOL = 1e-3
OBJ_RTOL = 1e-5
LSQ_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(shape, seed, heavy=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.02
    if heavy:                              # outlier channels / entries
        w *= rng.standard_t(3, shape).astype(np.float32)
    return w


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(64, 48), (96, 256)])
def test_mse_weight_scale(shape, bits, heavy):
    w = _weights(shape, sum(shape) + bits, heavy)
    with jax.disable_jit():
        want = np.asarray(jcal.mse_weight_scale(jnp.asarray(w), bits))
    got = tcal.mse_weight_scale(torch.from_numpy(w), bits).numpy()
    assert got.shape == want.shape == (1, shape[1])
    np.testing.assert_allclose(got, want, rtol=MSE_RTOL, atol=0)
    # the objective at the port's scale is as low as at the reference's
    absw = torch.from_numpy(np.abs(w).T.copy())
    f_got = tcal.mse_objective(absw, torch.from_numpy(got[0]), bits)
    f_want = tcal.mse_objective(absw, torch.from_numpy(want[0]), bits)
    assert torch.all((f_got - f_want).abs() <= OBJ_RTOL * f_want)


@pytest.mark.parametrize("bits", [4, 8])
def test_mse_weight_scale_bf16_weight(bits):
    w = jnp.asarray(_weights((128, 32), 9)).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = np.asarray(jcal.mse_weight_scale(w, bits))
    from repro_torch.bridge import to_torch
    got = tcal.mse_weight_scale(to_torch(np.asarray(w), "cpu"), bits).numpy()
    np.testing.assert_allclose(got, want, rtol=MSE_RTOL, atol=0)


@pytest.mark.parametrize("bits", [4, 8])
def test_lsq_weight_scale(bits):
    w = _weights((80, 40), bits)
    with jax.disable_jit():
        want = np.asarray(jcal.lsq_weight_scale(jnp.asarray(w), bits))
    got = tcal.lsq_weight_scale(torch.from_numpy(w), bits).numpy()
    np.testing.assert_allclose(got, want, rtol=LSQ_RTOL, atol=0)
    assert np.asarray(jcal.weight_scale(jnp.asarray(w), bits, "lsq")
                      ).shape == tuple(tcal.weight_scale(
                          torch.from_numpy(w), bits, "lsq").shape)


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 2, 997, 12_345, (1 << 24) + 4097])
def test_percentile_stat_matches_jnp_quantile(n, bits):
    rng = np.random.default_rng(n + bits)
    x = rng.standard_normal(n).astype(np.float32)
    x[:: max(n // 7, 1)] *= 40.0             # outliers in the top tail
    with jax.disable_jit():
        want = np.asarray(jcal.act_percentile_stat(jnp.asarray(x), bits))
    got = tcal.act_percentile_stat(torch.from_numpy(x), bits)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_percentile_of_a_bf16_activation_and_max_stat():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((4, 9, 64)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    from repro_torch.bridge import to_torch
    tx = to_torch(np.asarray(x), "cpu")
    with jax.disable_jit():
        for bits in (4, 8, 16):
            np.testing.assert_array_equal(
                tcal.act_percentile_stat(tx, bits).numpy(),
                np.asarray(jcal.act_percentile_stat(x, bits)))
        np.testing.assert_array_equal(
            tcal.act_max_stat(tx, 8).numpy(),
            np.asarray(jcal.act_max_stat(x, 8)))
        for bits in (4, 8):
            s = jnp.float32(0.37)
            np.testing.assert_array_equal(
                tcal.act_scale_from_stat(torch.tensor(0.37), bits).numpy(),
                np.asarray(jcal.act_scale_from_stat(s, bits)))


def test_percentile_nan_propagates():
    x = torch.arange(100, dtype=torch.float32)
    x[17] = float("nan")
    assert torch.isnan(tcal.quantile_linear(x, 0.5))
