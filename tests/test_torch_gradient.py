"""The port's smoothed DEM, Sobel, gradient and their conv helpers against
the JAX package and the scipy oracles, on the CPU.

Tolerances: against the JAX op, those of tests/test_ops.py for the gradient
(atol 1e-5, 1e-5, 1e-3 and 2e-2 for dx, dy, slope and aspect, rtol 1e-3;
aspect compared modulo 360). Against the float32 scipy recipe, dx and dy
get atol 5e-5: the separable Gaussian accumulates ~37 float32 taps on
elevations of ~2e3 m (ulp 1.2e-4 m), a few ulps of which, differenced over
two 30 m pixels, reach 2.4e-5 in the JAX op run eagerly as its drivers run
it (the port runs the same operations in the same order). The smoothed
DEM and the conv helpers run the same float32 algorithm as the JAX ops,
with other summation orders: rtol 1e-5 and an atol of a few ulps of the
field (1e-3 m on elevations of ~2e3 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from oracles import _gradient_oracle
from topo_descriptors_tpu import ops as jops
from topo_descriptors_tpu.kernels.sobel import sobel_kernel
from topo_descriptors_tpu_torch import ops as tops

FIELD_TOL = dict(rtol=1e-5, atol=1e-3)
GRAD_ATOL = (1e-5, 1e-5, 1e-3, 2e-2)  # dx, dy, slope, aspect
ORACLE_ATOL = (5e-5, 5e-5, 1e-3, 2e-2)


def _res(shape, two_d=False):
    ny, nx = shape
    if not two_d:
        return {"x": np.full(nx, 30.0, np.float32), "y": np.full(ny, -30.0, np.float32)}
    # geographic grids give 2-D resolution arrays (reference helpers.py:95-101)
    rng = np.random.default_rng(1)
    return {"x": (30.0 + rng.random((ny, nx))).astype(np.float32),
            "y": (-30.0 - rng.random((ny, nx))).astype(np.float32)}


def _assert_aspect_close(out, ref, atol):
    # aspect is an angle: 359.99 and 0.01 are 0.02 degrees apart
    diff = (out - ref + 180.0) % 360.0 - 180.0
    assert np.all(np.abs(diff) <= atol + 1e-3 * np.abs(ref)), np.abs(diff).max()


def _assert_gradient_close(outs, refs, atols=GRAD_ATOL):
    for i, (out, ref, atol) in enumerate(zip(outs, refs, atols)):
        out, ref = np.asarray(out), np.asarray(ref)
        if i == 3:
            _assert_aspect_close(out, ref, atol)
        else:
            np.testing.assert_allclose(out, ref, rtol=1e-3, atol=atol)


@pytest.mark.parametrize("sigma", [0, None, 1.5, 6.0, 30.0])
def test_dem_matches_jax_and_scipy(dem_small, sigma):
    out = tops.dem(dem_small, sigma, device="cpu").numpy()
    np.testing.assert_allclose(out, np.asarray(jops.dem(jnp.asarray(dem_small), sigma)), **FIELD_TOL)
    ref = ndimage.gaussian_filter(dem_small.astype(np.float64), sigma) if sigma else dem_small
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-3)


def test_sobel_matches_jax_and_scipy(dem_small):
    dx, dy = (t.numpy() for t in tops.sobel(dem_small, device="cpu"))
    jdx, jdy = jops.sobel(jnp.asarray(dem_small))
    k = sobel_kernel()
    for out, jref, kern in ((dx, jdx, k), (dy, jdy, k.T)):
        np.testing.assert_allclose(out, np.asarray(jref), **FIELD_TOL)
        ref = ndimage.convolve(dem_small.astype(np.float64), kern.astype(np.float64))
        np.testing.assert_allclose(out, ref, **FIELD_TOL)


@pytest.mark.parametrize("kshape", [(3, 3), (5, 3), (7, 9)])
def test_convolve_reflect_matches_jax_and_scipy(dem_small, kshape):
    kernel = np.random.default_rng(7).standard_normal(kshape).astype(np.float32)
    out = tops.convolve_reflect(tops.dem(dem_small, 0, device="cpu"), kernel).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jops.convolve_reflect(jnp.asarray(dem_small), kernel)), rtol=1e-5, atol=2e-2)
    ref = ndimage.convolve(dem_small.astype(np.float64), kernel.astype(np.float64))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-2)


@pytest.mark.parametrize("edge_order", ["one_sided", "none"])
@pytest.mark.parametrize("axis", [0, 1])
def test_gradient_axis_matches_jax_and_numpy(dem_small, axis, edge_order):
    x = tops.dem(dem_small, 0, device="cpu")
    out = tops.gradient_axis(x, axis, edge_order).numpy()
    ref = np.asarray(jops.gradient_axis(jnp.asarray(dem_small), axis, edge_order))
    np.testing.assert_array_equal(out, ref)  # one subtraction and a halving
    if edge_order == "one_sided":
        np.testing.assert_array_equal(out, np.gradient(dem_small, axis=axis))


@pytest.mark.parametrize("method", ["auto", "direct", "fft", "sat"])
@pytest.mark.parametrize("kind", ["disk", "weighted", "weighted_large"])
def test_conv2d_valid_matches_jax(dem_small, kind, method):
    from topo_descriptors_tpu.kernels import circular_kernel
    from topo_descriptors_tpu.ops import conv as jconv
    from topo_descriptors_tpu_torch.ops import conv as tconv

    rng = np.random.default_rng(9)
    kernel = {"disk": circular_kernel(17),
              "weighted": rng.standard_normal((6, 9)).astype(np.float32),
              "weighted_large": rng.standard_normal((33, 35)).astype(np.float32)}[kind]
    if method == "sat" and kind != "disk":
        with pytest.raises(ValueError, match="sat"):
            tconv.conv2d_valid(tops.dem(dem_small, 0, device="cpu")[None], kernel, method)
        return
    xs = np.stack([dem_small - 1500.0, (dem_small - 1500.0) * 0.5])
    out = tconv.conv2d_valid(tops.dem(xs, 0, device="cpu"), kernel, method).numpy()
    ref = np.asarray(jconv.conv2d_valid(jnp.asarray(xs), kernel, method))
    assert out.shape == ref.shape == (2, 72 - kernel.shape[0] + 1, 96 - kernel.shape[1] + 1)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("sigma,sig_ratio", [(0.5, 1), (2.25, 1), (2.25, 2.0)])
def test_gradient_matches_jax_and_oracle(dem_small, sigma, sig_ratio):
    res = _res(dem_small.shape)
    outs = [t.numpy() for t in tops.gradient(dem_small, sigma, res, sig_ratio, device="cpu")]
    _assert_gradient_close(outs, jops.gradient(jnp.asarray(dem_small), sigma, res, sig_ratio))
    _assert_gradient_close(outs, _gradient_oracle(dem_small, sigma, res, sig_ratio), ORACLE_ATOL)


@pytest.mark.parametrize("sigma", [0.5, 2.25])
def test_gradient_2d_resolution(dem_small, sigma):
    res = _res(dem_small.shape, two_d=True)
    outs = [t.numpy() for t in tops.gradient(dem_small, sigma, res, 1, device="cpu")]
    _assert_gradient_close(outs, jops.gradient(jnp.asarray(dem_small), sigma, res, 1))
    _assert_gradient_close(outs, _gradient_oracle(dem_small, sigma, res, 1), atols=(2e-2,) * 4)


def test_aspect_is_the_floor_modulo():
    # rows rising southwards on a north-up grid: dx = 0 and dy < 0, so
    # atan2(dx, dy) = +-180 deg and 180 + atan2 is 0 or 360; the modulo
    # keeps the aspect in [0, 360)
    dem = np.repeat(np.arange(8, dtype=np.float32)[:, None] * 3.0, 8, axis=1)
    res = _res(dem.shape)
    for sigma in (0.5, 2.25):
        aspect = tops.gradient(dem, sigma, res, device="cpu")[3].numpy()
        np.testing.assert_array_equal(aspect, np.zeros_like(aspect))
        np.testing.assert_array_equal(aspect, _gradient_oracle(dem, sigma, res)[3])
