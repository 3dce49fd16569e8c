"""The port's descriptor ops and conv engine against the JAX package and
the scipy oracles, on the CPU (the plain twins of the CUDA kernels).

Tolerances, all float32 on both sides with another summation order:
* TPI: rtol 1e-5, atol 1e-3 m — the disk sums differ by a few ulps of
  ~1e5 and are divided by the tap count;
* STD: atol 2e-2 m — the squared-moment sums reach ~1e8 (ulp 8), and the
  difference of two such sums is divided by the tap count before sqrt;
* the oracles keep the tolerances of tests/test_ops.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from oracles import _std_oracle, _tpi_oracle
from topo_descriptors_tpu import kernels
from topo_descriptors_tpu import ops as jops
from topo_descriptors_tpu.ops import conv as jconv
from topo_descriptors_tpu_torch import ops as tops
from topo_descriptors_tpu_torch.ops import conv as tconv

TPI_TOL = dict(rtol=1e-5, atol=1e-3)
STD_TOL = dict(rtol=1e-5, atol=2e-2)


@pytest.mark.parametrize("size,sigma", [(3, None), (9, None), (17, None), (9, 1.125)])
def test_tpi_matches_jax_and_oracle(dem_small, size, sigma):
    out = tops.tpi(dem_small, size, sigma, device="cpu").numpy()
    np.testing.assert_allclose(out, np.asarray(jops.tpi(jnp.asarray(dem_small), size, sigma)), **TPI_TOL)
    np.testing.assert_allclose(out, _tpi_oracle(dem_small, size, sigma), rtol=1e-4, atol=2e-2)


@pytest.mark.parametrize("int32_parity", [True, False])
@pytest.mark.parametrize("size,sigma", [(5, None), (9, None), (15, None), (9, 1.125)])
def test_std_matches_jax_and_oracle(dem_small, size, sigma, int32_parity):
    out = tops.std(dem_small, size, sigma, int32_parity=int32_parity, device="cpu").numpy()
    ref = jops.std(jnp.asarray(dem_small), size, sigma, int32_parity=int32_parity)
    np.testing.assert_allclose(out, np.asarray(ref), **STD_TOL)
    if int32_parity:  # the oracle reproduces the reference's int32 truncation
        # compared as variances: float32 squared-moment sums (~1e8, ulp 8)
        # leave ~0.5 m^2 of variance error, which sqrt magnifies into
        # ~0.6 m where the variance is near zero
        exact = _std_oracle(dem_small, size, sigma, exact=True)
        np.testing.assert_allclose(out**2, exact**2, rtol=2e-3, atol=1.0)


def test_std_int32_quirk_changes_the_result(dem_small):
    quirk = tops.std(dem_small, 9, device="cpu")
    clean = tops.std(dem_small, 9, int32_parity=False, device="cpu")
    assert not torch.equal(quirk, clean)


@pytest.mark.parametrize("sigma", [None, 1.125])
@pytest.mark.parametrize("kinds", [("tpi", "std"), ("tpi",), ("std",)])
def test_disk_descriptors_matches_jax(dem_small, sigma, kinds):
    kw = dict(compute_tpi="tpi" in kinds, compute_std="std" in kinds)
    out = tops.disk_descriptors(dem_small, [3, 9, 17], sigma, device="cpu", **kw)
    ref = jops.disk_descriptors(jnp.asarray(dem_small), [3, 9, 17], sigma, **kw)
    assert sorted(out) == sorted(ref) == sorted(kinds)
    for kind in kinds:
        assert tuple(out[kind].shape) == (3,) + dem_small.shape
        tol = TPI_TOL if kind == "tpi" else STD_TOL
        np.testing.assert_allclose(out[kind].numpy(), np.asarray(ref[kind]), **tol)
    if "tpi" in kinds:  # each scale equals the single-scale op
        for j, size in enumerate([3, 9, 17]):
            single = tops.tpi(dem_small, size, sigma, device="cpu").numpy()
            np.testing.assert_allclose(out["tpi"][j].numpy(), single, **TPI_TOL)


@pytest.mark.parametrize("sigma", [0.8, 2.5, 6.0, 25.0, (2.0, 5.0)])
def test_gaussian_filter_matches_jax(dem_small, sigma):
    # 25.0 takes the per-axis FFT branch (201 taps > CFG.fft_correlate1d_min_taps)
    out = tconv.gaussian_filter(torch.from_numpy(dem_small), sigma).numpy()
    ref = np.asarray(jconv.gaussian_filter(jnp.asarray(dem_small), sigma))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=5e-3)


def test_gaussian_filter_huge_sigma_reflect(dem_tiny):
    # pad width far beyond the array size: multiple reflections
    out = tconv.gaussian_filter(torch.from_numpy(dem_tiny), 30.0).numpy()
    ref = np.asarray(jconv.gaussian_filter(jnp.asarray(dem_tiny), 30.0))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=5e-3)


@pytest.mark.parametrize(
    "kernel",
    [kernels.circular_kernel(9), kernels.circular_kernel(4), np.ones((4, 6), np.float32),
     np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32)],
    ids=["disk9", "square4", "even", "weighted"],
)
def test_edge_count_plane_matches_jax(dem_small, kernel):
    out = tconv.edge_count_plane_device(dem_small.shape, kernel, "cpu").numpy()
    ref = np.asarray(jconv.edge_count_plane_device(dem_small.shape, kernel))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize(
    "kernel",
    [kernels.circular_kernel(s, exclude_center=c) for s in (3, 9, 17, 67) for c in (False, True)]
    + [np.ones((4, 6), np.float32), np.zeros((3, 3), np.float32), np.full((3, 3), 0.5)],
)
def test_binary_kernel_runs_match_jax(kernel):
    flipped = np.asarray(kernel)[::-1, ::-1]
    assert tconv._binary_kernel_runs(flipped) == jconv._binary_kernel_runs(flipped)


@pytest.mark.parametrize("method", ["direct", "fft", "auto"])
@pytest.mark.parametrize("kshape", [(5, 5), (6, 8), (13, 7), (40, 30)])
def test_conv2d_same_matches_jax_and_scipy(dem_small, method, kshape):
    # (40, 30) has 1200 taps: 'direct' takes the library conv branch
    kernel = np.random.default_rng(4).standard_normal(kshape).astype(np.float32)
    out = tconv.conv2d_same(torch.from_numpy(dem_small), kernel, method=method).numpy()
    ref = np.asarray(jconv.conv2d_same(jnp.asarray(dem_small), kernel, method=method))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6 * scale)
    np.testing.assert_allclose(
        out, signal.convolve(dem_small, kernel, mode="same"), rtol=2e-5, atol=2e-6 * scale
    )


def test_conv2d_same_sat_rejects_weighted_kernel(dem_tiny):
    with pytest.raises(ValueError, match="0,1"):
        tconv.conv2d_same(torch.from_numpy(dem_tiny), np.full((3, 3), 0.5), method="sat")


@pytest.mark.parametrize("op", ["tpi", "std", "disk_descriptors", "sx"])
def test_ops_default_device_is_cuda(dem_tiny, op):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is missing")
    o, d, b = kernels.sx_offsets(0.0, 300.0, 30.0, 30.0)
    calls = {
        "tpi": lambda: tops.tpi(dem_tiny, 9),
        "std": lambda: tops.std(dem_tiny, 9),
        "disk_descriptors": lambda: tops.disk_descriptors(dem_tiny, [9]),
        "sx": lambda: tops.sx(dem_tiny, o, d, b),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[op]()
