"""``ops.edge_count_plane``, the exact float64 host count plane, against the
JAX package's function (bit for bit: both are the same float64 integral
image lookups), the scipy recipe of tests/test_ops.py and the port's device
plane (``edge_count_plane_device``) on the CPU."""

import numpy as np
import pytest
import torch
from scipy import signal

from topo_descriptors_tpu import ops as jops
from topo_descriptors_tpu_torch import ops
from topo_descriptors_tpu_torch.host import circular_kernel
from topo_descriptors_tpu_torch.kernels.gaussian import gaussian_kernel1d
from topo_descriptors_tpu_torch.ops.conv import edge_count_plane_device


def _gaussian(sigma):
    k = gaussian_kernel1d(sigma)
    return np.outer(k, k)


KERNELS = {
    # the 9-px disk of tests/test_ops.py::test_edge_count_plane_exact
    "disk9": lambda: circular_kernel(9),
    "disk9_no_centre": lambda: circular_kernel(9, exclude_center=True),
    "gaussian_sigma2": lambda: _gaussian(2.0),
    "even_6x8": lambda: np.random.default_rng(7).uniform(0.0, 1.0, (6, 8)),
    # wider than the field: every pixel sees the boundary
    "disk67": lambda: circular_kernel(67),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_edge_count_plane_equals_jax(dem_small, kernel):
    k = KERNELS[kernel]()
    plane = ops.edge_count_plane(dem_small.shape, k)
    ref = jops.edge_count_plane(dem_small.shape, k)
    assert plane.dtype == np.float64 and plane.shape == dem_small.shape
    np.testing.assert_array_equal(plane, ref)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_edge_count_plane_matches_scipy_and_the_device_plane(dem_small, kernel):
    k = KERNELS[kernel]()
    plane = ops.edge_count_plane(dem_small.shape, k)
    ref = signal.convolve(np.ones(dem_small.shape), k.astype(np.float64), "same")
    # the plane is exact; the scipy oracle carries ~1e-5 FFT noise
    np.testing.assert_allclose(plane, ref, rtol=1e-9, atol=1e-4)
    device = edge_count_plane_device(dem_small.shape, k, "cpu")
    assert device.dtype == torch.float32
    # {0,1} kernels: integer counts below 2^24, exact in float32; others:
    # float32 integral-image lookups
    tol = 0.0 if set(np.unique(k)) <= {0.0, 1.0} else 1e-6 * float(np.abs(k).sum())
    np.testing.assert_allclose(device.numpy(), plane, rtol=0, atol=tol)
