"""Gaussian filter taps with scipy.ndimage parity.

The port's own copy of ``topo_descriptors_tpu/kernels/gaussian.py``:
the port imports nothing of the JAX package.

The reference smooths with ``scipy.ndimage.gaussian_filter`` everywhere
(topo.py:80,173,298,427,631,634-635). That filter is a separable correlation
with truncated sampled-Gaussian taps (truncate=4.0) and 'reflect' boundary.
We generate identical taps host-side; the separable convolution itself runs
on TPU (ops/conv.py).
"""

from __future__ import annotations

import numpy as np


def gaussian_radius(sigma: float, truncate: float = 4.0) -> int:
    """Tap radius used by scipy.ndimage.gaussian_filter: int(truncate*sigma+0.5)."""
    return int(truncate * float(sigma) + 0.5)


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized sampled-Gaussian taps of length 2*radius+1 (float64).

    Matches scipy's ``_gaussian_kernel1d`` for order 0: ``exp(-x^2/(2 s^2))``
    on integer offsets, normalized to sum 1. Symmetric, so correlation and
    convolution coincide.
    """
    sigma = float(sigma)
    radius = gaussian_radius(sigma, truncate)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return phi / phi.sum()
