"""Sobel stencil for the lowest-scale gradient path.

The port's own copy of ``topo_descriptors_tpu/kernels/sobel.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def sobel_kernel() -> np.ndarray:
    """3x3 Sobel kernel normalized by the sum of absolute weights (=8).

    Reference semantics (topo.py:679-681): ``[[1,0,-1],[2,0,-2],[1,0,-1]]/8``;
    the x-derivative convolves with this kernel, the y-derivative with its
    transpose, both via true convolution with 'reflect' boundary
    (ndimage.convolve, topo.py:682-683).
    """
    k = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], dtype=np.float32)
    return k / np.sum(np.abs(k))
