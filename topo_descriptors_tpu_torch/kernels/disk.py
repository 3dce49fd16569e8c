"""Disk (circular) kernels for TPI and rolling-STD neighbourhoods.

The port's own copy of ``topo_descriptors_tpu/kernels/disk.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from topo_descriptors_tpu_torch.utils.timing import span


def circular_kernel(size: int, exclude_center: bool = False) -> np.ndarray:
    """Boolean disk of diameter ``size`` as float32 weights.

    Reference semantics (topo.py:191-213): pixels within ``mid = int(size/2)``
    of the centre are 1; for ``size < 5`` the kernel degenerates to a full
    square of ones (the reference's documented small-size quirk,
    topo.py:206-207). ``exclude_center=True`` zeroes the middle tap, as TPI
    does before convolving (topo.py:170).
    """
    with span("prep.kernel"):
        size = int(size)
        middle = int(size / 2)
        if size < 5:
            kernel = np.ones((size, size), dtype=np.float32)
        else:
            xx, yy = np.mgrid[:size, :size]
            circle = (xx - middle) ** 2 + (yy - middle) ** 2
            kernel = np.asarray(circle <= middle**2, dtype=np.float32)
        if exclude_center:
            kernel[middle, middle] = 0.0
        return kernel
