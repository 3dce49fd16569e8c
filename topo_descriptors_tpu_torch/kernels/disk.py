"""Disk (circular) kernels for TPI and rolling-STD neighbourhoods.

The port's own copy of ``topo_descriptors_tpu/kernels/disk.py``:
the port imports nothing of the JAX package. :class:`Disk` describes the
same disk by its diameter, for the routes that need only its geometry.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

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


@dataclass(frozen=True)
class Disk:
    """The disk of ``circular_kernel(size, exclude_center)`` described by its
    diameter: row ``r`` of the mask is one run of half-width
    ``isqrt(mid**2 - (r - mid)**2)`` about ``mid = int(size/2)`` (the whole
    row below 5 px), split in two at the centre when the centre is left out.
    Its tap count and runs take O(size) integer operations and no mask;
    :meth:`dense` (also ``np.asarray(disk)``) builds the mask for a route
    that needs the weights."""

    size: int
    exclude_center: bool = False

    def __post_init__(self):
        object.__setattr__(self, "size", int(self.size))
        object.__setattr__(self, "exclude_center", bool(self.exclude_center))
        if self.size < 1:
            raise ValueError(f"a disk needs a diameter of at least 1 px, got {self.size}")

    @property
    def shape(self):
        return self.size, self.size

    @functools.cached_property
    def _row_spans(self):
        """``(first, last)`` columns of ones in each row of the mask, the
        centre tap included."""
        with span("prep.kernel"):
            size, mid = self.size, self.size // 2
            if size < 5:
                return [(0, size - 1)] * size
            half = (math.isqrt(mid * mid - (r - mid) ** 2) for r in range(size))
            return [(mid - hw, min(mid + hw, size - 1)) for hw in half]

    @functools.cached_property
    def taps(self) -> int:
        """The number of ones in the mask."""
        return sum(b - a + 1 for a, b in self._row_spans) - self.exclude_center

    @functools.cached_property
    def runs(self):
        """``[(row, first_col, last_col), ...]``: the runs of ones of the mask
        flipped in both axes, row by row and left to right, as
        ``ops.conv._binary_kernel_runs(circular_kernel(...)[::-1, ::-1])``
        finds them."""
        with span("prep.runs"):
            last, centre = self.size - 1, self.size - 1 - self.size // 2
            runs = []
            for r, (a, b) in enumerate(reversed(self._row_spans)):
                lo, hi = last - b, last - a
                if self.exclude_center and r == centre:
                    runs += [(r, s, e) for s, e in ((lo, centre - 1), (centre + 1, hi)) if s <= e]
                else:
                    runs.append((r, lo, hi))
            return runs

    def dense(self) -> np.ndarray:
        """The mask, :func:`circular_kernel`'s float32 weights."""
        return circular_kernel(self.size, self.exclude_center)

    def __array__(self, dtype=None, copy=None):
        kernel = self.dense()
        return kernel if dtype is None else kernel.astype(dtype, copy=False)
