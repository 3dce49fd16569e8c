"""Sx (Winstral wind-shelter) horizon scan."""

from __future__ import annotations

import numpy as np
import torch

from topo_descriptors_tpu.kernels.sx_geometry import sx_dedupe
from topo_descriptors_tpu_torch.device import as_field
from topo_descriptors_tpu_torch.ops.cuda import sx_block


def sx(
    dem,
    offsets: np.ndarray,
    distances: np.ndarray,
    border: int,
    height: float = 10.0,
    zero_border: bool = True,
    device="cuda",
) -> torch.Tensor:
    """Maximum elevation angle (degrees) along the azimuth fan's ray pixels;
    counterpart of ``topo_descriptors_tpu.ops.sx``.

    For every pixel, ``atan(max_k (dem[p + o_k] - dem[p] - height) / d_k)``
    over the ray table from ``kernels.sx_offsets``, NaN-ignoring; a border
    of width ``border`` stays 0 when ``zero_border``. ``atan`` is monotonic,
    so it runs once, after the max. Quirks kept from the reference: NaN
    distances (``radius_min``) drop their candidates, and the distance-0
    pixel of even windows gives +-90 degrees through ``1/0 = inf`` (its
    ``0 * inf`` NaN is dropped). The exact deduplication
    (``kernels.sx_dedupe``) runs first.
    """
    dem = as_field(dem, device)
    offsets, distances = sx_dedupe(offsets, distances)
    return sx_block.sx_block(dem, offsets, distances, border, height, zero_border)
