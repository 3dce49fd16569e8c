"""Smoothed-DEM descriptor."""

from __future__ import annotations

import torch

from topo_descriptors_tpu_torch.device import as_field
from topo_descriptors_tpu_torch.ops.conv import gaussian_filter


def dem(dem_array, sigma: float, device="cuda") -> torch.Tensor:
    """Gaussian-smoothed DEM at standard deviation ``sigma`` (pixels);
    counterpart of ``topo_descriptors_tpu.ops.dem``. Parity target:
    ``scipy.ndimage.gaussian_filter(dem, sigma)``. A zero or None sigma
    returns the DEM as a float32 tensor on ``device``."""
    dem_array = as_field(dem_array, device)
    if not sigma:
        return dem_array
    return gaussian_filter(dem_array, sigma)
