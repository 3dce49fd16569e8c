"""Topographic Position Index (TPI)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from topo_descriptors_tpu_torch.device import as_field
from topo_descriptors_tpu_torch.kernels.disk import Disk
from topo_descriptors_tpu_torch.ops.conv import (
    conv2d_same,
    edge_count_plane_device,
    gaussian_filter,
)


def tpi(
    dem,
    size: int,
    sigma: Optional[float] = None,
    count_plane: Optional[np.ndarray] = None,
    center: Optional[float] = None,
    device="cuda",
) -> torch.Tensor:
    """Elevation difference of each pixel to the mean of its disk-shaped
    neighbourhood (centre tap excluded); counterpart of
    ``topo_descriptors_tpu.ops.tpi``.

    The convolution runs on the mean-centred field and the exact boundary
    tap-count plane restores the offset: the same value as ``dem -
    conv(dem, k)/sum(k)``, without the float32 digits the naive form loses
    to the large elevation offset.
    """
    dem = as_field(dem, device)
    kernel = Disk(size, exclude_center=True)
    kernel_sum = float(kernel.taps)

    if sigma:
        dem = gaussian_filter(dem, sigma)

    if count_plane is None:
        counts = edge_count_plane_device(dem.shape, kernel, dem.device)
    else:
        counts = as_field(count_plane, dem.device)

    if center is None:
        center = torch.round(torch.mean(dem))  # half to even, as jnp.round
    else:
        center = torch.tensor(center, dtype=dem.dtype, device=dem.device)
    conv_centered = conv2d_same(dem - center, kernel)
    neighbourhood_sum = conv_centered + center * counts
    return dem - neighbourhood_sum / kernel_sum
