"""Rolling standard deviation over a disk neighbourhood."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.device import as_field
from topo_descriptors_tpu_torch.kernels.disk import circular_kernel
from topo_descriptors_tpu_torch.ops.conv import (
    conv2d_same_multi,
    edge_count_plane_device,
    gaussian_filter,
)


def std(
    dem,
    size: int,
    sigma: Optional[float] = None,
    count_plane: Optional[np.ndarray] = None,
    int32_parity: Optional[bool] = None,
    center: Optional[float] = None,
    device="cuda",
) -> torch.Tensor:
    """One-pass rolling standard deviation within a disk of diameter
    ``size``; counterpart of ``topo_descriptors_tpu.ops.std``.

    ``var = (conv(trunc32(dem)^2, k) - conv(dem, k)^2 / sum(k)) / (sum(k)-1)``
    clipped at 0. ``int32_parity`` (default ``CFG.std_int32_parity``)
    reproduces the reference's int32 truncation before squaring. The three
    moment fields are mean-centred before one batched convolution and the
    tap-count plane restores the offsets:

        sum_sq = Q + 2c*T + c^2*C,   sum = Z + c*C
    """
    if int32_parity is None:
        int32_parity = CFG.std_int32_parity
    dem = as_field(dem, device)
    kernel = circular_kernel(size)
    kernel_sum = float(kernel.sum())

    if sigma:
        dem = gaussian_filter(dem, sigma)

    if count_plane is None:
        counts = edge_count_plane_device(dem.shape, kernel, dem.device)
    else:
        counts = as_field(count_plane, dem.device)

    if center is None:
        c = torch.round(torch.mean(dem))
    else:
        c = torch.tensor(center, dtype=dem.dtype, device=dem.device)
    t = torch.trunc(dem) if int32_parity else dem
    t_c = t - c
    z_c = dem - c

    stack = torch.stack([t_c * t_c, t_c, z_c])
    q_conv, t_conv, z_conv = conv2d_same_multi(stack, kernel)

    sum_sq = q_conv + 2.0 * c * t_conv + c * c * counts
    sum_dem = z_conv + c * counts
    variance = (sum_sq - sum_dem * sum_dem / kernel_sum) / (kernel_sum - 1.0)
    return torch.sqrt(torch.clamp(variance, min=0.0))
