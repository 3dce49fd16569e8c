"""Fused multi-scale disk descriptors: TPI and rolling STD for S scales on
shared moment fields.

Counterpart of ``topo_descriptors_tpu.ops.multiscale``. The moment fields
(z-c, t-c, (t-c)^2) are built once and every scale runs one prefix-sum disk
convolution over the stack. TPI needs no convolution of its own: the
centre-zeroed disk conv is the full disk conv minus the centre value.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.device import as_field
from topo_descriptors_tpu_torch.kernels.disk import Disk
from topo_descriptors_tpu_torch.ops.conv import (
    conv2d_same_multi,
    edge_count_plane_device,
    gaussian_filter,
)


def disk_descriptors(
    dem,
    sizes: Sequence[int],
    sigma: Optional[float] = None,
    int32_parity: Optional[bool] = None,
    compute_tpi: bool = True,
    compute_std: bool = True,
    center: Optional[float] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """TPI and/or rolling STD at every disk size with one shared pre-smooth
    sigma (None for raw). Returns ``{"tpi": (S,H,W), "std": (S,H,W)}``."""
    if int32_parity is None:
        int32_parity = CFG.std_int32_parity
    dem = as_field(dem, device)
    sizes = [int(s) for s in sizes]
    if sigma:
        dem = gaussian_filter(dem, sigma)

    if center is None:
        c = torch.round(torch.mean(dem))
    else:
        c = torch.tensor(center, dtype=dem.dtype, device=dem.device)
    z_c = dem - c
    if compute_std:
        t = torch.trunc(dem) if int32_parity else dem
        t_c = t - c
        fields = torch.stack([z_c, t_c, t_c * t_c])  # shared across scales
    else:
        fields = z_c[None]

    out_tpi = []
    out_std = []
    for size in sizes:
        disk = Disk(size)
        ksum = float(disk.taps)
        count = edge_count_plane_device(dem.shape, disk, dem.device)
        convs = conv2d_same_multi(fields, disk)
        z_conv = convs[0]
        if compute_tpi:
            # centre-zeroed disk: subtract the centre tap contribution
            tpi_sum = (z_conv - z_c) + c * (count - 1.0)
            out_tpi.append(dem - tpi_sum / (ksum - 1.0))
        if compute_std:
            t_conv, q_conv = convs[1], convs[2]
            sum_sq = q_conv + 2.0 * c * t_conv + c * c * count
            sum_dem = z_conv + c * count
            var = (sum_sq - sum_dem * sum_dem / ksum) / (ksum - 1.0)
            out_std.append(torch.sqrt(torch.clamp(var, min=0.0)))

    result: Dict[str, torch.Tensor] = {}
    if compute_tpi:
        result["tpi"] = torch.stack(out_tpi)
    if compute_std:
        result["std"] = torch.stack(out_std)
    return result
