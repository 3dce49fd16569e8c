"""Directional derivatives, slope and aspect."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from topo_descriptors_tpu_torch.device import as_field
from topo_descriptors_tpu_torch.kernels.sobel import sobel_kernel
from topo_descriptors_tpu_torch.ops.conv import convolve_reflect, gaussian_filter, gradient_axis


def sobel(dem, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel derivatives (normalized by 8, 'reflect' boundary);
    counterpart of ``topo_descriptors_tpu.ops.sobel``: ``ndimage.convolve``
    with the kernel (dx) and its transpose (dy)."""
    dem = as_field(dem, device)
    k = sobel_kernel()
    return convolve_reflect(dem, k), convolve_reflect(dem, k.T)


def gradient(
    dem,
    sigma: float,
    res_meters: Dict[str, object],
    sig_ratio: float = 1.0,
    device="cuda",
) -> List[torch.Tensor]:
    """W-E/S-N derivatives, slope (deg) and aspect (deg, N=0, E=90);
    counterpart of ``topo_descriptors_tpu.ops.gradient``.

    The route is chosen by *sigma*: ``sigma <= 1`` takes the Sobel filter,
    ``sig_ratio == 1`` ``np.gradient`` of the Gaussian-smoothed DEM, and
    anything else two anisotropic Gaussian passes, each differentiated
    along its own axis. The derivatives are divided by the metric
    resolution (``res_meters`` 'x'/'y', 1-D for projected grids, 2-D for
    geographic ones; numpy arrays or tensors). ``slope = atan(|grad|)``,
    ``aspect = (180 + atan2(dx, dy)) mod 360`` with the floor modulo.
    """
    dem = as_field(dem, device)
    if sigma <= 1:
        dx, dy = sobel(dem, device=dem.device)
    elif sig_ratio == 1:
        smooth = gaussian_filter(dem, sigma)
        dy = gradient_axis(smooth, 0)
        dx = gradient_axis(smooth, 1)
    else:
        sigma_perp = sigma * sig_ratio
        dx = gradient_axis(gaussian_filter(dem, (sigma_perp, sigma)), 1)
        dy = gradient_axis(gaussian_filter(dem, (sigma, sigma_perp)), 0)

    x_res = as_field(res_meters["x"], dem.device)
    y_res = as_field(res_meters["y"], dem.device)
    if y_res.dim() == 1:
        y_res = y_res[:, None]
    dx = dx / x_res
    dy = dy / y_res

    slope = torch.rad2deg(torch.atan(torch.sqrt(dx * dx + dy * dy)))
    aspect = torch.remainder(180.0 + torch.rad2deg(torch.atan2(dx, dy)), 360.0)
    return [dx, dy, slope, aspect]
