"""TerrainSuite: a battery of descriptors over one DEM in one call.

Counterpart of ``topo_descriptors_tpu/models/suite.py`` as an
``nn.Module``: ``forward(dem)`` returns the same named descriptors as the
JAX suite. The module has no weights; its buffers are the grid's metric
resolutions, so ``.to(device)`` moves it and ``forward`` computes where
they live.

One difference, on purpose: the Sx rays are built from the *signed*
resolutions (``res_y_m`` is negative on north-up grids), as the
``compute_sx`` drivers build them. The JAX suite takes their absolute
values, which mirrors the azimuth on such grids (ROADMAP C2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from topo_descriptors_tpu.kernels.sx_geometry import sx_offsets
from topo_descriptors_tpu_torch import ops
from topo_descriptors_tpu_torch.device import as_field, resolve_device


@dataclasses.dataclass(frozen=True)
class SuiteConfig:
    """Static configuration of a TerrainSuite.

    Scales are in pixels (odd, via geo.scale_to_pixel); resolutions in
    meters/pixel. Any section can be disabled with an empty tuple / None.
    """

    tpi_scales_pxl: Tuple[int, ...] = (9, 33)
    std_scales_pxl: Tuple[int, ...] = (9,)
    gradient_sigmas: Tuple[float, ...] = (2.25,)
    sig_ratios: Tuple[float, ...] = (1.0,)
    valley_size_pxl: Optional[int] = 9
    valley_flats: Tuple[float, ...] = (0, 0.15, 0.3)
    sx_azimuth: Optional[float] = 0.0
    sx_radius_m: float = 500.0
    res_x_m: float = 30.0
    res_y_m: float = -30.0


class TerrainSuite(nn.Module):
    """TPI, rolling STD, gradient/slope/aspect, valley index and Sx of one
    (H, W) grid, from one ``forward`` call."""

    def __init__(self, shape: Tuple[int, int], config: SuiteConfig = SuiteConfig(),
                 device="cuda"):
        super().__init__()
        self.shape = tuple(shape)
        self.config = config
        dev = resolve_device(device)
        self.register_buffer(
            "res_x", torch.full((shape[1],), config.res_x_m, dtype=torch.float32, device=dev),
            persistent=False)
        self.register_buffer(
            "res_y", torch.full((shape[0],), config.res_y_m, dtype=torch.float32, device=dev),
            persistent=False)
        self._sx_geom = None
        if config.sx_azimuth is not None:
            self._sx_geom = sx_offsets(
                config.sx_azimuth, config.sx_radius_m, config.res_x_m, config.res_y_m
            )

    def forward(self, dem) -> Dict[str, torch.Tensor]:
        """DEM -> named descriptor fields, on the module's device."""
        cfg = self.config
        dev = self.res_x.device
        dem = as_field(dem, dev)
        out: Dict[str, torch.Tensor] = {}
        for size in cfg.tpi_scales_pxl:
            out[f"tpi_{size}px"] = ops.tpi(dem, size, device=dev)
        for size in cfg.std_scales_pxl:
            out[f"std_{size}px"] = ops.std(dem, size, device=dev)
        res = {"x": self.res_x, "y": self.res_y}
        for sigma, ratio in zip(cfg.gradient_sigmas, cfg.sig_ratios):
            dx, dy, slope, aspect = ops.gradient(dem, sigma, res, ratio, device=dev)
            out[f"dx_s{sigma:g}"] = dx
            out[f"dy_s{sigma:g}"] = dy
            out[f"slope_s{sigma:g}"] = slope
            out[f"aspect_s{sigma:g}"] = aspect
        if cfg.valley_size_pxl:
            norm, direction = ops.valley_ridge(
                dem, cfg.valley_size_pxl, "valley", list(cfg.valley_flats), device=dev
            )
            out["valley_norm"] = norm
            out["valley_dir"] = direction
        if self._sx_geom is not None:
            offsets, distances, border = self._sx_geom
            out["sx"] = ops.sx(dem, offsets, distances, border, device=dev)
        return out
