"""The host layer the port shares with the JAX package, in one place.

Scale conversion, grid metadata, NetCDF I/O, synthetic DEMs and the geometry tables (disk
kernels, Sx rays, valley/ridge kernels) are numpy code in
``topo_descriptors_tpu``'s jax-free modules; the port computes on them as
they are. Importing this module
loads neither ``jax`` nor ``h5py``.
"""

from topo_descriptors_tpu.geo import get_sigmas, scale_to_pixel
from topo_descriptors_tpu.grid import Raster, RasterGrid, check_dem, fill_na
from topo_descriptors_tpu.io.netcdf import get_dem_netcdf, read_raster, to_netcdf, write_raster
from topo_descriptors_tpu.io.synthetic import basodino_like_dem, synthetic_dem
from topo_descriptors_tpu.kernels.disk import circular_kernel
from topo_descriptors_tpu.kernels.valley import (
    ridge_kernels,
    rotate_kernels,
    rotated_extent,
    valley_kernels,
)
from topo_descriptors_tpu.kernels.sx_geometry import (
    sx_dedupe,
    sx_offsets,
    sx_sweep_dedupe,
    sx_sweep_offsets,
)

__all__ = [
    "get_sigmas",
    "scale_to_pixel",
    "Raster",
    "RasterGrid",
    "check_dem",
    "fill_na",
    "get_dem_netcdf",
    "read_raster",
    "to_netcdf",
    "write_raster",
    "basodino_like_dem",
    "synthetic_dem",
    "circular_kernel",
    "ridge_kernels",
    "rotate_kernels",
    "rotated_extent",
    "valley_kernels",
    "sx_dedupe",
    "sx_offsets",
    "sx_sweep_dedupe",
    "sx_sweep_offsets",
]
