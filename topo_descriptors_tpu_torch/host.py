"""The port's host layer, in one place.

Scale conversion, grid metadata, NetCDF and GeoTIFF I/O (whole rasters,
window readers and the band writer), synthetic DEMs and the geometry
tables (disk kernels, Gaussian radii, Sx rays, valley/ridge kernels) are
numpy code in the port's own ``config``, ``geo``, ``grid``, ``io`` and
``kernels`` modules, copies of the JAX package's jax-free modules in the
same layout; the port imports nothing of the JAX package. Importing this
module loads neither ``jax`` nor ``h5py``.
"""

from topo_descriptors_tpu_torch.geo import get_sigmas, scale_to_pixel
from topo_descriptors_tpu_torch.grid import Raster, RasterGrid, check_dem, fill_na, fill_na_block
from topo_descriptors_tpu_torch.io.geotiff import GeoTiffWindowReader, write_geotiff
from topo_descriptors_tpu_torch.io.netcdf import (
    NetCDFWindowReader,
    RasterBandWriter,
    get_dem_netcdf,
    read_raster,
    to_netcdf,
    write_raster,
)
from topo_descriptors_tpu_torch.io.synthetic import basodino_like_dem, synthetic_dem
from topo_descriptors_tpu_torch.io.windowed import DemWindowReader, open_dem_window
from topo_descriptors_tpu_torch.kernels.disk import circular_kernel
from topo_descriptors_tpu_torch.kernels.gaussian import gaussian_radius
from topo_descriptors_tpu_torch.kernels.sx_geometry import (
    sx_dedupe,
    sx_offsets,
    sx_sweep_dedupe,
    sx_sweep_offsets,
)
from topo_descriptors_tpu_torch.kernels.valley import (
    ridge_kernels,
    rotate_kernels,
    rotated_extent,
    valley_kernels,
)

__all__ = [
    "get_sigmas",
    "scale_to_pixel",
    "Raster",
    "RasterGrid",
    "check_dem",
    "fill_na",
    "fill_na_block",
    "GeoTiffWindowReader",
    "write_geotiff",
    "NetCDFWindowReader",
    "RasterBandWriter",
    "get_dem_netcdf",
    "read_raster",
    "to_netcdf",
    "write_raster",
    "basodino_like_dem",
    "synthetic_dem",
    "DemWindowReader",
    "open_dem_window",
    "circular_kernel",
    "gaussian_radius",
    "ridge_kernels",
    "rotate_kernels",
    "rotated_extent",
    "valley_kernels",
    "sx_dedupe",
    "sx_offsets",
    "sx_sweep_dedupe",
    "sx_sweep_offsets",
]
