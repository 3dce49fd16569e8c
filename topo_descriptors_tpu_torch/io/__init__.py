"""Geo I/O: NetCDF-compatible read/write and synthetic DEM generation.

The port's own copy of ``topo_descriptors_tpu/io/__init__.py``:
the port imports nothing of the JAX package.

The reference does I/O through xarray + netCDF4 (helpers.py:17-65). Neither
library is available here, so this package speaks the NetCDF4/HDF5 format
directly through h5py using HDF5 dimension scales — files it writes are
readable by netCDF4/xarray installations and vice versa.
"""

from topo_descriptors_tpu_torch.io.netcdf import (
    NetCDFWindowReader,
    RasterBandWriter,
    get_dem_netcdf,
    read_raster,
    to_netcdf,
    write_raster,
)
from topo_descriptors_tpu_torch.io.synthetic import synthetic_dem, basodino_like_dem
from topo_descriptors_tpu_torch.io.geotiff import (
    GeoTiffWindowReader,
    read_geotiff,
    write_geotiff,
)
from topo_descriptors_tpu_torch.io.windowed import DemWindowReader, open_dem_window

__all__ = [
    "get_dem_netcdf",
    "read_raster",
    "to_netcdf",
    "write_raster",
    "synthetic_dem",
    "basodino_like_dem",
    "read_geotiff",
    "write_geotiff",
    "GeoTiffWindowReader",
    "NetCDFWindowReader",
    "RasterBandWriter",
    "DemWindowReader",
    "open_dem_window",
]
