"""NetCDF4-compatible raster I/O via h5py.

The port's own copy of ``topo_descriptors_tpu/io/netcdf.py``:
the port imports nothing of the JAX package.

NetCDF4 files are HDF5 files following the netCDF data model: coordinate
variables are HDF5 *dimension scales* attached to data variables. Writing
with those conventions makes the output interoperable with xarray/netCDF4
readers, mirroring the reference's output contract (helpers.py:34-65):
uppercase variable name, coords and attrs copied from the DEM, optional crop,
per-variable ``units`` attr, file name ``topo_<NAME>.nc``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.grid import Raster, RasterGrid

logger = logging.getLogger(__name__)

_RESERVED_ATTRS = ("DIMENSION_LIST", "CLASS", "NAME", "REFERENCE_LIST", "_Netcdf4Dimid")


def write_raster(raster: Raster, path) -> None:
    """Write one named 2-D variable with y/x coordinate scales (netCDF4 layout)."""
    import h5py

    path = Path(path)
    with h5py.File(path, "w") as f:
        for dim, vals in (("y", raster.grid.y), ("x", raster.grid.x)):
            d = f.create_dataset(dim, data=np.asarray(vals))
            d.make_scale(dim)
        v = f.create_dataset(raster.name, data=np.asarray(raster.data))
        v.dims[0].attach_scale(f["y"])
        v.dims[1].attach_scale(f["x"])
        if raster.units is not None:
            v.attrs["units"] = raster.units
        f.attrs["crs"] = raster.grid.crs
        for key, val in raster.attrs.items():
            if key not in ("crs",):
                try:
                    f.attrs[key] = val
                except TypeError:
                    f.attrs[key] = str(val)


def read_raster(path) -> Raster:
    """Read a single-variable NetCDF4/HDF5 raster written by this module or
    any netCDF4 writer following the same conventions."""
    import h5py

    path = Path(path)
    with h5py.File(path, "r") as f:
        coord_names = set()
        var_name = None
        for name, ds in f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            if ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                coord_names.add(name)
            elif ds.ndim >= 2:
                var_name = name
        if var_name is None:
            raise ValueError(f"no 2-D data variable found in {path}")
        v = f[var_name]
        data = np.asarray(v).squeeze()
        # coordinates: prefer attached dimension scales, else named y/x
        def coord_for(dim_idx, fallback):
            try:
                scales = v.dims[dim_idx]
                if len(scales):
                    return np.asarray(scales[0])
            except Exception:
                pass
            if fallback in f:
                return np.asarray(f[fallback])
            return np.arange(data.shape[dim_idx], dtype=np.float64)

        y = coord_for(0, "y")
        x = coord_for(1, "x")
        attrs = {}
        for key, val in f.attrs.items():
            if key in _RESERVED_ATTRS:
                continue
            attrs[key] = val.decode() if isinstance(val, bytes) else val
        crs = str(attrs.get("crs", ""))
        units = v.attrs.get("units")
        if isinstance(units, bytes):
            units = units.decode()
        grid = RasterGrid(y=y, x=x, crs=crs or "epsg:unknown")
        return Raster(
            data=data, grid=grid, name=var_name, units=units, attrs=attrs
        )


class NetCDFWindowReader:
    """Windowed (HDF5-hyperslab) reads of a NetCDF4 raster.

    The streaming counterpart of :func:`read_raster` for grids larger than
    RAM: coordinates and attrs are loaded eagerly (they are 1-D and small),
    the data variable stays on disk and is read per row/column window via
    h5py's hyperslab selection (SURVEY.md §7 step 7 — the ingest half of
    out-of-core; the reference's dask path, topo.py:177-178, still opens
    the whole array through xarray). Protocol-compatible with
    :class:`~topo_descriptors_tpu_torch.io.geotiff.GeoTiffWindowReader`:
    ``shape``/``dtype``/``grid``, ``read_rows``, slicing, context manager.
    """

    def __init__(self, path, name: Optional[str] = None):
        import h5py

        self._f = h5py.File(Path(path), "r")
        var_name = None
        for nm, ds in self._f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            if ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                continue
            if name is not None and nm == name:
                var_name = nm
                break
            if name is None and ds.ndim >= 2:
                var_name = nm
        if var_name is None:
            raise ValueError(f"no 2-D data variable found in {path}")
        self._v = self._f[var_name]
        if self._v.ndim != 2:
            raise ValueError(
                f"windowed reads need a 2-D variable, {var_name} is "
                f"{self._v.ndim}-D"
            )
        self.name = var_name
        units = self._v.attrs.get("units")
        self.units = units.decode() if isinstance(units, bytes) else units
        self.dtype = self._v.dtype
        self.height, self.width = self._v.shape

        def coord_for(dim_idx, fallback):
            try:
                scales = self._v.dims[dim_idx]
                if len(scales):
                    return np.asarray(scales[0])
            except Exception:
                pass
            if fallback in self._f:
                return np.asarray(self._f[fallback])
            return np.arange(self._v.shape[dim_idx], dtype=np.float64)

        self.attrs = {}
        for key, val in self._f.attrs.items():
            if key in _RESERVED_ATTRS:
                continue
            self.attrs[key] = val.decode() if isinstance(val, bytes) else val
        crs = str(self.attrs.get("crs", "")) or "epsg:unknown"
        self.grid = RasterGrid(y=coord_for(0, "y"), x=coord_for(1, "x"), crs=crs)

    @property
    def shape(self):
        return (self.height, self.width)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getitem__(self, key) -> np.ndarray:
        rows, cols = key if isinstance(key, tuple) else (key, slice(None))
        r0, r1, step = rows.indices(self.height)
        c0, c1, cstep = cols.indices(self.width)
        if step != 1 or cstep != 1:
            raise ValueError("windowed reads support contiguous slices only")
        return self.read_rows(r0, r1, c0, c1)

    def read_rows(
        self, r0: int, r1: int, c0: int = 0, c1: Optional[int] = None
    ) -> np.ndarray:
        if c1 is None:
            c1 = self.width
        if not (0 <= r0 <= r1 <= self.height and 0 <= c0 <= c1 <= self.width):
            raise ValueError(f"window [{r0}:{r1}, {c0}:{c1}] out of bounds")
        if r1 == r0 or c1 == c0:
            return np.zeros((r1 - r0, c1 - c0), dtype=self.dtype)
        return self._v[r0:r1, c0:c1]

    def to_raster(self) -> Raster:
        return Raster(
            data=self.read_rows(0, self.height),
            grid=self.grid,
            name=self.name,
            units=self.units,
            attrs=dict(self.attrs),
        )


class RasterBandWriter:
    """Streamed NetCDF4 writer: create the file up front, append row bands.

    The output half of the out-of-core story — descriptor outputs for
    continental grids are written band-by-band as the
    :class:`~topo_descriptors_tpu_torch.parallel.tiles.TiledRunner` produces
    them, so peak host memory stays at one band regardless of grid size.
    Same on-disk conventions as :func:`write_raster` (dimension scales,
    crs/units attrs, reference contract helpers.py:34-65).
    """

    def __init__(
        self,
        path,
        grid: RasterGrid,
        name: str,
        units: Optional[str] = None,
        attrs: Optional[Dict] = None,
        dtype=np.float32,
        chunk_rows: int = 512,
    ):
        import h5py

        self.path = Path(path)
        # atomic-completion contract (checkpoint/resume soundness): bands
        # stream into a .partial file that is renamed onto the final path
        # only on successful close(). A crash mid-write therefore never
        # leaves a final-named file, so the drivers' --skip-existing can
        # trust existence (a pre-round-5 crash left truncated outputs that
        # a resume would silently have kept).
        self._tmp_path = self.path.with_name(self.path.name + ".partial")
        self._f = h5py.File(self._tmp_path, "w")
        ny, nx = grid.shape
        for dim, vals in (("y", grid.y), ("x", grid.x)):
            d = self._f.create_dataset(dim, data=np.asarray(vals))
            d.make_scale(dim)
        self._v = self._f.create_dataset(
            name, shape=(ny, nx), dtype=dtype,
            chunks=(min(chunk_rows, ny), nx),
        )
        self._v.dims[0].attach_scale(self._f["y"])
        self._v.dims[1].attach_scale(self._f["x"])
        if units is not None:
            self._v.attrs["units"] = units
        self._f.attrs["crs"] = grid.crs
        for key, val in (attrs or {}).items():
            if key not in ("crs",):
                try:
                    self._f.attrs[key] = val
                except TypeError:
                    self._f.attrs[key] = str(val)

    def write_rows(self, r0: int, block: np.ndarray) -> None:
        self._v[r0 : r0 + block.shape[0]] = block

    def close(self):
        import os

        if self._f is not None:
            self._f.close()
            self._f = None
            os.replace(self._tmp_path, self.path)

    def abort(self):
        """Close and discard the partial file (error paths)."""
        if self._f is not None:
            self._f.close()
            self._f = None
            self._tmp_path.unlink(missing_ok=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            self.abort()
        else:
            self.close()


def get_dem_netcdf(path_dem) -> Raster:
    """Load a DEM and mask low elevations.

    Reference semantics (helpers.py:17-31): cast float32, squeeze, and set
    elevations <= CFG.min_elevation to NaN. GeoTIFF files (.tif/.tiff) are
    dispatched to the built-in GeoTIFF reader.
    """
    suffix = str(path_dem).lower()
    if suffix.endswith((".tif", ".tiff")):
        from topo_descriptors_tpu_torch.io.geotiff import read_geotiff

        raster = read_geotiff(path_dem)
    else:
        raster = read_raster(path_dem)
    data = raster.data.astype(np.float32)
    data = np.where(data > CFG.min_elevation, data, np.nan)
    return raster.with_data(data)


def to_netcdf(
    array,
    dem: Raster,
    name: str,
    crop: Optional[Dict[str, slice]] = None,
    outdir=".",
    units: Optional[str] = None,
) -> Path:
    """Save one descriptor array next to the DEM's coords/attrs.

    Reference semantics (helpers.py:34-65): uppercase name, optional crop via
    label-based selection, ``units`` variable attr, file ``topo_<NAME>.nc``.
    Returns the written path.
    """
    name = str.upper(name)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    out = Raster(
        data=np.asarray(array),
        grid=dem.grid,
        name=name,
        units=units,
        attrs=dict(dem.attrs) | {"crs": dem.grid.crs},
    ).crop(crop)
    filename = outdir / f"topo_{name}.nc"
    write_raster(out, filename)
    logger.info(f"saved: {filename}")
    return filename
