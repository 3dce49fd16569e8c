"""Streaming DEM ingest: lazy, window-addressable DEM views.

The port's own copy of ``topo_descriptors_tpu/io/windowed.py``:
the port imports nothing of the JAX package.

Glues the window readers (:class:`~topo_descriptors_tpu_torch.io.geotiff.
GeoTiffWindowReader`, :class:`~topo_descriptors_tpu_torch.io.netcdf.
NetCDFWindowReader`) to the reference's ingest protocol — float32 cast,
``min_elevation`` masking (helpers.py:17-31) and nearest-in-x NaN fill
(helpers.py:137-154) — applied *per window* instead of on a materialized
array. Because the NaN fill interpolates along x only, every transformation
here is row-local: a windowed view is bit-identical to running
``get_dem_netcdf`` + ``fill_na`` on the whole grid and slicing the result.

This is the ingest half of the out-of-core story (SURVEY.md §7 step 7):
:class:`~topo_descriptors_tpu_torch.parallel.tiles.TiledRunner` can band-stream a
:class:`DemWindowReader` directly, so a continental raster never exists in
host RAM — only one halo-extended band at a time.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.grid import fill_na_block


def open_dem_window(path, name: Optional[str] = None):
    """Open a raster file as a window reader (GeoTIFF or NetCDF4/HDF5)."""
    suffix = str(path).lower()
    if suffix.endswith((".tif", ".tiff")):
        from topo_descriptors_tpu_torch.io.geotiff import GeoTiffWindowReader

        return GeoTiffWindowReader(path, name or "DEM")
    from topo_descriptors_tpu_torch.io.netcdf import NetCDFWindowReader

    return NetCDFWindowReader(path, name)


class DemWindowReader:
    """A lazy DEM: windowed reads with ingest semantics applied per window.

    Every window is served as float32 with elevations <= ``min_elevation``
    masked to NaN (reference helpers.py:31) and — when ``fill=True`` —
    NaNs nearest-in-x interpolated (reference helpers.py:137-154). Use
    :meth:`nan_rows` to recover the pre-fill NaN mask of a band so
    descriptor outputs can re-assign NaN at the original holes, the
    streaming analog of the wrappers' ``array[ind_nans] = NaN``
    (reference topo.py:57,139,267).
    """

    def __init__(self, path, name: Optional[str] = None, fill: bool = True):
        self._reader = open_dem_window(Path(path), name)
        self.fill = bool(fill)
        self.grid = self._reader.grid
        self.name = getattr(self._reader, "name", "DEM") or "DEM"
        self.units = getattr(self._reader, "units", "m") or "m"
        self.attrs = dict(getattr(self._reader, "attrs", {}))
        self.dtype = np.dtype(np.float32)
        self._xc = np.asarray(self.grid.x, dtype=np.float64)
        self.max_rows_read = 0  # observability: largest single window served

    # -- protocol -----------------------------------------------------------
    @property
    def shape(self):
        return self._reader.shape

    @property
    def ndim(self) -> int:
        return 2

    def close(self):
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getitem__(self, key) -> np.ndarray:
        rows = key[0] if isinstance(key, tuple) else key
        cols = key[1] if isinstance(key, tuple) else slice(None)
        r0, r1, step = rows.indices(self.shape[0])
        c0, c1, cstep = cols.indices(self.shape[1])
        if step != 1 or cstep != 1:
            raise ValueError("windowed reads support contiguous slices only")
        if c0 != 0 or c1 != self.shape[1]:
            # the x-fill needs the full row; read it, then column-slice
            return self.read_rows(r0, r1)[:, c0:c1]
        return self.read_rows(r0, r1)

    def __array__(self, dtype=None, copy=None):
        full = self.read_rows(0, self.shape[0])
        return full if dtype is None else full.astype(dtype)

    # -- ingest-transformed windows ------------------------------------------
    def _masked(self, r0: int, r1: int) -> np.ndarray:
        self.max_rows_read = max(self.max_rows_read, r1 - r0)
        raw = self._reader.read_rows(r0, r1).astype(np.float32)
        return np.where(raw > CFG.min_elevation, raw, np.nan)

    def read_rows(self, r0: int, r1: int) -> np.ndarray:
        block = self._masked(r0, r1)
        if self.fill:
            block = fill_na_block(block, self._xc)
        return block

    def nan_rows(self, r0: int, r1: int) -> np.ndarray:
        """Boolean mask of the band's pre-fill NaN holes (row-local, so it
        can be recomputed per band without global bookkeeping)."""
        return np.isnan(self._masked(r0, r1))
