"""Raster grid data model.

The port's own copy of ``topo_descriptors_tpu/grid.py``:
the port imports nothing of the JAX package.

The reference leans on ``xarray.Dataset`` for the DEM container: a single 2-D
variable with dims ``('y', 'x')``, coordinate arrays, and a ``crs`` attribute
holding an EPSG code (reference helpers.py:171-188 ``check_dem``,
helpers.py:191-196 ``get_da``). xarray is a host-side metadata wrapper; the
TPU framework replaces it with a light, dependency-free :class:`RasterGrid`
(coords + CRS + cached per-pixel metric resolution) and :class:`Raster`
(grid + one named 2-D field). Device code only ever sees the raw array;
the grid rides along host-side.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


class GridError(ValueError):
    """Raised when a DEM does not conform to the data model
    (mirrors reference helpers.py:171-188 check_dem failures)."""


@dataclasses.dataclass(frozen=True)
class RasterGrid:
    """A georeferenced 2-D grid: y/x coordinate vectors plus a CRS string.

    Mirrors the reference's data-model contract (helpers.py:171-188):
    dims are ``('y', 'x')`` and ``crs`` must contain an ``epsg:`` code.
    """

    y: np.ndarray  # (ny,) coordinate values along rows
    x: np.ndarray  # (nx,) coordinate values along columns
    crs: str  # e.g. "epsg:4326" or "epsg:21781"

    def __post_init__(self):
        object.__setattr__(self, "y", np.asarray(self.y))
        object.__setattr__(self, "x", np.asarray(self.x))
        if self.y.ndim != 1 or self.x.ndim != 1:
            raise GridError("grid coordinates must be 1-D arrays")
        if "epsg:" not in self.crs.lower():
            raise GridError(
                "missing 'epsg:' (case insensitive) key in the 'crs' attribute"
            )

    @property
    def shape(self):
        return (self.y.size, self.x.size)

    @property
    def is_geographic(self) -> bool:
        """True when coordinates are WGS84 lat/lon degrees
        (reference helpers.py:91 checks for 'epsg:4326')."""
        return "epsg:4326" in self.crs.lower()

    def resolution_meters(self) -> Dict[str, np.ndarray]:
        """Per-pixel metric resolution in x and y.

        Reference semantics (helpers.py:88-105): if the CRS is geographic,
        reproject a full coordinate meshgrid to UTM to obtain meters, then
        per-pixel resolutions via ``np.gradient`` (x along the last axis,
        y along the first). Projected grids use the 1-D coordinate vectors
        directly.

        Returns a dict with keys ``'x'`` and ``'y'``; arrays are 2-D for
        geographic grids and 1-D for projected ones, exactly as the
        reference returns them (helpers.py:105).
        """
        from topo_descriptors_tpu_torch.geo import utm_from_latlon

        x_coords, y_coords = self.x, self.y
        if self.is_geographic:
            x_mesh, y_mesh = np.meshgrid(x_coords, y_coords)
            x_m, y_m = utm_from_latlon(y_mesh, x_mesh)
            x_coords = x_m.astype(np.float32)
            y_coords = y_m.astype(np.float32)
        n_dims = x_coords.ndim
        x_res = np.gradient(x_coords, axis=n_dims - 1)
        y_res = np.gradient(y_coords, axis=0)
        return {"x": x_res, "y": y_res}

    def mean_resolution_meters(self) -> float:
        """Mean |resolution| over both axes (reference helpers.py:102)."""
        res = self.resolution_meters()
        return float(np.mean(np.abs([res["x"].mean(), res["y"].mean()])))

    def sel(self, crop: Optional[Dict[str, slice]]) -> "tuple[RasterGrid, tuple]":
        """Label-based crop, mirroring xarray ``.sel(crop)`` with slices
        (reference helpers.py:59). Returns (new_grid, (y_idx, x_idx) slices).

        Handles descending coordinate axes the way xarray does: a
        ``slice(min, max)`` selects values between the bounds in the axis's
        own order.
        """
        if crop is None:
            return self, (slice(None), slice(None))
        idx = {}
        for dim, coords in (("y", self.y), ("x", self.x)):
            sl = crop.get(dim)
            if sl is None:
                idx[dim] = slice(None)
                continue
            lo, hi = sl.start, sl.stop
            descending = coords.size > 1 and coords[1] < coords[0]
            if descending:
                mask = np.ones(coords.size, dtype=bool)
                if lo is not None:
                    mask &= coords <= lo
                if hi is not None:
                    mask &= coords >= hi
            else:
                mask = np.ones(coords.size, dtype=bool)
                if lo is not None:
                    mask &= coords >= lo
                if hi is not None:
                    mask &= coords <= hi
            where = np.flatnonzero(mask)
            if where.size == 0:
                idx[dim] = slice(0, 0)
            else:
                idx[dim] = slice(int(where[0]), int(where[-1]) + 1)
        new = RasterGrid(y=self.y[idx["y"]], x=self.x[idx["x"]], crs=self.crs)
        return new, (idx["y"], idx["x"])


@dataclasses.dataclass
class Raster:
    """One named 2-D field on a :class:`RasterGrid`.

    The moral equivalent of the reference's single-variable
    ``xarray.Dataset`` (helpers.py:57-58), carrying name, units and free-form
    attrs so NetCDF round-trips preserve metadata.
    """

    data: np.ndarray
    grid: RasterGrid
    name: str = "DEM"
    units: Optional[str] = None
    attrs: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.data = np.asarray(self.data)
        if self.data.shape != self.grid.shape:
            raise GridError(
                f"data shape {self.data.shape} != grid shape {self.grid.shape}"
            )

    @property
    def shape(self):
        return self.data.shape

    def crop(self, crop: Optional[Dict[str, slice]]) -> "Raster":
        grid, (yi, xi) = self.grid.sel(crop)
        return Raster(
            data=self.data[yi, xi],
            grid=grid,
            name=self.name,
            units=self.units,
            attrs=dict(self.attrs),
        )

    def with_data(self, data, name=None, units=None) -> "Raster":
        return Raster(
            data=np.asarray(data),
            grid=self.grid,
            name=name or self.name,
            units=units if units is not None else self.units,
            attrs=dict(self.attrs),
        )


def check_dem(dem: Raster) -> None:
    """Validate a DEM against the data model.

    Mirrors reference helpers.py:171-188: 2-D ('y','x') field with an EPSG
    CRS. Type/CRS violations raise :class:`GridError`.
    """
    lazy = hasattr(dem, "read_rows") and isinstance(
        getattr(dem, "grid", None), RasterGrid
    )
    if not isinstance(dem, Raster) and not lazy:
        raise GridError(
            "dem must be a topo_descriptors_tpu_torch.grid.Raster or a window "
            "reader (read_rows + RasterGrid)"
        )
    ndim = getattr(dem, "ndim", 2) if lazy else dem.data.ndim
    if ndim != 2:
        raise GridError("dem dimensions must be ('y', 'x')")
    # RasterGrid.__post_init__ already enforces the epsg: contract, but the
    # attrs dict may carry a stale override — check the live value.
    if "epsg:" not in dem.grid.crs.lower():
        raise GridError("missing 'epsg:' key in the 'crs' attribute")


def fill_na(dem: Raster):
    """Record NaN indices and interpolate them along x.

    Reference semantics (helpers.py:137-154): returns ``(ind_nans, filled)``
    where ``ind_nans`` is the ``np.where`` tuple of NaN positions and the
    fill is nearest-neighbour interpolation **along the x axis only** with
    extrapolation at row ends (xarray ``interpolate_na(dim='x',
    method='nearest', fill_value='extrapolate')``). Rows that are entirely
    NaN stay NaN.
    """
    data = np.asarray(dem.data, dtype=np.float32)
    ind_nans = np.where(np.isnan(data))
    filled = fill_na_block(data.copy(), np.asarray(dem.grid.x, np.float64))
    return ind_nans, dem.with_data(filled)


def fill_na_block(filled: np.ndarray, xc: np.ndarray) -> np.ndarray:
    """Nearest-in-x NaN fill of a block of rows, in place.

    Rows are independent (the reference interpolates along x only,
    helpers.py:148-151), which is what makes the fill streamable band by
    band. Interpolation runs in x-*coordinate* space (xarray uses the coord
    as the interpolation variable), with scipy interp1d 'nearest'
    tie-breaking: a point exactly on a midpoint takes the left neighbour.
    """
    for j in np.unique(np.where(np.isnan(filled))[0]):
        row = filled[j]
        good = ~np.isnan(row)
        if not good.any():
            continue
        good_x = xc[good]
        good_v = row[good]
        if good_x.size == 1:
            filled[j] = good_v[0]
            continue
        midpoints = 0.5 * (good_x[1:] + good_x[:-1])
        if good_x[0] > good_x[-1]:  # descending coordinate axis
            chosen = good_x.size - 1 - np.searchsorted(
                midpoints[::-1], xc, side="left"
            )
        else:
            chosen = np.searchsorted(midpoints, xc, side="left")
        filled[j] = good_v[chosen]
    return filled
