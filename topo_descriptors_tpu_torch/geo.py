"""Geodesy + scale helpers (host-side, pure numpy).

The port's own copy of ``topo_descriptors_tpu/geo.py``:
the port imports nothing of the JAX package.

Replaces the reference's dependency stack for coordinate handling:

* ``utm.from_latlon`` (reference helpers.py:96) -> :func:`utm_from_latlon`,
  a self-contained WGS84 -> UTM transverse-Mercator projection using the
  standard Snyder series (the same math the ``utm`` PyPI package implements).
* ``scale_to_pixel`` (reference helpers.py:68-105) -> :func:`scale_to_pixel`
  on a :class:`~topo_descriptors_tpu_torch.grid.RasterGrid`.
* ``round_up_to_odd`` (reference helpers.py:108-111), ``get_sigmas``
  (reference helpers.py:114-134) -> same-named functions, same semantics.

All of this is grid *metadata* computation: it stays on the host; only raw
DEM blocks ever move to TPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.grid import Raster, check_dem

# --- WGS84 ellipsoid ---------------------------------------------------------
_R = 6378137.0  # semi-major axis
_E = 0.00669438  # first eccentricity squared
_E2 = _E * _E
_E3 = _E2 * _E
_E_P2 = _E / (1.0 - _E)
_K0 = 0.9996

_M1 = 1 - _E / 4 - 3 * _E2 / 64 - 5 * _E3 / 256
_M2 = 3 * _E / 8 + 3 * _E2 / 32 + 45 * _E3 / 1024
_M3 = 15 * _E2 / 256 + 45 * _E3 / 1024
_M4 = 35 * _E3 / 3072


def latlon_to_zone_number(latitude: float, longitude: float) -> int:
    """UTM zone for a lat/lon pair, with the Norway/Svalbard exceptions.

    For array input the zone is chosen from the first element, matching the
    behaviour of the ``utm`` package the reference calls (helpers.py:96):
    a whole grid is projected into one zone.
    """
    lat = np.asarray(latitude).flat[0]
    lon = np.asarray(longitude).flat[0]
    if 56 <= lat < 64 and 3 <= lon < 12:
        return 32
    if 72 <= lat <= 84 and lon >= 0:
        if lon < 9:
            return 31
        elif lon < 21:
            return 33
        elif lon < 33:
            return 35
        elif lon < 42:
            return 37
    return int((lon + 180) / 6) + 1


def utm_from_latlon(latitude, longitude, force_zone_number: Optional[int] = None):
    """Project WGS84 lat/lon (degrees) to UTM easting/northing (meters).

    Transverse-Mercator series identical to ``utm.from_latlon``
    (reference helpers.py:96); returns ``(easting, northing)`` float64 arrays
    broadcast to the input shape. Zone letter is not computed — the reference
    discards it too (helpers.py:96 unpacks only x, y).
    """
    lat = np.asarray(latitude, dtype=np.float64)
    lon = np.asarray(longitude, dtype=np.float64)
    if np.any((lat < -80.0) | (lat > 84.0)):
        raise ValueError("latitude out of UTM range [-80, 84]")

    zone = force_zone_number or latlon_to_zone_number(lat, lon)
    central_lon = (zone - 1) * 6 - 180 + 3

    lat_rad = np.radians(lat)
    lat_sin = np.sin(lat_rad)
    lat_cos = np.cos(lat_rad)
    lat_tan = lat_sin / lat_cos
    lat_tan2 = lat_tan * lat_tan
    lat_tan4 = lat_tan2 * lat_tan2

    lon_rad = np.radians(lon)
    central_lon_rad = np.radians(central_lon)

    n = _R / np.sqrt(1 - _E * lat_sin**2)
    c = _E_P2 * lat_cos**2

    a = lat_cos * _mod_angle(lon_rad - central_lon_rad)
    a2 = a * a
    a3 = a2 * a
    a4 = a3 * a
    a5 = a4 * a
    a6 = a5 * a

    m = _R * (
        _M1 * lat_rad
        - _M2 * np.sin(2 * lat_rad)
        + _M3 * np.sin(4 * lat_rad)
        - _M4 * np.sin(6 * lat_rad)
    )

    easting = (
        _K0
        * n
        * (
            a
            + a3 / 6 * (1 - lat_tan2 + c)
            + a5 / 120 * (5 - 18 * lat_tan2 + lat_tan4 + 72 * c - 58 * _E_P2)
        )
        + 500000
    )
    northing = _K0 * (
        m
        + n
        * lat_tan
        * (
            a2 / 2
            + a4 / 24 * (5 - lat_tan2 + 9 * c + 4 * c**2)
            + a6
            / 720
            * (61 - 58 * lat_tan2 + lat_tan4 + 600 * c - 330 * _E_P2)
        )
    )
    northing = np.where(lat < 0, northing + 10000000, northing)
    return easting, northing


def _mod_angle(value):
    """Wrap an angle to (-pi, pi]."""
    return np.mod(value + np.pi, 2 * np.pi) - np.pi


# --- scale conversion --------------------------------------------------------


def round_up_to_odd(f) -> np.ndarray:
    """Round float(s) to the nearest odd integer (reference helpers.py:108-111,
    golden-tested by reference test_helpers.py:6-11)."""
    return np.asarray(np.round((np.asarray(f) - 1) / 2) * 2 + 1, dtype=np.int64)


def scale_to_pixel(scales, dem: Raster):
    """Convert distances in meters to the closest odd number of pixels.

    Reference semantics (helpers.py:68-105): geographic grids are reprojected
    to UTM (from the 1-D coordinate vectors, bit for bit the reference's
    meshgrid) to obtain per-pixel metric resolutions via ``np.gradient``;
    the mean absolute resolution over both axes scales the requested
    meters; result rounds to the nearest odd pixel count.

    Returns
    -------
    scales_pxl : int64 array of odd kernel sizes in pixels
    res_meters : dict with 'x' and 'y' per-pixel resolution arrays
        (2-D for geographic grids, 1-D for projected ones)
    """
    check_dem(dem)
    res_meters = dem.grid.resolution_meters()
    mean_res = np.mean(np.abs([res_meters["x"].mean(), res_meters["y"].mean()]))
    return round_up_to_odd(np.array(scales) / mean_res), res_meters


def get_sigmas(
    smth_factors: Sequence[Union[float, None]], scales_pxl
) -> List[Optional[float]]:
    """Scales (pixels) -> Gaussian sigmas with None/0 passthrough.

    Reference semantics (helpers.py:114-134): ``sigma = factor * scale_pxl /
    scale_std``; a factor of None or 0 yields None (no smoothing).
    """
    factors = np.array([fact if fact else np.nan for fact in smth_factors])
    sigmas = factors * np.asarray(scales_pxl) / CFG.scale_std
    return [None if np.isnan(s) else float(s) for s in sigmas]
