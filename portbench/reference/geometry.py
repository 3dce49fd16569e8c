"""Host geometry of the descriptors, written from MeteoSwiss/topo-descriptors'
semantics (helpers.py scale_to_pixel / get_sigmas, topo.py's disk, Sobel and
Sx ray construction, scipy.ndimage's Gaussian taps).

Plain NumPy. Imports nothing of the measured program: the benchmark's
reference works every table out again from the grid and the call's
arguments.
"""

from __future__ import annotations

import numpy as np

SCALE_STD = 4.0  # Gaussian standard deviations per unit scale (helpers.py)
GAUSS_TRUNCATE = 4.0  # scipy.ndimage.gaussian_filter's default


# WGS84 as the ``utm`` package that helpers.py calls has it (utm/conversion.py)
UTM_R = 6378137.0
UTM_E = 0.00669438
UTM_K0 = 0.9996


def is_geographic(crs: str) -> bool:
    """helpers.py's test: lat/lon degrees where the CRS is 'epsg:4326'."""
    return "epsg:4326" in crs.lower()


def utm_zone(lat: float, lon: float) -> int:
    """``utm.latlon_to_zone_number`` of one point, Norway and Svalbard
    included."""
    if 56 <= lat < 64 and 3 <= lon < 12:
        return 32
    if 72 <= lat <= 84 and lon >= 0:
        for edge, zone in ((9, 31), (21, 33), (33, 35), (42, 37)):
            if lon < edge:
                return zone
    return int((lon + 180) / 6) + 1


def utm_from_latlon(lat: np.ndarray, lon: np.ndarray) -> tuple:
    """``utm.from_latlon``'s (easting, northing) in metres, every point in
    the zone of the first one (a whole grid goes to one zone)."""
    lat, lon = np.asarray(lat, np.float64), np.asarray(lon, np.float64)
    zone = utm_zone(float(lat.flat[0]), float(lon.flat[0]))
    e, e2 = UTM_E, UTM_E * UTM_E
    e3, ep2 = e2 * UTM_E, UTM_E / (1.0 - UTM_E)
    m1 = 1 - e / 4 - 3 * e2 / 64 - 5 * e3 / 256
    m2 = 3 * e / 8 + 3 * e2 / 32 + 45 * e3 / 1024
    m3 = 15 * e2 / 256 + 45 * e3 / 1024
    m4 = 35 * e3 / 3072
    phi = np.radians(lat)
    sin, cos = np.sin(phi), np.cos(phi)
    tan = sin / cos
    tan2 = tan * tan
    tan4 = tan2 * tan2
    n = UTM_R / np.sqrt(1 - e * sin ** 2)
    c = ep2 * cos ** 2
    dlon = np.radians(lon) - np.radians((zone - 1) * 6 - 180 + 3)
    a = cos * (np.mod(dlon + np.pi, 2 * np.pi) - np.pi)
    a2 = a * a
    a3 = a2 * a
    a4 = a3 * a
    a5 = a4 * a
    a6 = a5 * a
    m = UTM_R * (m1 * phi - m2 * np.sin(2 * phi) + m3 * np.sin(4 * phi) - m4 * np.sin(6 * phi))
    easting = UTM_K0 * n * (a + a3 / 6 * (1 - tan2 + c)
                            + a5 / 120 * (5 - 18 * tan2 + tan4 + 72 * c - 58 * ep2)) + 500000
    northing = UTM_K0 * (m + n * tan * (a2 / 2 + a4 / 24 * (5 - tan2 + 9 * c + 4 * c ** 2)
                                        + a6 / 720 * (61 - 58 * tan2 + tan4 + 600 * c - 330 * ep2)))
    return easting, np.where(lat < 0, northing + 10000000, northing)


def resolution(x: np.ndarray, y: np.ndarray, crs: str = "epsg:32632") -> tuple:
    """Per-pixel metric resolution (signed: y descends on a north-up grid),
    as helpers.py gets it: ``np.gradient`` of the coordinate vectors of a
    projected grid; on a geographic one, of the whole lat/lon mesh taken to
    UTM and stored as float32, along x and along y (2-D arrays)."""
    if not is_geographic(crs):
        return np.gradient(np.asarray(x, np.float64)), np.gradient(np.asarray(y, np.float64))
    lon, lat = np.meshgrid(np.asarray(x, np.float64), np.asarray(y, np.float64))
    east, north = utm_from_latlon(lat, lon)
    return (np.gradient(east.astype(np.float32), axis=1),
            np.gradient(north.astype(np.float32), axis=0))


def scale_to_pixel(scales_m, x: np.ndarray, y: np.ndarray, crs: str = "epsg:32632") -> np.ndarray:
    """Meters to the nearest odd pixel count, over the mean absolute
    resolution of both axes; halves round to even, as ``np.round`` does."""
    return pixels_of(scales_m, *resolution(x, y, crs))


def pixels_of(scales_m, rx: np.ndarray, ry: np.ndarray) -> np.ndarray:
    """``scale_to_pixel`` from the grid's ``resolution``."""
    mean_res = np.mean(np.abs([rx.mean(), ry.mean()]))
    f = np.asarray(scales_m, np.float64) / mean_res
    return (np.round((f - 1) / 2) * 2 + 1).astype(np.int64)


def sigma_of(size_px: int, factor=1.0):
    """Gaussian sigma of a scale in pixels; None for no smoothing."""
    return None if not factor else float(factor) * float(size_px) / SCALE_STD


def disk(size: int, exclude_center: bool = False) -> np.ndarray:
    """Binary disk of diameter ``size``: pixels within ``int(size / 2)`` of
    the middle; below 5 pixels a full square (topo.py's small-size rule).
    TPI zeroes the middle tap."""
    size = int(size)
    mid = int(size / 2)
    if size < 5:
        k = np.ones((size, size), np.float64)
    else:
        yy, xx = np.mgrid[:size, :size]
        k = (((yy - mid) ** 2 + (xx - mid) ** 2) <= mid * mid).astype(np.float64)
    if exclude_center:
        k[mid, mid] = 0.0
    return k


def gaussian_taps(sigma: float) -> np.ndarray:
    """scipy.ndimage's order-0 Gaussian: ``exp(-x^2 / 2 sigma^2)`` on the
    integers within ``int(4 sigma + 0.5)``, summing to 1."""
    r = int(GAUSS_TRUNCATE * float(sigma) + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-0.5 * x * x / (float(sigma) ** 2))
    return w / w.sum()


def reflect_index(i: np.ndarray, n: int) -> np.ndarray:
    """scipy.ndimage's 'reflect' boundary (d c b a | a b c d | d c b a),
    repeated for indices any distance outside ``[0, n)``."""
    j = np.mod(i, 2 * n)
    return np.where(j >= n, 2 * n - 1 - j, j)


def smoothing_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) matrix of the 1-D Gaussian filter with the reflect boundary:
    ``M @ v`` is ``scipy.ndimage.gaussian_filter1d(v, sigma)``."""
    w = gaussian_taps(sigma)
    r = (len(w) - 1) // 2
    rows = np.repeat(np.arange(n), len(w))
    cols = reflect_index(np.arange(n)[:, None] + np.arange(-r, r + 1)[None, :], n).ravel()
    flat = np.bincount(rows * n + cols, weights=np.tile(w, n), minlength=n * n)
    return flat.reshape(n, n)


SOBEL_X = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float64) / 8.0  # topo.py:679-681


# --- Sx rays (topo.py sx: distance window, ray ends, Bresenham lines) --------


def sx_window(radius: float, dx: float, dy: float) -> np.ndarray:
    """Metric distance of each window pixel from the window's middle
    ``floor(len / 2)``; the window is ``np.arange(2 r_px + 1)`` long, with
    ``r_px = max(radius / |dy|, radius / |dx|)`` (a float)."""
    r_px = max(radius / abs(dy), radius / abs(dx))
    n = len(np.arange(2 * r_px + 1))
    c = np.floor((2 * r_px + 1) / 2)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return np.sqrt(((yy - c) * dy) ** 2 + ((xx - c) * dx) ** 2)


def line_pixels(start: np.ndarray, end: np.ndarray) -> list:
    """Lattice pixels from ``start`` towards ``end``: one step of the
    dominant axis per sample, snapped with ``np.rint``, the end itself left
    out."""
    delta = end - start
    n = int(np.abs(delta).max())
    if n == 0:
        return []
    unit = delta.astype(np.float64) / n
    out = []
    for t in range(1, n + 1):
        p = np.rint(start + unit * float(t)).astype(np.int64)
        if not np.array_equal(p, end):
            out.append(p)
    return out


def sx_rays(azimuth: float, radius: float, dx: float, dy: float, azimuth_arc: float = 10.0,
            azimuth_steps: int = 15, radius_min: float = 0.0) -> tuple:
    """``(offsets (K, 2), distances (K,), border)`` of one Sx call: the rays
    of ``azimuth_steps`` azimuths over the arc, each the line pixels from
    its end at ``radius`` to the window's middle, taken relative to
    ``border = int(window / 2)``; distances below ``radius_min`` are NaN.
    Duplicates are kept: a maximum does not mind them."""
    if azimuth_arc == 0:
        azimuth_steps = 1
    window = sx_window(radius, dx, dy)
    window[window < radius_min] = np.nan
    middle = np.floor(np.array(window.shape) / 2).astype(np.int64)
    border = int(window.shape[0] / 2)
    offsets, distances = [], []
    for az in np.deg2rad(np.linspace(azimuth - azimuth_arc / 2, azimuth + azimuth_arc / 2,
                                     azimuth_steps)):
        end_delta = np.array([np.rint(radius / dy * np.cos(az)), np.rint(radius / dx * np.sin(az))])
        start = (middle + end_delta).astype(np.int64)
        for p in line_pixels(start, middle):
            offsets.append(p - border)
            distances.append(window[p[0], p[1]])
    return np.array(offsets, np.int64).reshape(-1, 2), np.array(distances, np.float64), border
