"""Sx (Winstral) ray geometry, computed host-side.

The port's own copy of ``topo_descriptors_tpu/kernels/sx_geometry.py``:
the port imports nothing of the JAX package.

The reference builds the Sx scan from three geometric pieces
(topo.py:861-925): a metric distance window, ray-endpoint index deltas for
the azimuth arc, and vectorized Bresenham lines from each endpoint to the
centre. We reproduce those semantics (they are golden-tested by the
reference's own unit vectors, test/test_topo.py:6-67) and add
:func:`sx_offsets`, which collapses the line pixels into a static
``(K, 3)`` table of (dy, dx, 1/distance) — the form the TPU kernel consumes
as a shifted-max reduction instead of the reference's per-pixel Numba loop
(topo.py:928-953).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sx_distance(radius: float, dx: float, dy: float) -> np.ndarray:
    """Metric distance-from-centre window of size ~(2*radius_pxl+1)^2.

    Reference semantics (topo.py:861-878): ``radius_pxl = max(radius/|dy|,
    radius/|dx|)`` (float); the window length is ``np.arange(2*radius_pxl+1)``
    — i.e. ``ceil`` of the float size; distances use the *signed* per-axis
    resolutions. float64 output (golden: reference test_topo.py:6-28).
    """
    dx_abs = np.abs(dx)
    dy_abs = np.abs(dy)
    radius_pxl = max(radius / dy_abs, radius / dx_abs)

    window = 2 * radius_pxl + 1  # float; arange ceils it
    center = np.floor(window / 2)
    x = np.arange(window)
    y = np.arange(window)
    x, y = np.meshgrid(x, y)
    return np.sqrt((((y - center) * dy) ** 2) + ((x - center) * dx) ** 2)


def sx_source_idx_delta(azimuths, radius: float, dx: float, dy: float) -> np.ndarray:
    """Index deltas of ray endpoints at ``radius`` for each azimuth.

    Reference semantics (topo.py:881-892): rows are (dy_idx, dx_idx) =
    (rint(r/dy cos az), rint(r/dx sin az)), int64
    (golden: reference test_topo.py:57-67).
    """
    azimuths_rad = np.deg2rad(np.asarray(azimuths))
    delta_y_idx = np.rint(radius / dy * np.cos(azimuths_rad))
    delta_x_idx = np.rint(radius / dx * np.sin(azimuths_rad))
    return np.column_stack([delta_y_idx, delta_x_idx]).astype(np.int64)


def sx_bresenhamlines(start: np.ndarray, end: np.ndarray) -> np.ndarray:
    """All integer pixels on the lines from each start to the common end.

    Behavioural contract (pinned by the reference's own golden vectors,
    test_topo.py:31-54, mirrored in tests/test_kernels.py): each line is
    sampled at uniform float steps that advance its dominant axis by one
    pixel per step, ``np.rint``-snapped to the lattice, trimmed to the
    monotonically-approaching (L1) prefix, and the endpoint itself removed.
    Output is the per-line pixel lists concatenated in line order, (K, 2)
    int. Degenerate lines (start == end) contribute nothing: every sample
    is the endpoint, which is dropped.
    """
    start = np.asarray(start)
    end = np.asarray(end)
    line_vec = end - start  # (N, 2); a common (2,) endpoint broadcasts
    dominant = np.abs(line_vec).max(axis=1)  # dominant-axis length per line
    n_steps = int(dominant.max()) if dominant.size else 0

    # per-step float increment; zero-length lines step in place
    denom = np.where(dominant == 0, 1, dominant)[:, None]
    unit = line_vec.astype(np.float64) / denom
    unit[dominant == 0] = 0.0

    t = np.arange(1, n_steps + 1, dtype=np.float64)[None, :, None]
    samples = start[:, None, :] + unit[:, None, :] * t  # (N, steps, 2)
    samples = np.rint(samples).astype(start.dtype)

    # rint can stall or bounce past the endpoint on shallow lines: keep only
    # the prefix whose L1 distance to the endpoint never increases
    l1 = np.abs(samples - end).sum(axis=2)
    approaching = np.diff(l1, prepend=l1[:, :1]) <= 0
    kept = samples[approaching].reshape(-1, start.shape[-1])
    return kept[~np.all(kept == end, axis=1)]


def sx_offsets(
    azimuth: float,
    radius: float,
    dx: float,
    dy: float,
    azimuth_arc: float = 10.0,
    azimuth_steps: int = 15,
    radius_min: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Static offset table for the TPU Sx kernel.

    Reproduces the host-side geometry of reference sx() (topo.py:828-853):
    azimuth fan, distance window with radius_min masked to NaN, ray endpoints
    and Bresenham pixels — then recentres the line pixels to signed offsets.

    Returns
    -------
    offsets : (K, 2) int32 — (dy, dx) offsets relative to the target pixel,
        concatenated over all rays in the fan (duplicates kept: the max
        reduction makes them harmless, and keeping them preserves reference
        NaN semantics exactly).
    distances : (K,) float64 — metric distance per offset; NaN where the
        window pixel is closer than ``radius_min`` (reference topo.py:845).
    border : int — width of the untouched border the reference leaves at 0
        (``int(window_size/2)``, topo.py:932,940-941).
    """
    if azimuth_arc == 0:
        azimuth_steps = 1
    azimuths = np.linspace(
        azimuth - azimuth_arc / 2, azimuth + azimuth_arc / 2, azimuth_steps
    )

    window_distance = sx_distance(radius, dx, dy)
    window_distance[window_distance < radius_min] = np.nan

    window_center = np.floor(np.array(window_distance.shape) / 2)
    source_delta = sx_source_idx_delta(azimuths, radius, dx, dy)
    source = (window_center + source_delta).astype(int)
    lines = sx_bresenhamlines(source, window_center)

    distances = window_distance[lines[:, 0], lines[:, 1]]
    border = int(window_distance.shape[0] / 2)
    offsets = (lines - border).astype(np.int32)
    return offsets, distances, border


def sx_dedupe(
    offsets: np.ndarray, distances: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop duplicate ray pixels from one fan's offset table — EXACT.

    The reference's azimuth arc (default 10 deg over 15 rays,
    topo.py:832-834) spaces neighbouring rays well under one pixel apart
    until radius ~80 px, so the concatenated Bresenham tables are massively
    redundant: at 30 m resolution the fan holds 240 rows but only 32 unique
    pixels at r=500 m, 986 vs 464 at r=2000 m. Deduplication changes
    nothing: the distance is a pure function of the offset (the window
    lookup at that pixel, topo.py:861-878), duplicates therefore carry
    identical candidate values, and the nanmax over candidates
    (topo.py:951) is idempotent. Sorted lexicographically for deterministic
    tables -> stable jit/Mosaic cache keys.
    """
    offs = np.asarray(offsets)
    dists = np.asarray(distances)
    uniq, idx = np.unique(offs, axis=0, return_index=True)
    return uniq.astype(offs.dtype), dists[idx]


def sx_sweep_dedupe(
    offsets: np.ndarray, distances: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-azimuth :func:`sx_dedupe` over a padded (A, Kmax, 2) sweep
    table; the result is re-padded rectangular to the new (smaller) Kmax
    with the same zero-offset/NaN-distance convention."""
    offsets = np.asarray(offsets)
    distances = np.asarray(distances)
    per = []
    for a in range(offsets.shape[0]):
        pad_rows = np.isnan(distances[a]) & ~offsets[a].any(axis=1)
        o, d = sx_dedupe(offsets[a][~pad_rows], distances[a][~pad_rows])
        per.append((o, d))
    kmax = max(o.shape[0] for o, _ in per)
    out_o = np.zeros((len(per), kmax, 2), dtype=offsets.dtype)
    out_d = np.full((len(per), kmax), np.nan)
    for a, (o, d) in enumerate(per):
        out_o[a, : o.shape[0]] = o
        out_d[a, : d.shape[0]] = d
    return out_o, out_d


def sx_sweep_offsets(
    azimuths,
    radius: float,
    dx: float,
    dy: float,
    azimuth_arc: float = 10.0,
    azimuth_steps: int = 15,
    radius_min: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Offset tables for a fan of azimuths, padded rectangular.

    Per-azimuth ray counts differ slightly; rays are padded to the widest
    azimuth with zero offsets and NaN distances — NaN ratios are ignored by
    the device-side fmax exactly like radius_min exclusions, so padding is
    free. The border is azimuth-independent (window size depends only on
    radius and resolution, reference topo.py:861-869).

    Returns (offsets (A, Kmax, 2) int32, distances (A, Kmax) float64, border).
    """
    per_az = [
        sx_offsets(a, radius, dx, dy, azimuth_arc, azimuth_steps, radius_min)
        for a in np.atleast_1d(azimuths)
    ]
    border = per_az[0][2]
    kmax = max(o.shape[0] for o, _, _ in per_az)
    offsets = np.zeros((len(per_az), kmax, 2), dtype=np.int32)
    distances = np.full((len(per_az), kmax), np.nan)
    for i, (offs, dists, b) in enumerate(per_az):
        assert b == border
        offsets[i, : offs.shape[0]] = offs
        distances[i, : dists.shape[0]] = dists
    return offsets, distances, border
