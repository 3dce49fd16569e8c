"""The frozen work model: the operations and bytes a descriptor needs, and
the least time one H100 takes for them.

Frozen here so that a roofline share reads the same work whatever later
implements TPI or Sx. ``disk_work`` and ``sx_work`` are copies of
``chip_smoke.py::disk_work`` and ``chip_smoke.py::sx_work``; the run
decomposition (``ops/conv.py::_binary_kernel_runs``), the run grouping
(``ops/cuda/disk_sat.py::group_runs``) and the ray grouping
(``ops/cuda/sx_block.py::ray_groups``) they used from the program are
rewritten below, and the disks and rays come from the benchmark's own
``reference.geometry``. Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import geometry

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# float32 outside the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of the operations' and the bytes' time at the peaks."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def kernel_runs(kernel: np.ndarray) -> list:
    """``[(row, first_col, last_col), ...]`` runs of ones, row by row, of the
    kernel flipped in both axes (the order a convolution reads it)."""
    k = np.asarray(kernel)[::-1, ::-1] != 0
    runs = []
    for r, row in enumerate(k):
        edges = np.diff(np.concatenate([[0], row.astype(np.int8), [0]]))
        runs += [(r, int(a), int(b) - 1)
                 for a, b in zip(np.nonzero(edges == 1)[0], np.nonzero(edges == -1)[0])]
    return runs


def group_runs(runs) -> list:
    """``[(a, b, (r0, r1, ...)), ...]``: the kernel rows that share the run
    ``[a, b]``, in order of first appearance."""
    by_cols: dict = {}
    for r, a, b in runs:
        by_cols.setdefault((a, b), []).append(r)
    return [(a, b, tuple(rows)) for (a, b), rows in by_cols.items()]


def same_pads(k: int) -> tuple:
    """(lo, hi) zero padding of a 'same' convolution with a k-tap axis."""
    s = (k - 1) // 2
    return k - 1 - s, s


def disk_work(shape, kshape, runs, pads):
    """(operations, bytes) of one disk convolution of a (B, H, W) stack.
    Only kernel rows whose padded row lies inside the field count: the
    others add prefix rows of zeros, exactly +0.0, which is no work the
    card must do. So: the row scan's one add per input of a field row, then
    per output one add per prefix read (2 per run whose row is inside), one
    subtraction per run group with a row inside and one add per such group
    after the first; the fields read once, the output written once."""
    (ly, hy), (lx, hx) = pads
    b, h, w = shape
    h_out, w_out = h + ly + hy - kshape[0] + 1, w + lx + hx - kshape[1] + 1

    def rows_inside(rows):
        """Per output row y, how many of ``rows`` have ly <= y + r < ly + h."""
        diff = np.zeros(h_out + 1, np.int64)
        for r in rows:
            y0, y1 = min(max(ly - r, 0), h_out), min(max(ly + h - r, 0), h_out)
            diff[y0] += 1
            diff[y1] -= 1
        return np.cumsum(diff[:-1])

    n_runs = rows_inside([r for r, _, _ in runs])
    n_groups = sum((rows_inside(rows) > 0).astype(np.int64)
                   for _, _, rows in group_runs(runs))
    per_row = 2 * n_runs + np.maximum(2 * n_groups - 1, 0)
    ops = b * w_out * int(per_row.sum()) + b * h * (w + lx + hx)
    return ops, 4 * b * (h * w + h_out * w_out)


def ray_groups(offsets, distances):
    """(offsets without NaN distances, (G,) group sizes): the rays grouped
    by identical float32 reciprocal distance."""
    with np.errstate(divide="ignore"):
        inv = (1.0 / np.asarray(distances, np.float64)).astype(np.float32)
    keep = ~np.isnan(inv)
    offs = np.asarray(offsets).reshape(-1, 2)[keep]
    _, sizes = np.unique(inv[keep], return_counts=True)
    return offs, sizes


def sx_work(shape, offsets, distances, border):
    """(operations, bytes) of the Sx kernels on an (H, W) DEM for one
    azimuth's rays ((K, 2) offsets) or a fan's ((A, K, 2)): per interior
    pixel (the zero border computes nothing) and azimuth, one fmax per kept
    ray and a subtraction, a product and an fmax per distance group; the
    DEM read once, one plane written per azimuth."""
    h, w = shape
    offsets = np.asarray(offsets).reshape(-1, *np.asarray(offsets).shape[-2:])
    distances = np.asarray(distances).reshape(len(offsets), -1)
    interior = max(h - 2 * border, 0) * max(w - 2 * border, 0)
    ops = 0
    for o, d in zip(offsets, distances):
        offs, sizes = ray_groups(o, d)
        ops += interior * (len(offs) + 3 * len(sizes))
    return ops, 4 * h * w * (1 + len(offsets))


def tpi_work(h: int, w: int, size: int):
    """(operations, bytes) of one TPI plane: one 'same' convolution of one
    field with the disk of ``size`` pixels without its middle tap."""
    k = geometry.disk(size, exclude_center=True)
    return disk_work((1, h, w), k.shape, kernel_runs(k), (same_pads(size), same_pads(size)))


def sx_call_work(h: int, w: int, azimuth: float, radius: float, dx: float, dy: float):
    """(operations, bytes) of one Sx plane, over the call's distinct ray
    pixels."""
    offsets, distances, border = geometry.sx_rays(azimuth, radius, dx, dy)
    offsets, first = np.unique(offsets, axis=0, return_index=True)
    return sx_work((h, w), offsets, distances[first], border)
