"""The frozen work model of the valley/ridge calls: the operations and bytes
one call at one scale needs, whatever implements it, and so the least time
one H100 takes for the window's ``compute_valley_ridge`` calls.

Per (angle, flat), for each of the 180 integer angles and each flat: one
real-FFT 'same' convolution of the H x W field with that angle's rotated
kernel, cut to the taps that can reach a grid pixel, ``min(k, 2H - 1)`` x
``min(k, 2W - 1)`` of the rotated side ``k`` (scipy's ``reshape``: the
rotated square's bounding box, ``int(ptp + 0.5)``), at the linear
convolution's padded size ``N = (H + ty - 1) (W + tx - 1)``: two real
transforms (the kernel's and the inverse), 2.5 N log2 N operations each,
and the pointwise complex product of the N / 2 bins, 6 operations each.
The field's transform is counted once per (scale, call), at the call's
largest N. Bytes: the grid read once and the two planes written.

Counted this way the work does not depend on how the program rotates,
folds, crops or convolves, so a later change of route cannot push the
share past 100%. Nothing of the program is imported; the pixel sizes come
from the benchmark's own ``reference.geometry``.
"""

from __future__ import annotations

import json
import math

from scipy import special

from portbench import work
from portbench.reference import geometry

ANGLES = range(180)
DEFAULT_FLATS = (0, 0.15, 0.3)  # pipeline.compute_valley_ridge's default flat_list


def transform_ops(n: int) -> float:
    """Operations of one real FFT of ``n`` points."""
    return 2.5 * n * math.log2(n)


def rotated_side(size: int, angle: float) -> int:
    """The side of a ``size`` x ``size`` kernel rotated by ``angle`` degrees
    with scipy's ``reshape=True``."""
    c, s = abs(float(special.cosdg(angle))), abs(float(special.sindg(angle)))
    return int((c + s) * size + 0.5)


def call_work(h: int, w: int, size: int, n_flats: int) -> tuple:
    """(operations, bytes) of one valley or ridge plane pair of an (H, W)
    field at kernel ``size`` px with ``n_flats`` flats."""
    ops, n_max = 0.0, 0
    for angle in ANGLES:
        k = rotated_side(size, angle)
        n = (h + min(k, 2 * h - 1) - 1) * (w + min(k, 2 * w - 1) - 1)
        ops += n_flats * (2 * transform_ops(n) + 3.0 * n)
        n_max = max(n_max, n)
    return ops + transform_ops(n_max), 4 * h * w * 3


def least_seconds(run, call: str = "compute_valley_ridge") -> float:
    """Least time of every completed ``call`` of the window: per scale one
    ``call_work`` at the published peaks (``work.least_seconds``)."""
    h, w = run.shape
    per_args, total = {}, 0.0
    for c in run.calls:
        if c.call != call or c.error:
            continue
        key = json.dumps(c.args, sort_keys=True)
        if key not in per_args:
            sizes = geometry.scale_to_pixel(c.args["scales"], run.x, run.y,
                                            run.config["grid"]["crs"])
            n_flats = len(c.args.get("flat_list", DEFAULT_FLATS))
            per_args[key] = sum(work.least_seconds(*call_work(h, w, int(px), n_flats))
                                for px in sizes)
        total += per_args[key]
    return total
