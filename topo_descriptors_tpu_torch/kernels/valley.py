"""Valley/ridge V- and U-shaped kernels and their rotation bank.

The port's own copy of ``topo_descriptors_tpu/kernels/valley.py``:
the port imports nothing of the JAX package.

Reference construction (topo.py:466-531): a column-symmetric ramp
``|row - mid|`` with a flattened centre band per ``flat`` fraction, each
kernel standardized to mean 0 / std 1; the ridge bank is the valley bank
negated; per angle the 3-D stack is rotated with ``ndimage.rotate(order=2,
reshape=True, cval=-9999)``, masked, re-standardized over valid pixels and
zero-filled outside.

TPU restructure: the reference rotates kernels *inside* its 180-iteration
angle loop (topo.py:441-443). Here the full 180-angle bank is precomputed
host-side once (it is tiny — 180 x n_flats x k x k floats) so the device-side
op is a single batched convolution with a fused running max, with no host
round-trips between angles. The port rotates its banks on the device
(``ops.valley_ridge.device_valley_bank``, scipy's coordinates in float64);
the host bank here is the JAX package's exchange format and the tests'
reference.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def valley_kernels(size: int, flat_list: Sequence[float]) -> np.ndarray:
    """Normalized V/U-shape kernels, one per flat fraction.

    Returns a float32 array of shape ``(len(flat_list), size, size)``.
    Matches reference topo.py:466-499 including its in-loop re-standardization
    of the *whole* stack (the reference standardizes all kernels once per
    flat-list entry; repeated standardization is idempotent after the first
    pass, so the net effect is every kernel standardized).
    """
    size = int(size)
    middle = int(np.floor(size / 2))
    ramp = np.broadcast_to(np.arange(0, middle + 1), (size, middle + 1)).T
    ramp = np.concatenate((np.flip(ramp[1:, :], axis=0), ramp), axis=0)
    ramp = np.asarray(ramp, dtype=np.float32)
    kernels = np.broadcast_to(ramp, (len(flat_list), size, size)).copy()

    for ind, flat in enumerate(flat_list):
        halfwidth = int(np.floor(np.floor(size * flat / 2) + 0.5))
        kernels[ind, middle - halfwidth : middle + halfwidth + 1, :] = kernels[
            ind, middle - halfwidth, 0
        ]
        kernels = (kernels - np.mean(kernels, axis=(1, 2), keepdims=True)) / np.std(
            kernels, axis=(1, 2), keepdims=True
        )
    return kernels


def ridge_kernels(size: int, flat_list: Sequence[float]) -> np.ndarray:
    """Ridge bank = negated valley bank (reference topo.py:502-518)."""
    return valley_kernels(size, flat_list) * -1


def rotate_kernels(kernels: np.ndarray, angle: float) -> np.ndarray:
    """Rotate a (flats, k, k) stack in the spatial plane.

    Reference semantics (topo.py:521-531): spline order 2, reshape=True,
    constant cval=-9999 marking out-of-support pixels, which are masked out of
    the re-standardization and zero-filled afterwards. The rotation itself is
    delegated to scipy.ndimage host-side — these are host-side constants, and
    scipy guarantees bit-parity with the reference bank.

    The reference's ``numpy.ma`` standardization is replaced by plain masked
    arithmetic: identical summation order, so bit-identical output, and ~37x
    faster (1.15 s -> 0.03 s on a (3, 667, 667) stack) — at streamed
    20-100 km scales the masked-array overhead would otherwise dominate the
    whole descriptor.
    """
    from scipy import ndimage  # host-side only; baked into the image

    rot = ndimage.rotate(
        kernels, angle, axes=(1, 2), reshape=True, order=2, mode="constant",
        cval=-9999,
    )
    valid = rot != -9999
    zero_filled = np.where(valid, rot, 0)
    cnt = valid.sum(axis=(1, 2), keepdims=True)
    mean = zero_filled.sum(axis=(1, 2), keepdims=True) / cnt
    anom = np.where(valid, rot - mean, 0)
    var = (anom * anom).sum(axis=(1, 2), keepdims=True) / cnt
    return np.where(valid, anom / np.sqrt(var), 0).astype(np.float32)


def rotated_shape(size: int, angle: float) -> tuple:
    """Output spatial shape of ``rotate_kernels`` for one angle, without
    rotating.

    Mirrors scipy.ndimage.rotate's reshape=True rule (the reference relies
    on it, topo.py:524): rotate the input bounding box by the exact-degree
    trig pair and take ``int(ptp + 0.5)`` per axis. Used to size the
    streamed valley/ridge FFT and the tiled runner's halo before any kernel
    is built — at 100 km scales the full bank would be tens of GB, so
    shapes must be known up front.
    """
    from scipy.special import cosdg, sindg  # exact at multiples of 90

    c, s = float(cosdg(angle)), float(sindg(angle))
    extent = abs(c) * size + abs(s) * size
    n = int(extent + 0.5)
    return (n, n)


def rotated_extent(size: int, angles=None) -> tuple:
    """Max (ky, kx) over the whole rotation bank (default angles 0..179)."""
    if angles is None:
        angles = np.arange(0, 180, dtype=np.float32)
    shapes = [rotated_shape(size, float(a)) for a in angles]
    return (max(s[0] for s in shapes), max(s[1] for s in shapes))


def rotated_kernel_bank(
    size: int, mode: str, flat_list: Sequence[float], angles=None
) -> List[np.ndarray]:
    """Precompute the full rotated bank for every angle.

    Returns a list (one entry per angle, default 0..179 degrees as in
    reference topo.py:432) of float32 arrays shaped ``(n_flats, ky, kx)``.
    Spatial dims vary with the angle because reshape=True grows the support;
    the device-side op pads each to a common static shape.
    """
    if mode not in ("valley", "ridge"):
        raise ValueError(f"Unknown mode {mode!r}")
    base = ridge_kernels(size, flat_list) if mode == "ridge" else valley_kernels(
        size, flat_list
    )
    if angles is None:
        angles = np.arange(0, 180, dtype=np.float32)
    return [rotate_kernels(base, float(a)) for a in angles]
