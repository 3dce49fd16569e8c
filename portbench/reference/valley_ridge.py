"""Plain reference of the valley and ridge indices.

Written from MeteoSwiss/topo-descriptors' ``valley_ridge`` and its kernels
(topo.py:389-531), in float64 PyTorch on a ``Reference``'s device, with
no bank, fold, cache or rotation of the measured program:

* the field (``Reference.smooth``, the filled DEM pre-smoothed at
  ``sigma``) standardised by its global mean and population standard
  deviation;
* one V (valley) or, negated, Λ (ridge) kernel per flat fraction, each
  standardised (topo.py:466-518);
* for each integer angle 0..179, the stack rotated as
  ``scipy.ndimage.rotate(order=2, reshape=True, mode="constant",
  cval=-9999)`` rotates it (``rotated``, on the device), the -9999 pixels
  masked out of a re-standardisation and filled with 0 (topo.py:521-531);
  the angle is a float64 (topo.py's float32 angles make scipy round the
  rotation's sine and cosine to float32, a rounding like any other of its
  float32 arithmetic);
* the 3-D ``signal.convolve(field stack, kernels, mode="same")`` over
  (flat, y, x), in an exact form: every flat of the field stack is the
  same field, so output flat ``f`` is the 2-D 'same' convolution of the
  field with the sum of the kernels that the depth window of the 3-D
  definition puts over it (flats ``c0 + f - F + 1 .. c0 + f`` that exist,
  ``c0 = (F - 1) // 2``); each such sum is cropped to the (2H - 1) x
  (2W - 1) taps that can reach a grid pixel and convolved through float64
  2-D FFTs of the full linear convolution, cropped as scipy crops 'same';
* the maximum over the flats, and the strictly greater running maximum
  and its angle over 0..179 (ties keep the earlier angle).

``NORM`` is that maximum clipped at 0, ``DIR`` its angle; voids are NaN in
both. Beside them ``lead``: the maximum less the largest response at any
other angle, the margin by which the direction wins, which weighs the
direction's gap (``outputs``): a program can pick another angle only where
its error exceeds the lead. Under ``precision="tf32"`` the standardised
field and each rotated kernel are rounded to TF32 before the product
(``Reference._q``) and the planes stored as float32.

The rotation follows scipy's ``rotate``, ``affine_transform`` and
``spline_filter`` (scipy/ndimage/_interpolation.py and its C code):

* the output shape ``int(ptp(R @ corners) + 0.5)`` and the offset
  ``in_center - R @ out_center`` on the host in numpy, with R from
  ``scipy.special.cosdg`` and ``sindg``;
* each output pixel ``o`` read at ``(R @ o) + offset`` in float64, the
  products summed first and the offset added last, as scipy's C sums
  them; -9999 where that point leaves ``[0, n - 1]`` on either axis;
* the order-2 B-spline coefficients of each plane under the mirror
  boundary that scipy's spline filter takes for ``mode="constant"``: the
  solution of ``(c[i-1] + 6 c[i] + c[i+1]) / 8 = x[i]`` with
  ``c[-1] = c[1]`` and ``c[n] = c[n-2]``, along each axis in turn;
* the three quadratic B-spline weights per axis about ``floor(u + 0.5)``
  and the 3 x 3 taps from ``floor(u + 0.5) - 1``, taps beyond an edge
  mirrored into the plane.

Results are kept on each ``Reference``, per (size, mode, flats, sigma).
"""

from __future__ import annotations

import numpy as np
import scipy.fft
import torch
from scipy import special

from portbench.reference import geometry

CVAL = -9999.0  # topo.py's fill for pixels outside the rotated kernel


def valley_kernels(size: int, flat_list) -> np.ndarray:
    """(F, size, size) float64: the ramp ``|row - middle|`` with, per flat
    fraction, the middle ``2 * halfwidth + 1`` rows set to the ramp's value
    at ``middle - halfwidth``; the whole stack standardised (population
    standard deviation) after each flat is set, as topo.py does."""
    size = int(size)
    middle = int(np.floor(size / 2))
    ramp = np.broadcast_to(np.arange(0, middle + 1), (size, middle + 1)).T
    ramp = np.concatenate((np.flip(ramp[1:, :], axis=0), ramp), axis=0).astype(np.float64)
    kernels = np.broadcast_to(ramp, (len(flat_list), size, size)).copy()
    for ind, flat in enumerate(flat_list):
        halfwidth = int(np.floor(size * flat / 2) + 0.5)
        kernels[ind, middle - halfwidth:middle + halfwidth + 1, :] = kernels[ind, middle - halfwidth, 0]
        kernels = ((kernels - np.mean(kernels, axis=(1, 2), keepdims=True))
                   / np.std(kernels, axis=(1, 2), keepdims=True))
    return kernels


def _spline_matrix(n: int, like: torch.Tensor) -> torch.Tensor:
    """(n, n): the samples of an order-2 B-spline from its coefficients,
    ``(c[i-1] + 6 c[i] + c[i+1]) / 8``, coefficients mirrored about the end
    samples."""
    m = torch.zeros((n, n), dtype=like.dtype, device=like.device)
    i = torch.arange(n, device=like.device)
    m[i, i] = 0.75
    m[i[:-1], i[1:]] = m[i[1:], i[:-1]] = 0.125
    m[0, 1] = m[n - 1, n - 2] = 0.25
    return m


def spline_coefficients(stack: torch.Tensor) -> torch.Tensor:
    """The order-2 B-spline coefficients of each (h, w) plane of an
    (F, h, w) float64 stack, mirror boundary (scipy's ``spline_filter(order=2,
    mode="constant")`` of each plane), solved along y, then along x."""
    _, h, w = stack.shape
    rows = torch.linalg.solve(_spline_matrix(h, stack), stack)
    return torch.linalg.solve(_spline_matrix(w, stack), rows.transpose(1, 2)).transpose(1, 2)


def _taps(u: torch.Tensor, n: int) -> tuple:
    """The three tap indices (mirrored into ``[0, n - 1]``) and quadratic
    B-spline weights of the sample points ``u`` along an axis of ``n``."""
    middle = torch.floor(u + 0.5)
    t = u - middle
    weights = (0.5 * (0.5 - t) ** 2, 0.75 - t * t, 0.5 * (0.5 + t) ** 2)
    index = []
    for a in (-1, 0, 1):
        i = middle.to(torch.int64) + a
        i = torch.where(i < 0, -i, i)
        index.append(torch.where(i > n - 1, 2 * (n - 1) - i, i))
    return index, weights


def rotated(coefficients: torch.Tensor, angle: float) -> torch.Tensor:
    """``scipy.ndimage.rotate(stack, angle, axes=(1, 2), reshape=True,
    order=2, mode="constant", cval=-9999)`` of the (F, h, w) stack whose
    ``spline_coefficients`` these are, as an (F, ky, kx) float64 tensor on
    their device."""
    f, iy, ix = coefficients.shape
    c, s = float(special.cosdg(angle)), float(special.sindg(angle))
    rot_matrix = np.array([[c, s], [-s, c]])
    in_plane_shape = np.array([iy, ix])
    out_bounds = rot_matrix @ [[0, 0, iy, iy], [0, ix, 0, ix]]
    ky, kx = (np.ptp(out_bounds, axis=1) + 0.5).astype(int)
    offset = (in_plane_shape - 1) / 2 - rot_matrix @ ((np.array([ky, kx]) - 1) / 2)

    device = coefficients.device
    oi = torch.arange(ky, dtype=torch.float64, device=device)[:, None]
    oj = torch.arange(kx, dtype=torch.float64, device=device)[None, :]
    y = (c * oi + s * oj) + float(offset[0])
    x = (-s * oi + c * oj) + float(offset[1])
    inside = (y >= 0) & (y <= iy - 1) & (x >= 0) & (x <= ix - 1)
    y_index, y_weights = _taps(y.clamp(0, iy - 1), iy)
    x_index, x_weights = _taps(x.clamp(0, ix - 1), ix)

    planes = coefficients.reshape(f, iy * ix)
    out = torch.zeros((f, ky * kx), dtype=torch.float64, device=device)
    for yi, wy in zip(y_index, y_weights):
        for xi, wx in zip(x_index, x_weights):
            out += planes[:, (yi * ix + xi).reshape(-1)] * (wy * wx).reshape(-1)
    return torch.where(inside, out.reshape(f, ky, kx), CVAL)


def restandardised(rot: torch.Tensor) -> torch.Tensor:
    """Each flat of a rotated stack standardised over its pixels that are
    not -9999 (mean, population standard deviation), the others 0: the
    masked array of topo.py filled with 0."""
    valid = rot != CVAL
    count = valid.sum(dim=(1, 2), keepdim=True)
    mean = torch.where(valid, rot, 0.0).sum(dim=(1, 2), keepdim=True) / count
    anomaly = torch.where(valid, rot - mean, 0.0)
    std = torch.sqrt((anomaly * anomaly).sum(dim=(1, 2), keepdim=True) / count)
    return torch.where(valid, anomaly / std, 0.0)


def transform_shape(field_shape, k: int) -> tuple:
    """The 2-D FFT size of ``stack_convolution`` over an (H, W) field, for
    kernels of at most ``k`` x ``k`` px."""
    h, w = field_shape
    return (scipy.fft.next_fast_len(h + min(k, 2 * h - 1) - 1),
            scipy.fft.next_fast_len(w + min(k, 2 * w - 1) - 1))


def stack_convolution(spectrum: torch.Tensor, kernels: torch.Tensor, shape, field_shape):
    """``scipy.signal.convolve(stack, kernels, mode="same")`` of a stack of
    F equal (H, W) fields, whose ``rfft2`` over ``shape`` is ``spectrum``,
    with (F, ky, kx) ``kernels``, as (F, H, W): output flat ``f`` convolves
    the field with the sum of the kernels ``c0 + f - F + 1 .. c0 + f``
    (``c0 = (F - 1) // 2``) that exist, each sum cropped to the taps that
    reach a grid pixel."""
    (h, w), (n_flats, ky, kx) = field_shape, kernels.shape
    cy, cx = (ky - 1) // 2, (kx - 1) // 2
    y0, x0 = max(0, cy - h + 1), max(0, cx - w + 1)
    kernels = kernels[:, y0:min(ky, cy + h), x0:min(kx, cx + w)]
    c0 = (n_flats - 1) // 2
    sums = torch.stack([kernels[max(0, c0 + f - n_flats + 1):c0 + f + 1].sum(dim=0)
                        for f in range(n_flats)])
    full = torch.fft.irfft2(spectrum * torch.fft.rfft2(sums, s=shape), s=shape)
    return full[:, cy - y0:cy - y0 + h, cx - x0:cx - x0 + w]


def index(r, scale_m, mode: str, flat_list, smth_factor=None) -> dict:
    """``compute`` for the ``Reference`` ``r`` at ``scale_m`` metres,
    pre-smoothed at ``smth_factor`` times the scale's sigma (none for None
    or 0), kept on ``r``."""
    (size,) = r.pixels([scale_m])
    key = (int(size), mode, tuple(float(f) for f in flat_list),
           geometry.sigma_of(size, smth_factor))
    results = r.__dict__.setdefault("_valley_ridge", {})
    if key not in results:
        results[key] = compute(r, *key)
    return results[key]


def compute(r, size: int, mode: str, flat_list, sigma) -> dict:
    """The valley or ridge index of ``r``'s DEM at kernel ``size`` px:
    (H, W) planes ``norm``, ``direction`` (degrees) and ``lead`` (the
    maximum less the best response at any other angle), voids NaN."""
    field = r.smooth(sigma)
    field = (field - field.mean()) / field.std(correction=0)
    base = valley_kernels(size, flat_list) * {"valley": 1.0, "ridge": -1.0}[mode]
    coefficients = spline_coefficients(r._t(base))
    # one transform size for every angle: a rotated side is at most
    # (|cos| + |sin|) * size + 0.5 <= sqrt(2) * size + 0.5 pixels
    shape = transform_shape(field.shape, int(np.ceil(np.sqrt(2.0) * size)) + 1)
    spectrum = torch.fft.rfft2(r._q(field), s=shape)
    best = torch.full(field.shape, -torch.inf, dtype=torch.float64, device=r.device)
    second = torch.full_like(best, -torch.inf)
    direction = torch.zeros_like(best)
    for angle in range(180):
        kernels = r._q(restandardised(rotated(coefficients, float(angle))))
        response = stack_convolution(spectrum, kernels, shape, field.shape).amax(dim=0)
        greater = response > best
        second = torch.where(greater, best, torch.maximum(second, response))
        best = torch.where(greater, response, best)
        direction = torch.where(greater, float(angle), direction)
    return {"norm": r._out(torch.clamp(best, min=0.0)), "direction": r._out(direction),
            "lead": r._out(best - second)}
