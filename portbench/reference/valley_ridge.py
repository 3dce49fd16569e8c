"""Plain reference of the valley and ridge indices.

Written from MeteoSwiss/topo-descriptors' ``valley_ridge`` and its kernels
(topo.py:389-531), in float64 PyTorch on a ``Reference``'s device, with
no bank, fold, cache or rotation of the measured program:

* the field (``Reference.smooth``, the filled DEM pre-smoothed at
  ``sigma``) standardised by its global mean and population standard
  deviation;
* one V (valley) or, negated, Λ (ridge) kernel per flat fraction, each
  standardised (topo.py:466-518);
* for each integer angle 0..179, the stack rotated by
  ``scipy.ndimage.rotate(order=2, reshape=True, mode="constant",
  cval=-9999)`` on the host, the -9999 pixels masked out of a
  re-standardisation and filled with 0 (topo.py:521-531); the angle is
  given as a float64 (topo.py's float32 angles make scipy round the
  rotation's sine and cosine to float32, a rounding like any other of
  its float32 arithmetic);
* the 3-D ``signal.convolve(field stack, kernels, mode="same")`` over
  (flat, y, x), through float64 FFTs of the full linear convolution
  cropped as scipy crops 'same';
* the maximum over the flats, and the strictly greater running maximum
  and its angle over 0..179 (ties keep the earlier angle).

``NORM`` is that maximum clipped at 0, ``DIR`` its angle; voids are NaN in
both. Beside them ``lead``: the maximum less the largest response at any
other angle, the margin by which the direction wins, which weighs the
direction's gap (``outputs``): a program can pick another angle only where
its error exceeds the lead. Under ``precision="tf32"`` the standardised
field and each rotated kernel are rounded to TF32 before the product
(``Reference._q``) and the planes stored as float32.

Results are kept on each ``Reference``, per (size, mode, flats, sigma).
"""

from __future__ import annotations

import numpy as np
import scipy.fft
import torch
from scipy import ndimage

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
    n_flats, (h, w) = len(flat_list), field.shape
    base = valley_kernels(size, flat_list) * {"valley": 1.0, "ridge": -1.0}[mode]
    # one transform size for every angle: a rotated side is at most
    # (|cos| + |sin|) * size + 0.5 <= sqrt(2) * size + 0.5 pixels
    k = int(np.ceil(np.sqrt(2.0) * size)) + 1
    shape = (2 * n_flats - 1, scipy.fft.next_fast_len(h + k - 1), scipy.fft.next_fast_len(w + k - 1))
    stack = r._q(field).expand(n_flats, h, w)
    spectrum = torch.fft.rfftn(stack, s=shape)
    best = torch.full((h, w), -torch.inf, dtype=torch.float64, device=r.device)
    second = torch.full_like(best, -torch.inf)
    direction = torch.zeros_like(best)
    c0 = (n_flats - 1) // 2
    for angle in range(180):
        rot = ndimage.rotate(base, float(angle), axes=(1, 2), reshape=True, order=2,
                             mode="constant", cval=CVAL)
        kernels = r._q(restandardised(r._t(rot)))
        ky, kx = kernels.shape[1:]
        full = torch.fft.irfftn(spectrum * torch.fft.rfftn(kernels, s=shape), s=shape)
        cy, cx = (ky - 1) // 2, (kx - 1) // 2
        response = full[c0:c0 + n_flats, cy:cy + h, cx:cx + w].amax(dim=0)
        greater = response > best
        second = torch.where(greater, best, torch.maximum(second, response))
        best = torch.where(greater, response, best)
        direction = torch.where(greater, float(angle), direction)
    return {"norm": r._out(torch.clamp(best, min=0.0)), "direction": r._out(direction),
            "lead": r._out(best - second)}
