"""Order-2 spline rotation of the valley/ridge kernels, on the device.

Counterpart of ``topo_descriptors_tpu/ops/spline_rotate.py``. The reference
rotates the valley/ridge kernel stack with ``scipy.ndimage.rotate(order=2,
reshape=True, mode='constant', cval=-9999)`` for each of 180 angles. At
20-100 km scales the rotated bank is GB-sized, so the streamed valley/ridge
route prefilters the *base* kernels once and rotates each angle here, as a
gather and interpolation on tensors.

scipy parity rules (as in the JAX module):

* **prefilter** — order-2 spline filter, single pole ``z = sqrt(8) - 3``,
  gain ``(1-z)(1-1/z)``, MIRROR boundary (what scipy's
  ``spline_filter(mode='constant')`` resolves to). ``|z| ~ 0.17``, so the
  causal and anticausal recursions truncate to ``K``-tap FIRs with error
  ``|z|^K < 2e-11`` at K=14, below float32 eps.
* **interpolation** — quadratic B-spline: footprint start
  ``floor(x + 0.5) - 1``, fraction ``t = x - start - 1``, weights
  ``(0.5 (0.5-t)^2, 0.75 - t^2, 0.5 (0.5+t)^2)``; footprint indices
  MIRROR-extended; the output is ``cval`` exactly where the *point*
  coordinate leaves ``[0, n-1]`` on either axis.
* **reshape/anchor** — output shape ``int((|cos|+|sin|) * size + 0.5)`` per
  axis and scipy's centre-to-centre offset; the result is written into the
  common (ky_max, kx_max) canvas at the 'same' anchor that
  :func:`~topo_descriptors_tpu_torch.ops.valley_ridge.prepare_valley_bank`
  uses.

Per-angle parameters are host float64 rows (:func:`rotation_params64`,
scipy's own coordinates), for the bank route's 180 angles rotated at once
and for the streamed route's quadrant angles alike. :func:`rotation_params`
keeps the JAX package's float32 row, which the rotation no longer reads.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from topo_descriptors_tpu_torch.device import upload

_POLE = float(np.sqrt(8.0) - 3.0)
_GAIN = float((1.0 - _POLE) * (1.0 - 1.0 / _POLE))
_K_TAPS = 14  # |pole|^14 ~ 2e-11, below f32 eps


def exact_deg_trig(angle: float) -> Tuple[float, float]:
    """(cos, sin) of an angle in degrees, exact at multiples of 90 (as
    scipy.special.cosdg/sindg, which decide rotated shapes and anchors)."""
    a = float(angle) % 360.0
    exact = {0.0: (1.0, 0.0), 90.0: (0.0, 1.0),
             180.0: (-1.0, 0.0), 270.0: (0.0, -1.0)}
    if a in exact:
        return exact[a]
    r = np.deg2rad(a)
    return float(np.cos(r)), float(np.sin(r))


def mirror_pad_1d(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Mirror padding about the edge *sample* (d c b | a b c d | c b a)
    along one axis: the spline filter's boundary, unlike the symmetric
    :func:`~topo_descriptors_tpu_torch.ops.conv.reflect_pad_1d`. Pad
    widths must be below the axis length."""
    n = x.shape[axis]
    if lo >= n or hi >= n:
        raise ValueError(f"mirror pad ({lo}, {hi}) >= axis length {n}")
    parts = []
    if lo:
        parts.append(torch.flip(x.narrow(axis, 1, lo), (axis,)))
    parts.append(x)
    if hi:
        parts.append(torch.flip(x.narrow(axis, n - 1 - hi, hi), (axis,)))
    return torch.cat(parts, dim=axis) if len(parts) > 1 else x


def _fir_valid(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """VALID 1-D correlation with host taps as shifted multiply-adds."""
    n_out = x.shape[axis] - len(taps) + 1
    acc = None
    for i, tap in enumerate(taps):
        term = x.narrow(axis, i, n_out) * float(tap)
        acc = term if acc is None else acc + term
    return acc


def _prefilter1d_o2(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Order-2 spline prefilter along one axis (mirror boundary), as two
    K-tap FIR passes over the mirror-extended line."""
    # clamp the FIR truncation to the mirror period for tiny inputs
    k = min(_K_TAPS, x.shape[axis] - 1)
    xp = mirror_pad_1d(x * _GAIN, axis, k, k)
    # causal c[i] = sum_k z^k a[i-k]: valid-correlate with taps z^(K-t)
    causal_taps = np.array([_POLE ** (k - t) for t in range(k + 1)], np.float32)
    causal = _fir_valid(xp, causal_taps, axis)
    # anticausal with the k-sample lookahead: out[i] = sum_k -z^(k+1) c[i+k]
    anti_taps = np.array([-(_POLE ** (t + 1)) for t in range(k + 1)], np.float32)
    return _fir_valid(causal, anti_taps, axis)


def prefilter2d_o2(x: torch.Tensor) -> torch.Tensor:
    """Order-2 spline prefilter over the last two axes (scipy
    ``spline_filter(order=2, mode='constant')`` parity in float32)."""
    x = _prefilter1d_o2(x, x.dim() - 2)
    return _prefilter1d_o2(x, x.dim() - 1)


def rotation_params(size: int, angle: float, ky_max: int, kx_max: int) -> np.ndarray:
    """Per-angle scalars -> float32[8]: cos, sin, offset_y, offset_x
    (scipy rotate's centre-to-centre offset), lo_y, lo_x (the 'same'-anchor
    placement inside the canvas), ky, kx (the true rotated extent)."""
    c, s = exact_deg_trig(angle)
    iy = ix = float(size)
    corners_y = np.array([0.0, 0.0, iy, iy])
    corners_x = np.array([0.0, ix, 0.0, ix])
    by = c * corners_y + s * corners_x
    bx = -s * corners_y + c * corners_x
    ky = int(np.ptp(by) + 0.5)
    kx = int(np.ptp(bx) + 0.5)
    out_c = np.array([(ky - 1) / 2.0, (kx - 1) / 2.0])
    off_y = (size - 1) / 2.0 - (c * out_c[0] + s * out_c[1])
    off_x = (size - 1) / 2.0 - (-s * out_c[0] + c * out_c[1])
    lo_y = (ky_max - 1) // 2 - (ky - 1) // 2
    lo_x = (kx_max - 1) // 2 - (kx - 1) // 2
    return np.array([c, s, off_y, off_x, lo_y, lo_x, ky, kx], np.float32)


def _mirror_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Single mirror reflection of footprint indices into [0, n-1]."""
    idx = torch.where(idx < 0, -idx, idx)
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def rotation_params64(size: int, angles, ky_max: int, kx_max: int) -> np.ndarray:
    """:func:`rotation_params` of many angles as float64[A, 8] rows, in
    ``scipy.ndimage.rotate``'s own arithmetic: cos and sin from
    ``scipy.special.cosdg``/``sindg``, the shape from ``ptp + 0.5`` of the
    rotated corners, the offset ``in_center - R @ out_center``. At odd
    sizes from 153 px up, float32 coordinates move support pixels across
    scipy's ``0 <= coord <= n-1`` test; these rows keep them where scipy
    puts them."""
    from scipy.special import cosdg, sindg  # host-side only

    in_shape = np.array([size, size])
    rows = []
    for angle in angles:
        c, s = float(cosdg(angle)), float(sindg(angle))
        rot = np.array([[c, s], [-s, c]])
        ky, kx = (np.ptp(rot @ [[0, 0, size, size], [0, size, 0, size]], axis=1) + 0.5).astype(int)
        off_y, off_x = (in_shape - 1) / 2 - rot @ ((np.array([ky, kx]) - 1) / 2)
        lo_y = (ky_max - 1) // 2 - (ky - 1) // 2
        lo_x = (kx_max - 1) // 2 - (kx - 1) // 2
        rows.append([c, s, off_y, off_x, lo_y, lo_x, ky, kx])
    return np.asarray(rows, np.float64)


def _footprints(n: int, params: np.ndarray, canvas_shape, device):
    """(inside, ystart, xstart, wy, wx) over the canvas: the support mask,
    the clamped footprint starts in [-1, n-2] and the three quadratic
    B-spline weights per axis. ``params`` is a float64 (A, 8) block of
    :func:`rotation_params64` rows: coordinates in float64, (A, KY, KX)
    each, weights (3, A, KY, KX), the spline fractions cast to float32
    once formed. float32 coordinates put support pixels of odd sizes from
    153 px up on the other side of scipy's ``0 <= coord <= n-1`` test."""
    if params.dtype != np.float64 or params.ndim != 2:
        raise ValueError(f"expected float64 (A, 8) rows of rotation_params64, got "
                         f"{params.dtype} {params.shape}")
    ky_max, kx_max = canvas_shape
    cols = upload(params, device)[:, :, None, None].unbind(1)
    c, s, off_y, off_x, lo_y, lo_x, ky, kx = cols
    oi = torch.arange(ky_max, dtype=torch.float64, device=device)[:, None] - lo_y
    oj = torch.arange(kx_max, dtype=torch.float64, device=device)[None, :] - lo_x
    ycoord = c * oi + s * oj + off_y
    xcoord = -s * oi + c * oj + off_x

    nm1 = float(n - 1)
    inside = (
        (oi >= 0) & (oi < ky) & (oj >= 0) & (oj < kx)
        & (ycoord >= 0) & (ycoord <= nm1) & (xcoord >= 0) & (xcoord <= nm1)
    )
    ystart = torch.floor(ycoord + 0.5).to(torch.int64) - 1
    xstart = torch.floor(xcoord + 0.5).to(torch.int64) - 1
    ty = (ycoord - (ystart.to(ycoord.dtype) + 1.0)).to(torch.float32)
    tx = (xcoord - (xstart.to(xcoord.dtype) + 1.0)).to(torch.float32)
    wy = torch.stack([0.5 * (0.5 - ty) ** 2, 0.75 - ty * ty, 0.5 * (0.5 + ty) ** 2])
    wx = torch.stack([0.5 * (0.5 - tx) ** 2, 0.75 - tx * tx, 0.5 * (0.5 + tx) ** 2])
    # clamp the starts of masked-out pixels so the indices stay in range
    return inside, ystart.clamp(-1, n - 2), xstart.clamp(-1, n - 2), wy, wx


def _restandardize(val: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """Masked re-standardization over the rotated support, zero outside
    (the reference's numpy.ma recipe in plain arithmetic); ``val`` is
    (..., F, KY, KX), ``inside`` (..., KY, KX)."""
    m = inside.unsqueeze(-3)
    cnt = m.sum(dim=(-2, -1), keepdim=True).to(val.dtype)
    mean = torch.where(m, val, 0.0).sum(dim=(-2, -1), keepdim=True) / cnt
    anom = torch.where(m, val - mean, 0.0)
    var = (anom * anom).sum(dim=(-2, -1), keepdim=True) / cnt
    return anom * torch.rsqrt(var)


def rotate_std_canvas(
    filtered: torch.Tensor, params: np.ndarray, canvas_shape: Tuple[int, int]
) -> torch.Tensor:
    """Rotate a prefiltered (F, n, n) stack by A angles (``params``, float64
    rows of :func:`rotation_params64`) into the common anchored canvas,
    masked-re-standardized, as an (A, F, KY, KX) stack. Pixels outside the
    rotated support, and the canvas beyond the angle's true extent, are
    exactly 0."""
    n_flats, n, _ = filtered.shape
    inside, ystart, xstart, wy, wx = _footprints(n, params, canvas_shape, filtered.device)
    flat = filtered.reshape(n_flats, n * n)
    val = None
    for a in range(3):
        yi = _mirror_idx(ystart + a, n)
        for b in range(3):
            xi = _mirror_idx(xstart + b, n)
            term = (wy[a] * wx[b]).unsqueeze(-3) * flat[:, yi * n + xi].movedim(0, -3)
            val = term if val is None else val + term
    return _restandardize(val, inside)


def build_rotation_table(filtered: torch.Tensor) -> torch.Tensor:
    """Pack the prefiltered (F, n, n) stack into a gather table of shape
    ``((n+2)^2, F*9)``: row ``i`` holds the 3x3 interpolation footprint of
    every flat at one (ystart, xstart) base position of the grid
    mirror-padded by 1, so one row gather serves a whole canvas pixel and
    the footprint needs no per-tap index reflection."""
    n_flats, n, _ = filtered.shape
    fp = mirror_pad_1d(mirror_pad_1d(filtered, 1, 1, 1), 2, 1, 1)
    m = n + 2
    flat = fp.reshape(n_flats, m * m)
    # value at base+offset, aligned to the base index
    taps = [torch.roll(flat, -(a * m + b), 1) for a in range(3) for b in range(3)]
    table = torch.stack(taps)  # (9, F, m^2)
    return table.permute(2, 1, 0).reshape(m * m, n_flats * 9).contiguous()


def rotate_std_canvas_table(
    table: torch.Tensor, n: int, params: np.ndarray, canvas_shape: Tuple[int, int]
) -> torch.Tensor:
    """:func:`rotate_std_canvas` on the packed gather table: the same
    footprint indices, weights and re-standardization; the taps are summed
    in another order; it too returns an (A, F, KY, KX) stack."""
    m = n + 2
    n_flats = table.shape[1] // 9
    inside, ystart, xstart, wy, wx = _footprints(n, params, canvas_shape, table.device)
    # base index into the mirror-padded (m, m) grid: +1 per axis
    idx = ((ystart + 1) * m + (xstart + 1)).reshape(-1)
    g = table[idx].reshape(*inside.shape, n_flats, 3, 3)
    w = torch.movedim(wy[:, None] * wx[None, :], (0, 1), (-2, -1))  # (..., KY, KX, 3, 3)
    val = torch.movedim((g * w[..., None, :, :]).sum(dim=(-2, -1)), -1, -3)
    return _restandardize(val, inside)


def _flip_roll(c: torch.Tensor, axis: int, delta: int) -> torch.Tensor:
    return torch.roll(torch.flip(c, (axis,)), delta, axis)


def canvas_variants(canvas: torch.Tensor, params: np.ndarray):
    """The four quadrant variants of one rotated-standardized canvas:
    ``(R(t), R(90+t), R(180-t), R(90-t))``.

    The base kernels are invariant under both axis flips, which makes
    ``R(90+t) = rot90(R(t))``, ``R(180-t) = flip(R(t))`` and ``R(90-t) =
    flip(rot90(R(t)))`` exact lattice transforms. Flips are about the
    *canvas* centre; when the angle's true extent and the canvas differ in
    parity, the flip is followed by a 1-pixel roll. Square canvases only.
    """
    kmax = canvas.shape[-1]
    ky = int(params[6])
    delta = (ky - 1) % 2 - (kmax - 1) % 2
    v90p = _flip_roll(canvas.transpose(-1, -2), -2, delta)
    v180m = _flip_roll(canvas, -2, delta)
    v90m = _flip_roll(v90p, -2, delta)
    return canvas, v90p, v180m, v90m


def quadrant_schedule(n_angles: int = 180):
    """Integer angles 0..n_angles-1 (degrees) as quadrant rotations plus
    variant transforms -> ``(q_angles, slot_angle, slot_valid)``:
    ``q_angles`` the sorted base angles in [0, 45]; ``slot_angle[i, v]``
    the angle that variant ``v`` (:func:`canvas_variants` order) of base
    ``q_angles[i]`` covers, and ``slot_valid[i, v]`` whether that slot is
    a real, non-duplicate member of the angle set. 180 angles need 46
    rotations. Defined on the reference's domain 0..179 only."""
    if not 1 <= n_angles <= 180:
        raise ValueError(
            f"n_angles must be in [1, 180] (reference domain 0..179 deg); got {n_angles}"
        )
    variant_of = {}
    for a in range(n_angles):
        if a <= 45:
            q, v = a, 0
        elif a <= 90:
            q, v = 90 - a, 3
        elif a <= 135:
            q, v = a - 90, 1
        else:
            q, v = 180 - a, 2
        slots = variant_of.setdefault(q, {})
        if v not in slots:  # a=45/90/135 are reachable twice; keep first
            slots[v] = a
    q_angles = sorted(variant_of)
    slot_angle = np.zeros((len(q_angles), 4), np.float32)
    slot_valid = np.zeros((len(q_angles), 4), bool)
    for i, q in enumerate(q_angles):
        for v, a in variant_of[q].items():
            slot_angle[i, v] = a
            slot_valid[i, v] = True
    return np.asarray(q_angles, np.float32), slot_angle, slot_valid
