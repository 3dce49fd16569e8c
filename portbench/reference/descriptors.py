"""Plain reference of the descriptors the benchmark's cells ask for.

Written from MeteoSwiss/topo-descriptors' semantics (topo.py, helpers.py,
scipy.ndimage / scipy.signal), in float64 PyTorch on any device, with no
kernel, cache or table of the measured program: it starts from the raw DEM
(voids as NaN) and the grid's coordinates, fills the voids itself and
builds every disk, Gaussian and ray table again (``geometry``).

``precision="tf32"`` is the benchmark's control: the same arithmetic with
every operand of every product of a convolution, matrix product or Sx ratio
rounded to TF32's 10-bit mantissa (products and sums are still carried in
float64, the kindest form of TF32), and each plane stored as float32.
"""

from __future__ import annotations

import numpy as np
import scipy.fft
import torch

from portbench.reference import geometry

PRECISIONS = ("float64", "tf32")


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest TF32 value (10 mantissa bits, ties to
    even), as the tensor cores read float32 operands in TF32 mode."""
    bits = t.to(torch.float32).view(torch.int32)
    keep = (bits >> 13) & 1
    bits = (bits + 0x0FFF + keep) & ~0x1FFF
    return bits.view(torch.float32).to(t.dtype)


def fill_na(dem: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Each void takes the value of its nearest valid pixel along x, as
    xarray's ``interpolate_na(dim='x', method='nearest')`` gets it from
    scipy's ``interp1d``: the valid pixel whose cell between the midpoints
    ``x[i] / 2 + x[i + 1] / 2`` holds the void's coordinate, one on a
    midpoint taking the lower; rows' ends extrapolate. Rows with no valid
    pixel stay NaN."""
    out = np.array(dem, np.float64)
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="stable")
    for j in np.unique(np.nonzero(np.isnan(out))[0]):
        row = out[j]
        good = order[~np.isnan(row[order])]
        if not len(good):
            continue
        gx = x[good]
        holes = np.nonzero(np.isnan(row))[0]
        row[holes] = row[good[np.searchsorted(gx[1:] / 2 + gx[:-1] / 2, x[holes], side="left")]]
    return out


class Reference:
    """The descriptors of one raw DEM, plane by plane.

    ``dem`` is the (H, W) float32 array with voids as NaN, ``x`` and ``y``
    the grid's coordinate vectors in the CRS ``crs`` (metres, or lat/lon
    degrees for 'epsg:4326'). Every plane comes back as a float64
    tensor (float32 values under ``"tf32"``) on ``device``, with the voids
    NaN again except in Sx."""

    def __init__(self, dem: np.ndarray, x, y, crs: str, device="cpu",
                 precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.device = torch.device(device)
        self.tf32 = precision == "tf32"
        self.x, self.y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        self.res = geometry.resolution(self.x, self.y, crs)
        self.voids = torch.from_numpy(np.isnan(dem)).to(self.device)
        self.z = self._t(fill_na(dem, self.x))
        self._smooth = {}

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return tf32_round(t) if self.tf32 else t

    def _out(self, t: torch.Tensor, voids: bool = True) -> torch.Tensor:
        if self.tf32:
            t = t.to(torch.float32).to(torch.float64)
        return torch.where(self.voids, torch.nan, t) if voids else t

    def pixels(self, scales_m) -> np.ndarray:
        return geometry.pixels_of(scales_m, *self.res)

    # --- building blocks ------------------------------------------------------

    def smooth(self, sigma) -> torch.Tensor:
        """``scipy.ndimage.gaussian_filter(z, sigma)`` (reflect boundary) as
        two matrix products; the filled DEM itself for no sigma."""
        if not sigma:
            return self.z
        if sigma not in self._smooth:
            h, w = self.z.shape
            my = self._q(self._t(geometry.smoothing_matrix(h, sigma)))
            mx = self._q(self._t(geometry.smoothing_matrix(w, sigma)))
            rows = my @ self._q(self.z)
            self._smooth[sigma] = self._q(rows) @ mx.T
        return self._smooth[sigma]

    def conv_same(self, fields: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
        """``scipy.signal.convolve(f, kernel, mode='same')`` (zero boundary)
        of each (H, W) field of a (B, H, W) stack, through float64 FFTs of
        the full linear convolution."""
        _, h, w = fields.shape
        kh, kw = kernel.shape
        fh, fw = scipy.fft.next_fast_len(h + kh - 1), scipy.fft.next_fast_len(w + kw - 1)
        spec = torch.fft.rfft2(self._q(fields), s=(fh, fw))
        spec *= torch.fft.rfft2(self._t(kernel), s=(fh, fw))
        full = torch.fft.irfft2(spec, s=(fh, fw))
        cy, cx = (kh - 1) // 2, (kw - 1) // 2
        return full[:, cy:cy + h, cx:cx + w]

    def _counts(self, kernel: np.ndarray) -> torch.Tensor:
        """How many taps of ``kernel`` fall inside the grid, per pixel."""
        ones = torch.ones((1, *self.z.shape), dtype=torch.float64, device=self.device)
        h, w = self.z.shape
        kh, kw = kernel.shape
        fh, fw = scipy.fft.next_fast_len(h + kh - 1), scipy.fft.next_fast_len(w + kw - 1)
        spec = torch.fft.rfft2(ones, s=(fh, fw)) * torch.fft.rfft2(self._t(kernel), s=(fh, fw))
        full = torch.fft.irfft2(spec, s=(fh, fw))
        cy, cx = (kh - 1) // 2, (kw - 1) // 2
        return torch.round(full[0, cy:cy + h, cx:cx + w])

    # --- descriptors ------------------------------------------------------------

    def dem(self, scale_m) -> torch.Tensor:
        """DEM_<scale>M: the filled DEM smoothed at sigma = pixels / 4."""
        (px,) = self.pixels([scale_m])
        return self._out(self.smooth(geometry.sigma_of(px)))

    def tpi(self, scale_m, smth_factor=None) -> torch.Tensor:
        """TPI_<scale>M[_SMTHFACT..]: the (pre-smoothed) field minus the
        zero-padded sum over the disk without its middle tap, divided by
        that disk's tap count."""
        (px,) = self.pixels([scale_m])
        field = self.smooth(geometry.sigma_of(px, smth_factor))
        k = geometry.disk(px, exclude_center=True)
        c = field.mean()
        total = self.conv_same((field - c)[None], k)[0] + c * self._counts(k)
        return self._out(field - total / k.sum())

    def std(self, scale_m, smth_factor=None) -> torch.Tensor:
        """STD_<scale>M[_SMTHFACT..]: ``sqrt(max(0, (conv(t^2) - conv(z)^2 /
        n) / (n - 1)))`` over the disk of n taps, zero-padded, with ``t``
        the field truncated toward zero (the reference's int32 cast)."""
        (px,) = self.pixels([scale_m])
        field = self.smooth(geometry.sigma_of(px, smth_factor))
        k = geometry.disk(px)
        n = k.sum()
        c = field.mean()
        zc, tc = field - c, torch.trunc(field) - c
        z1, t1, t2 = self.conv_same(torch.stack([zc, tc, tc * tc]), k)
        counts = self._counts(k)
        sum_z = z1 + c * counts
        sum_sq = t2 + 2 * c * t1 + c * c * counts
        var = (sum_sq - sum_z * sum_z / n) / (n - 1)
        return self._out(torch.sqrt(torch.clamp(var, min=0.0)))

    def gradient(self, scale_m, sig_ratio=1.0) -> list:
        """[WE_DERIVATIVE, SN_DERIVATIVE, SLOPE, ASPECT] at one scale with
        ``sig_ratio`` 1: a 3x3 Sobel (true convolution, reflect) where
        sigma <= 1, else ``np.gradient`` of the smoothed field; each over the
        signed metric resolution of its pixel; slope ``atan(|grad|)`` and aspect
        ``(180 + atan2(dx, dy)) mod 360``, in degrees."""
        if sig_ratio != 1:
            raise ValueError("the reference covers sig_ratio 1 only")
        (px,) = self.pixels([scale_m])
        sigma = geometry.sigma_of(px)
        if sigma <= 1:
            dx, dy = self._sobel(geometry.SOBEL_X), self._sobel(geometry.SOBEL_X.T)
        else:
            s = self.smooth(sigma)
            dy, dx = self._np_gradient(s, 0), self._np_gradient(s, 1)
        rx, ry = (self._t(r) for r in self.res)  # 2-D on a geographic grid
        dx = dx / (rx if rx.dim() == 2 else rx[None, :])
        dy = dy / (ry if ry.dim() == 2 else ry[:, None])
        slope = torch.rad2deg(torch.atan(torch.sqrt(dx * dx + dy * dy)))
        aspect = torch.remainder(180.0 + torch.rad2deg(torch.atan2(dx, dy)), 360.0)
        return [self._out(a) for a in (dx, dy, slope, aspect)]

    def _sobel(self, k: np.ndarray) -> torch.Tensor:
        h, w = self.z.shape
        rows = torch.as_tensor(geometry.reflect_index(np.arange(-1, h + 1), h), device=self.device)
        cols = torch.as_tensor(geometry.reflect_index(np.arange(-1, w + 1), w), device=self.device)
        zp = self._q(self.z)[rows][:, cols]
        out = torch.zeros_like(self.z)
        for a in range(3):
            for b in range(3):
                if k[a, b]:
                    out += float(k[a, b]) * zp[2 - a:2 - a + h, 2 - b:2 - b + w]
        return out

    @staticmethod
    def _np_gradient(f: torch.Tensor, axis: int) -> torch.Tensor:
        n = f.shape[axis]
        inner = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) / 2
        first = f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)
        last = f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)
        return torch.cat([first, inner, last], dim=axis)

    def sx(self, azimuth, radius, height=10.0) -> torch.Tensor:
        """SX_RADIUS<r>_AZIMUTH<a>: per pixel, ``atan`` in degrees of the
        largest ``(z[p + o] - z[p] - height) / d`` over the call's ray pixels
        (NaN ratios ignored; NaN where none is left), 0 on the border the
        window leaves."""
        rx, ry = self.res
        offsets, distances, b = geometry.sx_rays(azimuth, radius, float(rx.mean()),
                                                 float(ry.mean()))
        h, w = self.z.shape
        out = torch.zeros_like(self.z)
        if h <= 2 * b or w <= 2 * b:
            return self._out(out, voids=False)
        offsets, first = np.unique(offsets, axis=0, return_index=True)
        distances = distances[first]
        base = self.z[b:h - b, b:w - b] + height
        best = torch.full_like(base, -torch.inf)
        for (oy, ox), d in zip(offsets, distances):
            diff = self.z[b + oy:h - b + oy, b + ox:w - b + ox] - base
            if self.tf32:  # a product with the reciprocal distance, as a kernel would form it
                with np.errstate(divide="ignore"):
                    ratio = self._q(diff) * self._q(self._t(1.0 / d))
            else:
                ratio = diff / float(d)
            best = torch.fmax(best, ratio)
        deg = torch.rad2deg(torch.atan(best))
        out[b:h - b, b:w - b] = torch.where(torch.isneginf(best), torch.nan, deg)
        return self._out(out, voids=False)
