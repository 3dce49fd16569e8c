"""Windowed convolution as partial-DFT matmuls.

Counterpart of ``topo_descriptors_tpu/ops/dft_conv.py``. A 'same'-mode
convolution of one field with a bank of kernels, written as dense DFT
matrix products, prunes two kinds of waste that literal FFTs carry: the
forward transform of a kernel multiplies only its (ky, kx) support rows
and columns, and the inverse evaluates only the output rows and columns
that are kept. The valley/ridge descriptor convolves 540 rotated kernels
per scale this way.

All DFT phases are computed on the host in float64 and stored as float32
(re, im) pairs; the complex products are spelled out over them. Every
product runs in full float32 (:func:`~.conv.full_float32`): TF32 keeps
~2^-11 of relative accuracy, enough to flip the valley direction argmax.

Cost model: :func:`prefer_dft_matmul` has the JAX package's formula with
the H100's own rates, measured by ``chip_smoke.py`` phase 9 (the mix of
the 2 km bank and the 20 km streamed kernels for the matmuls, the
streamed FFT route's convolution at the 20 km and 100 km shapes for
``torch.fft``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from topo_descriptors_tpu_torch.device import upload
from topo_descriptors_tpu_torch.ops.conv import _fft_shape, full_float32

# sustained SGEMM rate of conv_bank on the valley mix, and the FFT route's
# seconds per transformed point at 5-smooth sizes (2 per kernel); measured by
# chip_smoke.py phase 9 on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi
# name, power.limit)
_MM_MACS_PER_SEC = 20.4643e12
_FFT_SEC_PER_PT = 2.06824e-11


def _phases(rows: np.ndarray, cols: np.ndarray, n: int, sign: float,
            scale: float = 1.0, fold: np.ndarray = None):
    """cos/sin float32 matrices of ``sign * 2*pi * rows x cols / n`` with
    float64 phase math."""
    ang = (sign * 2.0 * np.pi / n) * np.outer(rows, cols)
    c, s = np.cos(ang) * scale, np.sin(ang) * scale
    if fold is not None:
        c, s = c * fold, s * fold
    return c.astype(np.float32), s.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dft_mats(
    h_in: int, w_in: int, ky: int, kx: int, oh: int, ow: int, sy: int,
    sx: int, fh: int, fw: int
) -> Tuple[np.ndarray, ...]:
    """Host partial-(r)DFT matrices for one conv signature:

    ``Cxf/Sxf (kx, nb)``  forward rDFT of kernel columns,
    ``Cyf/Syf (fh, ky)``  forward DFT of kernel rows,
    ``Cyi/Syi (oh, fh)``  partial inverse DFT over output rows,
    ``Cxi/Sxi (nb, ow)``  partial inverse rDFT (conjugate fold and the
    1/(fh*fw) normalization baked in) over output columns,
    ``Cxw/Sxw (w_in, nb)`` / ``Cyh/Syh (fh, h_in)``  field forward,

    with ``(fh, fw)`` the aliased circular lengths (see
    :class:`DftConvPlan`) and ``nb = fw//2 + 1``.
    """
    nb = fw // 2 + 1
    cxf, sxf = _phases(np.arange(kx), np.arange(nb), fw, -1.0)
    cyf, syf = _phases(np.arange(fh), np.arange(ky), fh, -1.0)
    cyi, syi = _phases(np.arange(sy, sy + oh), np.arange(fh), fh, 1.0,
                       scale=1.0 / fh)
    # real-FFT conjugate fold: bins 1..nb-2 count twice (last once iff fw even)
    fold = np.full((nb, 1), 2.0)
    fold[0] = 1.0
    if fw % 2 == 0:
        fold[-1] = 1.0
    cxi, sxi = _phases(np.arange(nb), np.arange(sx, sx + ow), fw, 1.0,
                       scale=1.0 / fw, fold=fold)
    cxw, sxw = _phases(np.arange(w_in), np.arange(nb), fw, -1.0)
    cyh, syh = _phases(np.arange(fh), np.arange(h_in), fh, -1.0)
    return (cxf, sxf, cyf, syf, cyi, syi, cxi, sxi, cxw, sxw, cyh, syh)


class DftConvPlan:
    """Shapes and device-resident DFT matrices for one conv signature.

    ``mode='same'`` reproduces ``scipy.signal.convolve(mode='same')`` with
    the ``(k-1)//2`` crop anchor; ``mode='valid'`` gives the VALID true
    convolution. Use :func:`get_plan` for the cached instance.
    """

    def __init__(self, h_in: int, w_in: int, ky: int, kx: int,
                 mode: str = "same", device="cuda"):
        if mode == "same":
            oh, ow = h_in, w_in
            sy, sx = (ky - 1) // 2, (kx - 1) // 2
        elif mode == "valid":
            oh, ow = h_in - ky + 1, w_in - kx + 1
            sy, sx = ky - 1, kx - 1
        else:
            raise ValueError(f"unknown mode {mode!r}: expected same or valid")
        self.shape = (h_in, w_in)
        self.kshape = (ky, kx)
        self.oshape = (oh, ow)
        # Aliased (shortened) transform lengths, exact: a circular conv of
        # length L aliases output row r with rows r+-L; the window [sy,
        # sy+oh) reads alias-free iff L >= h_in+ky-1-sy and L >= sy+oh.
        self.fh = max(h_in + ky - 1 - sy, sy + oh)
        self.fw = max(w_in + kx - 1 - sx, sx + ow)
        self.nb = self.fw // 2 + 1
        self.device = torch.device(device)
        mats = _dft_mats(h_in, w_in, ky, kx, oh, ow, sy, sx, self.fh, self.fw)
        self.mats = tuple(upload(m, self.device) for m in mats[:8])
        self.field_mats = tuple(upload(m, self.device) for m in mats[8:])

    def macs_per_kernel(self) -> int:
        ky, kx = self.kshape
        oh, ow = self.oshape
        return (
            ky * kx * self.nb * 2
            + self.fh * ky * self.nb * 4
            + oh * self.fh * self.nb * 4
            + oh * self.nb * ow * 2
        )


@functools.lru_cache(maxsize=8)
def _cached_plan(h_in, w_in, ky, kx, mode, device: torch.device) -> DftConvPlan:
    return DftConvPlan(h_in, w_in, ky, kx, mode, device)


def get_plan(h_in: int, w_in: int, ky: int, kx: int, mode: str = "same",
             device="cuda") -> DftConvPlan:
    """The plan for one (signature, device), cached: its matrices (tens of
    MB at 20 km scales) are uploaded once, not once per call."""
    return _cached_plan(h_in, w_in, ky, kx, mode, torch.device(device))


def field_spectrum(x: torch.Tensor, plan: DftConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) spectrum of the field at the plan's (fh, fw) padding, as
    matmuls (the aliased lengths are generally not 5-smooth)."""
    cxw, sxw, cyh, syh = plan.field_mats
    with full_float32():
        s1r = x @ cxw
        s1i = x @ sxw
        fdr = cyh @ s1r - syh @ s1i
        fdi = cyh @ s1i + syh @ s1r
    return fdr, fdi


def conv_bank(kernels: torch.Tensor, fdr: torch.Tensor, fdi: torch.Tensor,
              plan: DftConvPlan) -> torch.Tensor:
    """Convolve the planned field spectrum with a (B, ky, kx) kernel bank
    -> (B, oh, ow). True convolution: the kernels are fed unflipped."""
    return conv_bank_mats(kernels, fdr, fdi, *plan.mats)


def conv_bank_mats(kernels, fdr, fdi, cxf, sxf, cyf, syf, cyi, syi, cxi, sxi) -> torch.Tensor:
    """:func:`conv_bank` with the plan's matrices passed one by one."""
    with full_float32():
        s1r, s1i = kernels @ cxf, kernels @ sxf  # (B, ky, nb)
        fkr = cyf @ s1r - syf @ s1i  # (B, fh, nb)
        fki = cyf @ s1i + syf @ s1r
        pr = fkr * fdr - fki * fdi
        pi = fkr * fdi + fki * fdr
        s2r = cyi @ pr - syi @ pi  # (B, oh, nb)
        s2i = cyi @ pi + syi @ pr
        return s2r @ cxi - s2i @ sxi  # (B, oh, ow)


def route_seconds(h_in: int, w_in: int, ky: int, kx: int, *,
                  mm_macs_per_sec: float = _MM_MACS_PER_SEC,
                  fft_sec_per_pt: float = _FFT_SEC_PER_PT) -> Tuple[float, float]:
    """``(t_mm, t_fft)``: seconds per kernel of a 'same' convolution of an
    (h_in, w_in) field by the JAX package's cost model. The matmul side
    charges its MACs at the aliased lengths at ``mm_macs_per_sec``, the FFT
    side ~2 full-size transforms on the 5-smooth padded shape at
    ``fft_sec_per_pt``. The defaults are the card's rates."""
    sy, sx = (ky - 1) // 2, (kx - 1) // 2
    ph = float(max(h_in + ky - 1 - sy, sy + h_in))  # aliased lengths
    pw = float(max(w_in + kx - 1 - sx, sx + w_in))
    nb = pw // 2 + 1
    macs = ky * kx * nb * 2 + ph * ky * nb * 4 + h_in * ph * nb * 4 \
        + h_in * nb * w_in * 2
    fh, fw = _fft_shape(h_in + ky - 1), _fft_shape(w_in + kx - 1)
    return macs / mm_macs_per_sec, 2 * fh * fw * fft_sec_per_pt


def prefer_dft_matmul(h_in: int, w_in: int, ky: int, kx: int, *,
                      mm_macs_per_sec: float = _MM_MACS_PER_SEC,
                      fft_sec_per_pt: float = _FFT_SEC_PER_PT) -> bool:
    """Route between the matmul-DFT and the FFT conv: the matmul side when
    :func:`route_seconds` gives it no more time than the FFT side."""
    t_mm, t_fft = route_seconds(h_in, w_in, ky, kx, mm_macs_per_sec=mm_macs_per_sec,
                                fft_sec_per_pt=fft_sec_per_pt)
    return t_mm <= t_fft
