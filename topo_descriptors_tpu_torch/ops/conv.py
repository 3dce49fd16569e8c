"""Stencil/convolution engine on PyTorch (the main-path subset).

Counterpart of ``topo_descriptors_tpu/ops/conv.py`` with the same parity
targets: ``scipy.signal.convolve(mode='same')`` for :func:`conv2d_same` and
``scipy.ndimage.gaussian_filter`` (truncate=4.0, 'reflect') for
:func:`gaussian_filter`. {0,1}-valued kernels (disks) go through the
prefix-sum convolution of :mod:`.cuda.disk_sat` — the hand-written CUDA
kernel for CUDA tensors, its plain twin for CPU tensors. The routing
thresholds are the shared ``CFG`` values.

Functions take and return float32 tensors and keep them on their device.
"""

from __future__ import annotations

import contextlib
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from topo_descriptors_tpu.config import CFG
from topo_descriptors_tpu.kernels.gaussian import gaussian_kernel1d
from topo_descriptors_tpu_torch.device import upload
from topo_descriptors_tpu_torch.ops.cuda import disk_sat


def _fft_shape(n: int) -> int:
    """Next 5-smooth length >= n (scipy.fft.next_fast_len equivalent)."""
    if n <= 6:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()  # pow2 upper bound
    p5 = 1
    while p5 <= best:
        p35 = p5
        while p35 <= best:
            m = p35
            while m < n:
                m *= 2
            best = min(best, m)
            p35 *= 3
        p5 *= 5
    return best


def _same_pads(k: int) -> Tuple[int, int]:
    """(lo, hi) zero-padding for scipy 'same' anchoring: crop starts at
    s=(k-1)//2 of the full convolution, i.e. pad lo = k-1-s, hi = s."""
    s = (k - 1) // 2
    return k - 1 - s, s


def _binary_kernel_runs(kernel: np.ndarray):
    """Decompose a {0,1}-valued kernel into per-row runs of ones.

    Returns ``[(row, first_col, last_col), ...]`` (inclusive bounds) or None
    if the kernel has non-binary weights.
    """
    k = np.asarray(kernel)
    if not np.isin(k, (0.0, 1.0)).all():
        return None
    edges = np.diff(np.pad(k != 0, ((0, 0), (1, 1))).astype(np.int8), axis=1)
    rows, first = np.nonzero(edges == 1)  # row-major: runs in row order
    _, end = np.nonzero(edges == -1)
    return [(int(r), int(s), int(e - 1)) for r, s, e in zip(rows, first, end)]


def _sat_runs(kernel: np.ndarray, method: str):
    """The flipped kernel's runs when the prefix-sum path applies, else None."""
    if method not in ("auto", "sat"):
        return None
    runs = _binary_kernel_runs(kernel[::-1, ::-1])
    if method == "sat" and runs is None:
        raise ValueError("method='sat' requires a {0,1}-valued kernel")
    if runs is not None and (method == "sat" or kernel.size >= CFG.sat_conv_min_taps):
        return runs
    return None


def conv2d_same(x: torch.Tensor, kernel: np.ndarray, method: str = "auto") -> torch.Tensor:
    """2-D convolution, ``mode='same'`` with zero boundary.

    Parity target: ``scipy.signal.convolve(x, kernel, mode='same')``. Methods:
    ``'sat'`` (prefix sums, {0,1} kernels), ``'direct'``, ``'fft'``, or
    ``'auto'``, which picks among them by the kernel's values and size.
    """
    return conv2d_same_multi(x[None], kernel, method)[0]


def conv2d_same_multi(xs: torch.Tensor, kernel: np.ndarray, method: str = "auto") -> torch.Tensor:
    """Convolve a stack of 2-D fields (B, H, W) with one kernel -> (B, H, W)."""
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    pads = (_same_pads(kh), _same_pads(kw))
    runs = _sat_runs(kernel, method)
    if runs is not None:  # the JAX package's _conv2d_sat
        return disk_sat.disk_conv_sat(xs, kernel.shape, runs, pads)
    if method in ("auto", "sat"):
        method = "fft" if kernel.size >= CFG.fft_conv_min_taps else "direct"
    if method == "fft":
        return _conv2d_same_fft(xs, kernel)
    return _conv2d_same_direct(xs, kernel, pads)


def _shift_acc_conv(xs: torch.Tensor, kernel: np.ndarray, pads_y, pads_x) -> torch.Tensor:
    """Direct convolution as shifted multiply-adds; zero taps are skipped.
    ``xs`` is (B, H, W); true convolution (kernel flipped)."""
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    flipped = kernel[::-1, ::-1]
    (ly, hy), (lx, hx) = pads_y, pads_x
    xp = F.pad(xs, (lx, hx, ly, hy))
    h_out = xs.shape[1] + ly + hy - kh + 1
    w_out = xs.shape[2] + lx + hx - kw + 1
    acc = None
    for r in range(kh):
        for c in range(kw):
            wgt = float(flipped[r, c])
            if wgt == 0.0:
                continue
            term = xp[:, r : r + h_out, c : c + w_out] * wgt
            acc = term if acc is None else acc + term
    if acc is None:
        acc = xs.new_zeros((xs.shape[0], h_out, w_out))
    return acc


@contextlib.contextmanager
def _cudnn_without_tf32():
    # cuDNN runs float32 convolutions in TF32 by default (~3 decimal
    # digits); the reference convolves in full float32
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv2d_same_direct(xs: torch.Tensor, kernel: np.ndarray, pads) -> torch.Tensor:
    kh, kw = kernel.shape
    if kh * kw <= CFG.shift_acc_max_taps:
        return _shift_acc_conv(xs, kernel, *pads)
    # large weighted kernels: a library convolution, as the JAX package
    # leaves this one to XLA outside any Pallas kernel
    (ly, hy), (lx, hx) = pads
    flipped = upload(kernel[::-1, ::-1].astype(np.float32), xs.device)
    xp = F.pad(xs, (lx, hx, ly, hy))[:, None]
    with _cudnn_without_tf32():
        out = F.conv2d(xp, flipped[None, None])
    return out[:, 0]


def _conv2d_same_fft(xs: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    _, h, w = xs.shape
    kh, kw = kernel.shape
    fh = _fft_shape(h + kh - 1)
    fw = _fft_shape(w + kw - 1)
    k = upload(kernel.astype(np.float32), xs.device)
    fx = torch.fft.rfft2(xs, s=(fh, fw))
    fk = torch.fft.rfft2(k, s=(fh, fw))
    full = torch.fft.irfft2(fx * fk[None], s=(fh, fw))
    sh = (kh - 1) // 2
    sw = (kw - 1) // 2
    return full[:, sh : sh + h, sw : sw + w].to(xs.dtype)


# --- reflect padding & separable Gaussian -----------------------------------


def reflect_pad_1d(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Symmetric ('reflect' in scipy.ndimage terms: d c b a | a b c d)
    padding along one axis; pads wider than the axis reflect repeatedly."""
    n = x.shape[axis]
    while lo > 0 or hi > 0:
        take_lo = min(lo, n)
        take_hi = min(hi, n)
        parts = []
        if take_lo:
            parts.append(torch.flip(x.narrow(axis, 0, take_lo), dims=(axis,)))
        parts.append(x)
        if take_hi:
            parts.append(torch.flip(x.narrow(axis, n - take_hi, take_hi), dims=(axis,)))
        x = torch.cat(parts, dim=axis)
        n = x.shape[axis]
        lo -= take_lo
        hi -= take_hi
    return x


def _correlate1d_valid(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """1-D VALID correlation along ``axis`` with host-side (numpy) taps:
    shifted multiply-adds for short filters, per-axis FFTs for long ones."""
    taps_np = np.asarray(taps)
    t = int(taps_np.shape[0])
    n = x.shape[axis]
    n_out = n - t + 1
    if t > CFG.fft_correlate1d_min_taps:
        fn = _fft_shape(n)
        fx = torch.fft.rfft(x, n=fn, dim=axis)
        ft = torch.fft.rfft(upload(taps_np[::-1].astype(np.float32), x.device), n=fn)
        shape = [1, 1]
        shape[axis] = ft.shape[0]
        full = torch.fft.irfft(fx * ft.reshape(shape), n=fn, dim=axis)
        return full.narrow(axis, t - 1, n_out).to(x.dtype)
    acc = None
    for i in range(t):
        term = x.narrow(axis, i, n_out) * float(taps_np[i])
        acc = term if acc is None else acc + term
    return acc


def gaussian_filter(
    x: torch.Tensor,
    sigma: Union[float, Tuple[float, float]],
    truncate: float = 4.0,
    pad: bool = True,
) -> torch.Tensor:
    """Separable Gaussian smoothing with ``scipy.ndimage.gaussian_filter``
    parity: truncated sampled taps, 'reflect' boundary, one pass per axis.
    ``pad=False`` returns the VALID interior."""
    if np.isscalar(sigma):
        sigmas = (float(sigma), float(sigma))
    else:
        sigmas = (float(sigma[0]), float(sigma[1]))
    for axis, s in enumerate(sigmas):
        if s <= 0:
            continue
        taps = gaussian_kernel1d(s, truncate).astype(np.float32)
        r = (taps.shape[0] - 1) // 2
        if pad:
            x = reflect_pad_1d(x, axis, r, r)
        x = _correlate1d_valid(x, taps, axis)
    return x


# --- exact boundary count plane ---------------------------------------------


def _edge_count_plane_rank1(shape, kernel: np.ndarray, runs, device) -> torch.Tensor:
    """``conv2d_same(ones(shape), kernel)`` for {0,1} kernels: each group of
    rows sharing a run contributes (in-bounds source rows at output row y)
    x (in-bounds columns of the run at output column x), a rank-1 term.

    The 1-D factors are built on the host and the plane is one (H, G) @
    (G, W) product on ``device``: every factor and partial sum is an integer
    below 2^24, so the float32 result is exact in any summation order."""
    h, w = shape
    kh, kw = np.asarray(kernel).shape
    sy, sx_ = (kh - 1) // 2, (kw - 1) // 2
    ly, lx = kh - 1 - sy, kw - 1 - sx_

    groups = disk_sat.group_runs(runs)
    if not groups:
        return torch.zeros((h, w), dtype=torch.float32, device=device)
    rows = np.array([r for _, _, grows in groups for r in grows])
    owner = np.repeat(np.arange(len(groups)), [len(grows) for _, _, grows in groups])
    a = np.array([g[0] for g in groups])[:, None]
    bcol = np.array([g[1] for g in groups])[:, None]
    # source rows live at padded rows [ly, ly+h); run row = y + r
    y = np.arange(h)[:, None] + rows[None, :]
    inside = ((y >= ly) & (y < ly + h)).astype(np.float32)  # (H, runs)
    rvecs = inside @ np.eye(len(groups), dtype=np.float32)[owner]  # (H, G)
    # run cols x+a..x+bcol (padded, sentinel-shifted: +1); sources at
    # padded cols [lx+1, lx+1+w)
    x = np.arange(w)[None, :]
    hi = np.minimum(x + bcol + 1, lx + w)
    lo = np.maximum(x + a + 1, lx + 1)
    cvecs = np.maximum(hi - lo + 1, 0).astype(np.float32)  # (G, W)
    rmat = upload(rvecs, device)
    cmat = upload(cvecs, device)
    return rmat @ cmat


def edge_count_plane_device(shape, kernel: np.ndarray, device) -> torch.Tensor:
    """Exact ``conv2d_same(ones(shape), kernel)`` built on ``device``: the
    rank-1 run form for {0,1} kernels, else lookups into the kernel's
    integral image."""
    runs = _binary_kernel_runs(np.asarray(kernel)[::-1, ::-1])
    if runs is not None:
        return _edge_count_plane_rank1(shape, kernel, runs, device)
    h, w = shape
    kernel = np.asarray(kernel, dtype=np.float64)
    kh, kw = kernel.shape
    sh, sw = (kh - 1) // 2, (kw - 1) // 2
    integral = np.zeros((kh + 1, kw + 1), dtype=np.float32)
    integral[1:, 1:] = kernel.cumsum(0).cumsum(1)
    table = upload(integral, device)

    y = torch.arange(h, device=device)
    x = torch.arange(w, device=device)
    m0 = torch.clamp(y + sh - (h - 1), 0, kh)
    m1 = torch.clamp(y + sh + 1, 0, kh)
    n0 = torch.clamp(x + sw - (w - 1), 0, kw)
    n1 = torch.clamp(x + sw + 1, 0, kw)
    rows_hi = table[m1]  # (H, kw+1)
    rows_lo = table[m0]
    return rows_hi[:, n1] - rows_lo[:, n1] - rows_hi[:, n0] + rows_lo[:, n0]
