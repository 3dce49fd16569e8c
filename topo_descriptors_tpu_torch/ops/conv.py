"""Stencil/convolution engine on PyTorch.

Counterpart of ``topo_descriptors_tpu/ops/conv.py`` with the same parity
targets: ``scipy.signal.convolve(mode='same')`` for :func:`conv2d_same`
and the bank forms, ``scipy.ndimage.gaussian_filter`` (truncate=4.0,
'reflect') for :func:`gaussian_filter`, ``scipy.ndimage.convolve`` for
:func:`convolve_reflect` and ``np.gradient`` for :func:`gradient_axis`.
Library convolutions run in full float32 (:func:`full_float32`).
{0,1}-valued kernels (disks) go through the prefix-sum convolution of
:mod:`.cuda.disk_sat` — the hand-written CUDA kernel for CUDA tensors, its
plain twin for CPU tensors. The routing thresholds are the shared ``CFG``
values.

Functions take and return float32 tensors and keep them on their device.
"""

from __future__ import annotations

import contextlib
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.device import upload
from topo_descriptors_tpu_torch.kernels.disk import Disk
from topo_descriptors_tpu_torch.kernels.gaussian import gaussian_kernel1d
from topo_descriptors_tpu_torch.ops.cuda import disk_sat
from topo_descriptors_tpu_torch.utils.timing import span

# The run lists the disk routes took, by where they came from: "closed_form"
# from a Disk's diameter, "scanned" from a {0,1} array's values.
DISK_RUNS = {"closed_form": 0, "scanned": 0}


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
    with span("prep.runs"):
        k = np.asarray(kernel)
        if not np.isin(k, (0.0, 1.0)).all():
            return None
        edges = np.diff(np.pad(k != 0, ((0, 0), (1, 1))).astype(np.int8), axis=1)
        rows, first = np.nonzero(edges == 1)  # row-major: runs in row order
        _, end = np.nonzero(edges == -1)
        return [(int(r), int(s), int(e - 1)) for r, s, e in zip(rows, first, end)]


def _as_kernel(kernel):
    """A :class:`Disk` as it is, any other kernel as an ndarray."""
    return kernel if isinstance(kernel, Disk) else np.asarray(kernel)


def _kernel_runs(kernel):
    """The flipped kernel's runs: a Disk's from its diameter, an array's
    from a scan of its values (None unless they are all 0 or 1)."""
    if isinstance(kernel, Disk):
        runs, source = kernel.runs, "closed_form"
    else:
        runs, source = _binary_kernel_runs(kernel[::-1, ::-1]), "scanned"
    if runs is not None:
        DISK_RUNS[source] += 1
    return runs


def _sat_runs(kernel, method: str):
    """The flipped kernel's runs when the prefix-sum path applies, else None."""
    kh, kw = kernel.shape
    if method not in ("auto", "sat") or (method == "auto" and kh * kw < CFG.sat_conv_min_taps):
        return None
    runs = _kernel_runs(kernel)
    if method == "sat" and runs is None:
        raise ValueError("method='sat' requires a {0,1}-valued kernel")
    return runs


def conv2d_same(x: torch.Tensor, kernel, method: str = "auto") -> torch.Tensor:
    """2-D convolution, ``mode='same'`` with zero boundary; ``kernel`` is an
    array or a :class:`Disk`.

    Parity target: ``scipy.signal.convolve(x, kernel, mode='same')``. Methods:
    ``'sat'`` (prefix sums, {0,1} kernels), ``'direct'``, ``'fft'``, or
    ``'auto'``, which picks among them by the kernel's values and size.
    """
    return conv2d_same_multi(x[None], kernel, method)[0]


def conv2d_same_multi(xs: torch.Tensor, kernel, method: str = "auto") -> torch.Tensor:
    """Convolve a stack of 2-D fields (B, H, W) with one kernel (an array or
    a :class:`Disk`) -> (B, H, W)."""
    kernel = _as_kernel(kernel)
    kh, kw = kernel.shape
    pads = (_same_pads(kh), _same_pads(kw))
    runs = _sat_runs(kernel, method)
    if runs is not None:  # the JAX package's _conv2d_sat
        return disk_sat.disk_conv_sat(xs, kernel.shape, runs, pads)
    kernel = np.asarray(kernel)  # a Disk's mask: these routes need the weights
    if method in ("auto", "sat"):
        method = "fft" if kernel.size >= CFG.fft_conv_min_taps else "direct"
    if method == "fft":
        return _conv2d_same_fft(xs, kernel)
    return _conv2d_direct(xs, kernel, pads)


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


def _read_flag(get):
    try:
        return get()
    except RuntimeError:  # the caller mixed the legacy and the new TF32 API
        return None


@contextlib.contextmanager
def full_float32():
    """Run cuBLAS matmuls and cuDNN convolutions in full float32 inside the
    block, whatever the caller set globally, and restore the caller's
    settings after it.

    Both libraries may run float32 in TF32 (~2^-11 relative), which a user
    turns on with ``torch.set_float32_matmul_precision('high')`` or the
    ``fp32_precision`` / ``allow_tf32`` flags (cuDNN convolutions default
    to it). The reference computes these products to ~2^-21, and TF32 is
    enough to flip the valley/ridge direction argmax. The legacy and the
    new flags are both pinned, so each reads "full float32" inside."""
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    new_api = hasattr(mm, "fp32_precision")
    legacy = (_read_flag(torch.get_float32_matmul_precision),
              _read_flag(lambda: cd.allow_tf32))
    new = (mm.fp32_precision, cd.fp32_precision, cd.conv.fp32_precision) if new_api else None
    torch.set_float32_matmul_precision("highest")
    cd.allow_tf32 = False
    if new_api:
        mm.fp32_precision = cd.fp32_precision = cd.conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        if legacy[0] is not None:
            torch.set_float32_matmul_precision(legacy[0])
        if legacy[1] is not None:
            cd.allow_tf32 = legacy[1]
        if new_api:
            mm.fp32_precision, cd.fp32_precision, cd.conv.fp32_precision = new


def _conv2d_direct(xs: torch.Tensor, kernel: np.ndarray, pads) -> torch.Tensor:
    """True convolution of a (B, H, W) stack with zero ``pads`` =
    ``((ly, hy), (lx, hx))``: 'same' or 'valid' placement."""
    kh, kw = kernel.shape
    if kh * kw <= CFG.shift_acc_max_taps:
        return _shift_acc_conv(xs, kernel, *pads)
    # large weighted kernels: a library convolution, as the JAX package
    # leaves this one to XLA outside any Pallas kernel
    (ly, hy), (lx, hx) = pads
    flipped = upload(kernel[::-1, ::-1].astype(np.float32), xs.device)
    xp = F.pad(xs, (lx, hx, ly, hy))[:, None]
    with full_float32():
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


def conv2d_valid(xs: torch.Tensor, kernel, method: str = "auto") -> torch.Tensor:
    """VALID-mode true convolution of a (B, H, W) stack with one kernel (an
    array or a :class:`Disk`) -> (B, H-kh+1, W-kw+1): ``out[i] = sum_j
    x[i+j] * flip(kernel)[j]``. Routes as :func:`conv2d_same_multi`, with
    zero pads."""
    kernel = _as_kernel(kernel)
    kh, kw = kernel.shape
    runs = _sat_runs(kernel, method)
    if runs is not None:
        return disk_sat.disk_conv_sat(xs, kernel.shape, runs, ((0, 0), (0, 0)))
    kernel = np.asarray(kernel)
    if method in ("auto", "sat"):
        method = "fft" if kernel.size >= CFG.fft_conv_min_taps else "direct"
    if method == "fft":
        _, h, w = xs.shape
        fh, fw = _fft_shape(h), _fft_shape(w)
        fx = torch.fft.rfft2(xs, s=(fh, fw))
        fk = torch.fft.rfft2(upload(kernel.astype(np.float32), xs.device), s=(fh, fw))
        full = torch.fft.irfft2(fx * fk[None], s=(fh, fw))
        return full[:, kh - 1 : h, kw - 1 : w].to(xs.dtype)
    return _conv2d_direct(xs, kernel, ((0, 0), (0, 0)))


def _bank_tensor(kernels, like: torch.Tensor) -> torch.Tensor:
    if isinstance(kernels, torch.Tensor):
        return kernels.to(device=like.device, dtype=like.dtype)
    return upload(np.asarray(kernels, dtype=np.float32), like.device)


def conv2d_same_batch(x: torch.Tensor, kernels, method: str = "auto") -> torch.Tensor:
    """Convolve one 2-D field with a (n, kh, kw) kernel bank -> (n, H, W),
    ``mode='same'``: one batched FFT with the field transform computed
    once, or one library convolution with the bank as output channels."""
    kernels = _bank_tensor(kernels, x)
    n, kh, kw = kernels.shape
    if method == "auto":
        method = "fft" if kh * kw >= CFG.fft_conv_min_taps else "direct"
    if method == "fft":
        h, w = x.shape
        fh = _fft_shape(h + kh - 1)
        fw = _fft_shape(w + kw - 1)
        fx = torch.fft.rfft2(x, s=(fh, fw))
        fk = torch.fft.rfft2(kernels, s=(fh, fw))
        full = torch.fft.irfft2(fx[None] * fk, s=(fh, fw))
        sh = (kh - 1) // 2
        sw = (kw - 1) // 2
        return full[:, sh : sh + h, sw : sw + w].to(x.dtype)
    (ly, hy), (lx, hx) = _same_pads(kh), _same_pads(kw)
    xp = F.pad(x, (lx, hx, ly, hy))[None, None]
    with full_float32():
        out = F.conv2d(xp, torch.flip(kernels, (1, 2))[:, None])
    return out[0]


def conv2d_valid_bank(x: torch.Tensor, kernels, method: str = "auto") -> torch.Tensor:
    """VALID-mode true convolution of one 2-D field with a (n, kh, kw)
    kernel bank -> (n, H-kh+1, W-kw+1): one batched FFT with the field
    transform computed once (``'fft'``), or one library convolution with
    the bank as output channels in full float32 (``'direct'``); ``'auto'``
    picks by the kernel's area, as the JAX package's function does."""
    kernels = _bank_tensor(kernels, x)
    n, kh, kw = kernels.shape
    if method == "auto":
        method = "fft" if kh * kw >= CFG.fft_conv_min_taps else "direct"
    h, w = x.shape
    if method == "fft":
        fh, fw = _fft_shape(h), _fft_shape(w)
        fx = torch.fft.rfft2(x, s=(fh, fw))
        fk = torch.fft.rfft2(kernels, s=(fh, fw))
        full = torch.fft.irfft2(fx[None] * fk, s=(fh, fw))
        return full[:, kh - 1 : h, kw - 1 : w].to(x.dtype)
    if method != "direct":
        raise ValueError(f"unknown method {method!r}: expected auto, fft or direct")
    with full_float32():
        out = F.conv2d(x[None, None], torch.flip(kernels, (1, 2))[:, None])
    return out[0]


def conv2d_bank_rowchan(x: torch.Tensor, kernels, padding: str = "same") -> torch.Tensor:
    """Kernel-bank convolution with the kernel rows as input channels:
    ``out[o,i,j] = sum_{r,u} x[i+r-lo, j+u-lo] * flip(k)[o,r,u]``, one
    library convolution of the KY row-shifted copies of the field with a
    (n, KY, 1, KX) weight. The valley/ridge ``method='direct'`` route.
    Memory: the row stack is KY copies of the field."""
    kernels = _bank_tensor(kernels, x)
    n, ky, kx = kernels.shape
    if padding == "same":
        (ly, hy), pad_x = _same_pads(ky), _same_pads(kx)
        xp = F.pad(x, (0, 0, ly, hy))
        h_out = x.shape[0]
    elif padding == "valid":
        xp, pad_x = x, (0, 0)
        h_out = x.shape[0] - ky + 1
    else:
        raise ValueError(f"unknown padding {padding!r}: expected same or valid")
    rows = torch.stack([xp[r : r + h_out] for r in range(ky)])  # (KY, H_out, W)
    rows = F.pad(rows, pad_x)
    with full_float32():
        out = F.conv2d(rows[None], torch.flip(kernels, (1, 2))[:, :, None, :])
    return out[0]


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
    with span("smooth"):
        for axis, s in enumerate(sigmas):
            if s <= 0:
                continue
            taps = gaussian_kernel1d(s, truncate).astype(np.float32)
            r = (taps.shape[0] - 1) // 2
            if pad:
                x = reflect_pad_1d(x, axis, r, r)
            x = _correlate1d_valid(x, taps, axis)
        return x


def convolve_reflect(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """True 2-D convolution with 'reflect' boundary: parity with
    ``scipy.ndimage.convolve(x, kernel)`` (mode='reflect', origin 0), as the
    Sobel path uses it. Odd kernel dims only."""
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    xp = reflect_pad_1d(x, 0, kh // 2, kh // 2)
    xp = reflect_pad_1d(xp, 1, kw // 2, kw // 2)
    return conv2d_valid(xp[None], kernel)[0]


def gradient_axis(x: torch.Tensor, axis: int, edge_order: str = "one_sided") -> torch.Tensor:
    """``np.gradient`` along one axis: central differences inside, one-sided
    differences at the two edges. ``edge_order='none'`` keeps the central
    (wrapped) differences everywhere, for blocks whose true edge lies
    elsewhere."""
    grad = (torch.roll(x, -1, axis) - torch.roll(x, 1, axis)) * 0.5
    if edge_order == "none":
        return grad
    n = x.shape[axis]
    first = x.narrow(axis, 1, 1) - x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1) - x.narrow(axis, n - 2, 1)
    return torch.cat([first, grad.narrow(axis, 1, n - 2), last], dim=axis)


# --- exact boundary count plane ---------------------------------------------


def edge_count_plane(shape: Tuple[int, int], kernel: np.ndarray) -> np.ndarray:
    """Exact ``conv2d_same(ones(shape), kernel)`` on the host in float64.

    Near the zero-padded boundary a 'same' convolution sums fewer kernel
    taps; this plane is the per-pixel sum of the in-bounds taps, read from
    the kernel's integral image (O(N), no convolution). Counterpart of
    ``topo_descriptors_tpu.ops.conv.edge_count_plane``;
    :func:`edge_count_plane_device` builds the same plane on a device.
    """
    h, w = shape
    kernel = np.asarray(kernel, dtype=np.float64)
    kh, kw = kernel.shape
    sh, sw = (kh - 1) // 2, (kw - 1) // 2
    integral = np.zeros((kh + 1, kw + 1))
    integral[1:, 1:] = kernel.cumsum(0).cumsum(1)
    # kernel row window of output row y: [y+sh-(h-1), y+sh], clipped
    y, x = np.arange(h), np.arange(w)
    m0 = np.clip(y + sh - (h - 1), 0, kh)
    m1 = np.clip(y + sh + 1, 0, kh)
    n0 = np.clip(x + sw - (w - 1), 0, kw)
    n1 = np.clip(x + sw + 1, 0, kw)
    return (
        integral[np.ix_(m1, n1)]
        - integral[np.ix_(m0, n1)]
        - integral[np.ix_(m1, n0)]
        + integral[np.ix_(m0, n0)]
    )


def _edge_count_plane_rank1(shape, kshape, runs, device, window) -> torch.Tensor:
    """``conv2d_same(ones(shape), kernel)`` for {0,1} kernels: each group of
    rows sharing a run contributes (in-bounds source rows at output row y)
    x (in-bounds columns of the run at output column x), a rank-1 term.

    The 1-D factors are built on the host and the plane is one (H, G) @
    (G, W) product on ``device``: every factor and partial sum is an integer
    below 2^24, so the float32 result is exact in any summation order."""
    h, w = shape
    (r0, r1), (c0, c1) = window
    kh, kw = kshape
    sy, sx_ = (kh - 1) // 2, (kw - 1) // 2
    ly, lx = kh - 1 - sy, kw - 1 - sx_

    groups = disk_sat.group_runs(runs)
    if not groups:
        return torch.zeros((r1 - r0, c1 - c0), dtype=torch.float32, device=device)
    rows = np.array([r for _, _, grows in groups for r in grows])
    owner = np.repeat(np.arange(len(groups)), [len(grows) for _, _, grows in groups])
    a = np.array([g[0] for g in groups])[:, None]
    bcol = np.array([g[1] for g in groups])[:, None]
    # source rows live at padded rows [ly, ly+h): run row r is inside at
    # output rows y in [ly-r, ly+h-r), counted per group as a running sum
    # of +1/-1 steps over the window's rows
    n = r1 - r0
    steps = np.zeros((n + 1, len(groups)), dtype=np.int32)
    np.add.at(steps, (np.clip(ly - rows - r0, 0, n), owner), 1)
    np.add.at(steps, (np.clip(ly + h - rows - r0, 0, n), owner), -1)
    rvecs = np.cumsum(steps[:-1], axis=0, dtype=np.int32).astype(np.float32)  # (H, G)
    # run cols x+a..x+bcol (padded, sentinel-shifted: +1); sources at
    # padded cols [lx+1, lx+1+w)
    x = np.arange(c0, c1)[None, :]
    hi = np.minimum(x + bcol + 1, lx + w)
    lo = np.maximum(x + a + 1, lx + 1)
    cvecs = np.maximum(hi - lo + 1, 0).astype(np.float32)  # (G, W)
    rmat = upload(rvecs, device)
    cmat = upload(cvecs, device)
    return rmat @ cmat


def edge_count_plane_device(shape, kernel, device, window=None) -> torch.Tensor:
    """Exact ``conv2d_same(ones(shape), kernel)`` built on ``device``: the
    rank-1 run form for {0,1} kernels (a :class:`Disk` gives its runs from
    its diameter), else lookups into the kernel's integral image. ``window
    = ((r0, r1), (c0, c1))`` builds only those rows and columns of the plane
    (a block of a sharded grid)."""
    with span("prep.count_plane"):
        h, w = shape
        window = ((0, h), (0, w)) if window is None else window
        kernel = _as_kernel(kernel)
        runs = _kernel_runs(kernel)
        if runs is not None:
            return _edge_count_plane_rank1(shape, kernel.shape, runs, device, window)
        kernel = np.asarray(kernel, dtype=np.float64)
        kh, kw = kernel.shape
        sh, sw = (kh - 1) // 2, (kw - 1) // 2
        integral = np.zeros((kh + 1, kw + 1), dtype=np.float32)
        integral[1:, 1:] = kernel.cumsum(0).cumsum(1)
        table = upload(integral, device)

        y = torch.arange(*window[0], device=device)
        x = torch.arange(*window[1], device=device)
        m0 = torch.clamp(y + sh - (h - 1), 0, kh)
        m1 = torch.clamp(y + sh + 1, 0, kh)
        n0 = torch.clamp(x + sw - (w - 1), 0, kw)
        n1 = torch.clamp(x + sw + 1, 0, kw)
        rows_hi = table[m1]  # (H, kw+1)
        rows_lo = table[m0]
        return rows_hi[:, n1] - rows_lo[:, n1] - rows_hi[:, n0] + rows_lo[:, n0]
