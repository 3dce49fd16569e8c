"""Valley / ridge index over 180 rotated V/U-kernel orientations.

Counterpart of ``topo_descriptors_tpu/ops/valley_ridge.py``. Each of the
JAX package's ``lax.scan`` loops over angle chunks or quadrant steps is a
Python loop here that carries ``(norm, direction)`` on the device. The
convolutions are the partial-DFT matmuls of :mod:`.dft_conv`, library
convolutions or ``torch.fft``, all in full float32; none of them is a
hand kernel (the JAX package keeps them outside any Pallas kernel too).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.device import as_field, upload
from topo_descriptors_tpu_torch.kernels.valley import (
    ridge_kernels,
    rotated_extent,
    rotated_kernel_bank,
    valley_kernels,
)
from topo_descriptors_tpu_torch.ops.conv import _fft_shape, conv2d_bank_rowchan, gaussian_filter
from topo_descriptors_tpu_torch.ops.dft_conv import conv_bank, field_spectrum, get_plan, prefer_dft_matmul
from topo_descriptors_tpu_torch.ops.spline_rotate import (
    build_rotation_table,
    canvas_variants,
    prefilter2d_o2,
    quadrant_schedule,
    rotate_std_canvas_table,
    rotation_params,
)

METHODS = ("auto", "dftmm", "direct", "fft", "stream")


def bank_nbytes(size: int, n_flats: int, n_angles: int = 180) -> int:
    """float32 size of the full padded rotation bank, computed without
    building it. Above ``CFG.valley_bank_max_bytes`` (the reference's 20-100
    km example scales reach 1.8-48 GB) :func:`valley_ridge` streams."""
    ky, kx = rotated_extent(size)
    return n_angles * n_flats * ky * kx * 4


def prepare_valley_bank(
    size: int,
    mode: str,
    flat_list: Sequence[float],
    angles: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The rotated kernel bank as one (A, F, KY, KX) float32 array (host,
    scipy rotations). Each angle's rotation is zero-padded to the common
    maximum with the split that keeps the 'same' anchor ``(k-1)//2``, so the
    padded bank convolves exactly as the ragged one."""
    if angles is None:
        angles = np.arange(0, 180, dtype=np.float32)
    bank = rotated_kernel_bank(size, mode, flat_list, angles)
    ky_max = max(k.shape[1] for k in bank)
    kx_max = max(k.shape[2] for k in bank)
    padded = np.zeros((len(bank), bank[0].shape[0], ky_max, kx_max), np.float32)
    for i, k in enumerate(bank):
        _, ky, kx = k.shape
        lo_y = (ky_max - 1) // 2 - (ky - 1) // 2
        lo_x = (kx_max - 1) // 2 - (kx - 1) // 2
        padded[i, :, lo_y : lo_y + ky, lo_x : lo_x + kx] = k
    return padded


def _flat_axis_combine(convs: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Flat-axis windowed sums of the reference's 3-D convolution.

    The reference broadcasts the DEM over the flat axis and runs a 3-D
    ``signal.convolve(mode='same')``. The field is constant along that
    axis, so the 3-D conv is the F per-flat 2-D convolutions summed over a
    sliding window: ``out[f] = sum_g conv2d(dem, K[g])`` for ``g`` in
    ``[f+c-F+1, f+c] ∩ [0, F-1]`` with ``c=(F-1)//2``. The sums are linear,
    so the fast routes apply them to the kernels before convolving."""
    f = convs.shape[axis]
    c = (f - 1) // 2
    cums = torch.cumsum(convs, dim=axis)
    outs = []
    for i in range(f):
        lo, hi = max(0, i + c - f + 1), min(f - 1, i + c)
        upper = cums.select(axis, hi)
        outs.append(upper if lo == 0 else upper - cums.select(axis, lo - 1))
    return torch.stack(outs, dim=axis)


def _fold_flats_np(bank: np.ndarray) -> np.ndarray:
    """:func:`_flat_axis_combine` over axis 1 of an (A, F, KY, KX) host
    bank, in float64 (fold into the kernels for the bank route)."""
    f = bank.shape[1]
    c = (f - 1) // 2
    cums = np.cumsum(bank, axis=1, dtype=np.float64)
    outs = []
    for i in range(f):
        lo, hi = max(0, i + c - f + 1), min(f - 1, i + c)
        v = cums[:, hi]
        if lo > 0:
            v = v - cums[:, lo - 1]
        outs.append(v)
    return np.stack(outs, axis=1).astype(np.float32)


def _standardized(dem: torch.Tensor, sigma, stats) -> torch.Tensor:
    if sigma:
        dem = gaussian_filter(dem, sigma)
    if stats is None:
        # the population std (ddof=0), as jnp.std
        return (dem - dem.mean()) / dem.std(correction=0)
    return (dem - stats[0]) / stats[1]  # out-of-core: global, precomputed


def _evict_to(cache: dict, n: int) -> None:
    while len(cache) >= n:  # bound the resident banks / canvas stacks
        cache.pop(next(iter(cache)))


# --- precomputed-bank routes ---------------------------------------------------


def _scan_chunks(bank_chunks, n_flats, shape, conv_combined):
    """Running max/argmax over the bank's angle chunks ((n_chunks,
    chunk*F, KY, KX) on the device); ``conv_combined(kernels)`` gives a
    chunk's (chunk, H, W) flat-combined maxima. ``torch.argmax`` keeps the
    first maximum, so ties keep the earliest angle, as the reference's
    strictly-greater running update."""
    chunk = bank_chunks.shape[1] // n_flats
    norm = torch.full(shape, -torch.inf, dtype=torch.float32, device=bank_chunks.device)
    direction = torch.zeros(shape, dtype=torch.float32, device=bank_chunks.device)
    for i, kernels in enumerate(bank_chunks):
        combined = conv_combined(kernels)
        chunk_best = combined.amax(dim=0)
        chunk_arg = combined.argmax(dim=0).to(norm.dtype)
        greater = chunk_best > norm
        norm = torch.where(greater, chunk_best, norm)
        direction = torch.where(greater, i * chunk + chunk_arg, direction)
    return [torch.clamp(norm, min=0.0), direction]


_BANK_DEV_CACHE: dict = {}


def _valley_ridge_bank_mm(dem, bank, angle_chunk, cache_key=None,
                          bank_shape=None, builder=None):
    """Precomputed-bank valley/ridge through partial-DFT matmuls.

    ``cache_key`` (set when the caller built the bank from its canonical
    (size, mode, flat_list) signature) keeps the folded, chunked bank on
    the device across calls, keyed on the device too: the scipy rotations
    and the upload happen once per signature."""
    h, w = dem.shape
    a_angles, n_flats, ky, kx = bank_shape if bank is None else bank.shape
    plan = get_plan(h, w, ky, kx, "same", dem.device)
    # bound the (chunk*F, fh, nb) spectral transients by the chunk budget
    per_angle = plan.fh * plan.nb * 8 * n_flats
    chunk = int(max(1, min(angle_chunk, CFG.valley_chunk_bytes // per_angle)))
    while a_angles % chunk:
        chunk -= 1
    key = cache_key + (chunk, dem.device) if cache_key is not None else None
    bank_dev = _BANK_DEV_CACHE.get(key) if key is not None else None
    if bank_dev is None:
        if bank is None:
            bank = builder()
        folded = _fold_flats_np(np.asarray(bank, dtype=np.float32))
        bank_dev = upload(folded.reshape(a_angles // chunk, chunk * n_flats, ky, kx), dem.device)
        if key is not None:
            _evict_to(_BANK_DEV_CACHE, 2)
            _BANK_DEV_CACHE[key] = bank_dev
    fdr, fdi = field_spectrum(dem, plan)

    def conv_combined(kernels):  # kernels pre-folded over the flats
        return conv_bank(kernels, fdr, fdi, plan).reshape(-1, n_flats, h, w).amax(dim=1)

    return _scan_chunks(bank_dev, n_flats, (h, w), conv_combined)


# --- streamed route: rotation on the device + quadrant symmetry ----------------


_CANVAS_DEV_CACHE: dict = {}


def _rotate_folded(table, n, params, kmax) -> torch.Tensor:
    """One quadrant angle's rotated, masked-standardized, flat-folded
    (F, kmax, kmax) canvas."""
    return _flat_axis_combine(rotate_std_canvas_table(table, n, params, (kmax, kmax)), 0)


def _fft_conv_fn(dem: torch.Tensor, kmax: int) -> Callable:
    """kernels (B, kmax, kmax) -> (B, h, w), 'same' convolution with the
    field's transform computed once."""
    h, w = dem.shape
    fh, fw = _fft_shape(h + kmax - 1), _fft_shape(w + kmax - 1)
    sh = sw = (kmax - 1) // 2
    f_dem = torch.fft.rfft2(dem, s=(fh, fw))

    def conv(kernels):
        full = torch.fft.irfft2(f_dem[None] * torch.fft.rfft2(kernels, s=(fh, fw)), s=(fh, fw))
        return full[:, sh : sh + h, sw : sw + w]

    return conv


def _streamed_scan(canvas_of, conv_fn, qparams, slot_angle, slot_valid,
                   q_batch, n_flats, shape, device):
    """The quadrant scan: each step convolves all four variants of
    ``q_batch`` quadrant angles as one bank and folds the result into the
    running max. ``canvas_of(q)`` gives quadrant angle ``q``'s folded
    canvas (from the cached stack, or rotated inline).

    Direction keeps the minimum angle among the maxima (min-angle-on-ties),
    which equals the reference's ascending strictly-greater update for any
    processing order. Invalid slots (duplicates, schedule padding) are
    masked to -inf before the max."""
    h, w = shape
    n_steps = qparams.shape[0] // q_batch
    angles_all = upload(slot_angle.reshape(n_steps, 4 * q_batch), device)
    valid_all = upload(slot_valid.reshape(n_steps, 4 * q_batch), device)
    norm = torch.full((h, w), -torch.inf, dtype=torch.float32, device=device)
    direction = torch.zeros((h, w), dtype=torch.float32, device=device)
    for step in range(n_steps):
        qs = range(step * q_batch, (step + 1) * q_batch)
        kern = torch.cat([torch.cat(canvas_variants(canvas_of(q), qparams[q]), 0) for q in qs], 0)
        convs = conv_fn(kern).reshape(4 * q_batch, n_flats, h, w)
        comb = convs.amax(dim=1)  # (Q*4, h, w)
        angles, valid = angles_all[step], valid_all[step]
        comb = torch.where(valid[:, None, None], comb, -torch.inf)
        best = comb.amax(dim=0)
        # min angle among the batch's argmax set
        amin = torch.where(comb == best, angles[:, None, None], torch.inf).amin(dim=0)
        greater = best > norm
        equal = (best == norm) & (norm > -torch.inf)
        direction = torch.where(
            greater, amin, torch.where(equal, torch.minimum(direction, amin), direction)
        )
        norm = torch.where(greater, best, norm)
    return norm, direction


def valley_ridge_streamed(
    dem,
    size: int,
    mode: str,
    flat_list: Sequence[float] = (0, 0.15, 0.3),
    sigma: Optional[float] = None,
    stats: Optional[tuple] = None,
    n_angles: int = 180,
    conv_method: str = "auto",
    q_batch: int = 4,
    device="cuda",
) -> List[torch.Tensor]:
    """Valley/ridge with the kernel rotation performed on the device;
    counterpart of ``topo_descriptors_tpu.ops.valley_ridge_streamed``, for
    scales whose 180-angle bank cannot exist as one array.

    * the base V/U stack is spline-prefiltered once and packed into the
      gather table (:func:`~.spline_rotate.build_rotation_table`);
    * only the quadrant angles [0, 45] are rotated; the other three
      quadrants are exact flips/rot90s (:func:`~.spline_rotate.canvas_variants`);
    * the flat-axis combine is folded into the canvases before convolving;
    * ``conv_method``: ``'mm'`` (partial-DFT matmuls), ``'fft'``
      (``torch.fft`` with the field transform hoisted), or ``'auto'``,
      which asks :func:`~.dft_conv.prefer_dft_matmul`;
    * ``q_batch`` quadrant angles go through each step; the schedule is
      padded with invalid slots to a multiple of it;
    * the rotated, folded canvas stack is cached on the device per
      (size, mode, flats, device) while it fits
      ``CFG.valley_canvas_cache_bytes`` (2 stacks at most); larger stacks
      are rotated inline, step by step.
    """
    if mode not in ("valley", "ridge"):
        raise ValueError(f"Unknown mode {mode!r}")
    dem = _standardized(as_field(dem, device), sigma, stats)
    base = ridge_kernels(size, flat_list) if mode == "ridge" else valley_kernels(size, flat_list)
    n_flats = len(flat_list)
    ky_max, kx_max = rotated_extent(size, np.arange(n_angles))
    kmax = max(ky_max, kx_max)
    h, w = dem.shape

    q_angles, slot_angle, slot_valid = quadrant_schedule(n_angles)
    qparams = np.stack([rotation_params(size, float(q), kmax, kmax) for q in q_angles])
    q_batch = max(1, min(int(q_batch), len(q_angles)))
    if pad := (-len(q_angles)) % q_batch:
        # pad with all-invalid slots so every step holds q_batch angles
        qparams = np.concatenate([qparams, np.repeat(qparams[:1], pad, 0)])
        slot_angle = np.concatenate([slot_angle, np.zeros((pad, 4), np.float32)])
        slot_valid = np.concatenate([slot_valid, np.zeros((pad, 4), bool)])

    conv = conv_method
    if conv == "auto":
        conv = "mm" if prefer_dft_matmul(h, w, kmax, kmax) else "fft"
    if conv == "mm":
        plan = get_plan(h, w, kmax, kmax, "same", dem.device)
        fdr, fdi = field_spectrum(dem, plan)

        def conv_fn(kernels):
            return conv_bank(kernels, fdr, fdi, plan)
    elif conv == "fft":
        conv_fn = _fft_conv_fn(dem, kmax)
    else:
        raise ValueError(f"unknown conv_method {conv_method!r}: expected auto, mm or fft")

    def table():
        return build_rotation_table(prefilter2d_o2(upload(base.astype(np.float32), dem.device)))

    stack_bytes = qparams.shape[0] * n_flats * kmax * kmax * 4
    if stack_bytes <= CFG.valley_canvas_cache_bytes:
        ckey = (size, mode, tuple(float(f) for f in flat_list), n_angles, n_flats,
                q_batch, dem.device)
        canvases = _CANVAS_DEV_CACHE.get(ckey)
        if canvases is None:
            tab = table()
            canvases = torch.stack([_rotate_folded(tab, size, p, kmax) for p in qparams])
            _evict_to(_CANVAS_DEV_CACHE, 2)
            _CANVAS_DEV_CACHE[ckey] = canvases
        canvas_of = canvases.__getitem__
    else:
        tab = table()

        def canvas_of(q):
            return _rotate_folded(tab, size, qparams[q], kmax)

    norm, direction = _streamed_scan(canvas_of, conv_fn, qparams, slot_angle, slot_valid,
                                     q_batch, n_flats, (h, w), dem.device)
    return [torch.clamp(norm, min=0.0), direction]


def valley_ridge(
    dem,
    size: int,
    mode: str,
    flat_list: Sequence[float] = (0, 0.15, 0.3),
    sigma: Optional[float] = None,
    bank: Optional[np.ndarray] = None,
    method: str = "auto",
    stats: Optional[tuple] = None,
    angle_chunk: int = 30,
    device="cuda",
) -> List[torch.Tensor]:
    """Valley/ridge index norm and direction (0..179 deg, clockwise);
    counterpart of ``topo_descriptors_tpu.ops.valley_ridge``.

    Optional Gaussian pre-smooth, global standardization (or ``stats`` =
    (mean, std) given), then for each integer angle a rotated-kernel 3-D
    convolution, the max over the flat variants, and a running
    strictly-greater max/argmax across angles (ties keep the earliest
    angle). ``bank`` is an (A, F, KY, KX) numpy bank as
    :func:`prepare_valley_bank` builds it; ``method``:

    * ``'auto'`` — streamed when the bank exceeds
      ``CFG.valley_bank_max_bytes``, else ``'dftmm'``;
    * ``'dftmm'`` — pre-folded bank convolved by partial-DFT matmuls;
    * ``'direct'`` — the row-channel library convolution
      (:func:`~.conv.conv2d_bank_rowchan`), ``angle_chunk`` angles a step;
    * ``'fft'`` — ``torch.fft`` with the field transform hoisted;
    * ``'stream'`` — :func:`valley_ridge_streamed` (with a ``bank`` given,
      the JAX package runs ``'direct'`` on it, and so does this port).
    """
    if mode not in ("valley", "ridge"):
        raise ValueError(f"Unknown mode {mode!r}")
    if method not in METHODS:
        raise ValueError(f"unknown valley/ridge method {method!r}: expected one of {METHODS}")
    if bank is None and (
        method == "stream"
        or (method == "auto" and bank_nbytes(size, len(flat_list)) > CFG.valley_bank_max_bytes)
    ):
        return valley_ridge_streamed(dem, size, mode, flat_list, sigma, stats, device=device)

    dem = _standardized(as_field(dem, device), sigma, stats)
    if method in ("auto", "dftmm"):
        if bank is None:
            # canonical signature: cache the folded device bank and skip
            # the scipy rotations on a hit
            key = (size, mode, tuple(float(f) for f in flat_list))
            ky, kx = rotated_extent(size)
            return _valley_ridge_bank_mm(
                dem, None, angle_chunk, cache_key=key,
                bank_shape=(180, len(flat_list), ky, kx),
                builder=lambda: prepare_valley_bank(size, mode, flat_list),
            )
        return _valley_ridge_bank_mm(dem, bank, angle_chunk)

    if bank is None:
        bank = prepare_valley_bank(size, mode, flat_list)
    bank = np.asarray(bank, dtype=np.float32)
    a_angles, n_flats, ky, kx = bank.shape
    while a_angles % angle_chunk:
        angle_chunk -= 1
    n_chunks = a_angles // angle_chunk

    h, w = dem.shape
    if method == "fft":
        fh, fw = _fft_shape(h + ky - 1), _fft_shape(w + kx - 1)
        f_dem = torch.fft.rfft2(dem, s=(fh, fw))
        sh, sw = (ky - 1) // 2, (kx - 1) // 2

        def conv_chunk(kernels):  # (chunk*F, ky, kx) -> (chunk*F, H, W)
            fk = torch.fft.rfft2(kernels, s=(fh, fw))
            full = torch.fft.irfft2(f_dem[None] * fk, s=(fh, fw))
            return full[:, sh : sh + h, sw : sw + w]
    else:

        def conv_chunk(kernels):
            return conv2d_bank_rowchan(dem, kernels, padding="same")

    def conv_combined(kernels):
        convs = conv_chunk(kernels).reshape(-1, n_flats, h, w)
        return _flat_axis_combine(convs, axis=1).amax(dim=1)

    bank_chunks = upload(bank.reshape(n_chunks, angle_chunk * n_flats, ky, kx), dem.device)
    return _scan_chunks(bank_chunks, n_flats, (h, w), conv_combined)
