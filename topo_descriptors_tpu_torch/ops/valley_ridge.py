"""Valley / ridge index over 180 rotated V/U-kernel orientations.

Counterpart of ``topo_descriptors_tpu/ops/valley_ridge.py``. Each of the
JAX package's ``lax.scan`` loops over angle chunks or quadrant steps is a
Python loop here that carries ``(norm, direction)`` on the device. The
convolutions are the partial-DFT matmuls of :mod:`.dft_conv`, library
convolutions or ``torch.fft``, all in full float32; none of them is a
hand kernel (the JAX package keeps them outside any Pallas kernel too).
"""

from __future__ import annotations

import contextlib
from time import perf_counter
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
    rotation_params64,
)
from topo_descriptors_tpu_torch.utils.timing import span

METHODS = ("auto", "dftmm", "direct", "fft", "stream")

# What the routes did: the single-device op's calls by route ("calls.bank":
# a precomputed bank, "calls.streamed"), the streamed calls by convolution
# route ("conv.mm", "conv.fft"), the device banks and canvas stacks made (on
# a cache miss, or in every call that caches none), the quadrant-angle
# canvases rotated (into a cached stack or inline), and the host seconds of
# the bank builds (issuing the device rotations and flat fold, or staging a
# bank given; no device sync).
VALLEY_COUNTS = {"calls.bank": 0, "calls.streamed": 0, "conv.mm": 0, "conv.fft": 0,
                 "builds.bank": 0, "builds.canvas": 0, "rotations.canvas": 0,
                 "bank_build_s": 0.0}


def bank_nbytes(size: int, n_flats: int, n_angles: int = 180) -> int:
    """float32 size of the full padded rotation bank, computed without
    building it. Above ``CFG.valley_bank_max_bytes`` (the reference's 20-100
    km example scales reach 1.8-48 GB) :func:`valley_ridge` streams."""
    ky, kx = rotated_extent(size)
    return n_angles * n_flats * ky * kx * 4


def bank_fits(size: int, n_flats: int) -> bool:
    """Whether a (size, n_flats) valley/ridge call convolves a precomputed
    rotation bank (within ``CFG.valley_bank_max_bytes``) or streams its
    rotations: the one route decision of :func:`valley_ridge`,
    ``TiledRunner.valley_ridge`` and ``ShardedOps.valley_ridge``."""
    return bank_nbytes(size, n_flats) <= CFG.valley_bank_max_bytes


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


def _rotation_table(size: int, mode: str, flat_list: Sequence[float], device) -> torch.Tensor:
    """The base V/U stack, spline-prefiltered on ``device`` and packed into
    the gather table (:func:`~.spline_rotate.build_rotation_table`)."""
    base = ridge_kernels(size, flat_list) if mode == "ridge" else valley_kernels(size, flat_list)
    return build_rotation_table(prefilter2d_o2(upload(base.astype(np.float32), device)))


def device_valley_bank(size: int, mode: str, flat_list: Sequence[float], device) -> torch.Tensor:
    """:func:`prepare_valley_bank`'s (180, F, KY, KX) float32 bank, rotated
    on ``device``: the streamed route's prefilter, gather, weights and
    re-standardisation at scipy's float64 coordinates
    (:func:`~.spline_rotate.rotation_params64`), all 180 angles directly,
    as many a step as keep the gather under ``CFG.valley_chunk_bytes``."""
    ky_max, kx_max = rotated_extent(size)
    table = _rotation_table(size, mode, flat_list, device)
    params = rotation_params64(size, np.arange(180), ky_max, kx_max)
    step = max(1, CFG.valley_chunk_bytes // (ky_max * kx_max * table.shape[1] * 4))
    return torch.cat([rotate_std_canvas_table(table, size, params[i : i + step], (ky_max, kx_max))
                      for i in range(0, len(params), step)])


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


def _fold_flats(bank: torch.Tensor) -> torch.Tensor:
    """:func:`_flat_axis_combine` over axis 1 of an (A, F, KY, KX) device
    bank, in float64 (fold into the kernels for the bank route)."""
    return _flat_axis_combine(bank.double(), 1).float()


def _given_bank(bank, device) -> torch.Tensor:
    """A ``bank`` passed to :func:`valley_ridge`, a host array or a tensor,
    as float32 on ``device``."""
    if isinstance(bank, torch.Tensor):
        return bank.to(device, torch.float32)
    return upload(np.asarray(bank, dtype=np.float32), device)


def _standardized(dem: torch.Tensor, sigma, stats) -> torch.Tensor:
    """The optionally pre-smoothed field, standardized, as float32.

    Computed in float64: at the 60-100 km scales' sigmas (287-479 px) the
    smoothed Basodino field spreads by only ~14-58 m about ~1800 m, so
    float32's rounding of the elevations is ~1e-5 of the spread, which
    moved the 100 km norms by ~5e-5 of their largest value, as far as a
    TF32 computation moves them."""
    with span("valley.field"):
        field = dem.double()
        if sigma:
            field = gaussian_filter(field, sigma)
        if stats is None:
            # the population std (ddof=0), as jnp.std
            field = (field - field.mean()) / field.std(correction=0)
        else:
            field = (field - stats[0]) / stats[1]  # out-of-core: global, precomputed
        return field.float()


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
    with span("valley.scan"):
        for i, kernels in enumerate(bank_chunks):
            combined = conv_combined(kernels)
            chunk_best = combined.amax(dim=0)
            chunk_arg = combined.argmax(dim=0).to(norm.dtype)
            greater = chunk_best > norm
            norm = torch.where(greater, chunk_best, norm)
            direction = torch.where(greater, i * chunk + chunk_arg, direction)
    return [torch.clamp(norm, min=0.0), direction]


@contextlib.contextmanager
def _bank_build():
    """The ``valley.bank`` span around a bank's build and staging, counted
    as one build with its host seconds."""
    t0 = perf_counter()
    with span("valley.bank"):
        yield
    VALLEY_COUNTS["builds.bank"] += 1
    VALLEY_COUNTS["bank_build_s"] += perf_counter() - t0


_BANK_DEV_CACHE: dict = {}


def _valley_ridge_bank_mm(dem, bank, angle_chunk, signature=None):
    """Precomputed-bank valley/ridge through partial-DFT matmuls.

    Without a ``bank``, the op's own bank of the canonical ``signature``
    (size, mode, flat_list) is rotated on the device
    (:func:`device_valley_bank`) and kept folded and chunked there across
    calls, keyed on the device too. A ``bank`` given is folded on the
    device in every call."""
    h, w = dem.shape
    if bank is None:
        size, mode, flats = signature
        a_angles, n_flats, (ky, kx) = 180, len(flats), rotated_extent(size)
    else:
        a_angles, n_flats, ky, kx = bank.shape
    plan = get_plan(h, w, ky, kx, "same", dem.device)
    # bound the (chunk*F, fh, nb) spectral transients by the chunk budget
    per_angle = plan.fh * plan.nb * 8 * n_flats
    chunk = int(max(1, min(angle_chunk, CFG.valley_chunk_bytes // per_angle)))
    while a_angles % chunk:
        chunk -= 1
    key = signature + (chunk, dem.device) if bank is None else None
    bank_dev = _BANK_DEV_CACHE.get(key) if key is not None else None
    if bank_dev is None:
        with _bank_build():
            if bank is None:
                bank = device_valley_bank(size, mode, flats, dem.device)
            folded = _fold_flats(_given_bank(bank, dem.device))
            bank_dev = folded.reshape(a_angles // chunk, chunk * n_flats, ky, kx)
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
    (F, kmax, kmax) canvas; ``params`` is its float64 row of
    :func:`~.spline_rotate.rotation_params64`."""
    VALLEY_COUNTS["rotations.canvas"] += 1
    canvas = rotate_std_canvas_table(table, n, params[None], (kmax, kmax))[0]
    return _flat_axis_combine(canvas, 0)


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
    with span("valley.scan"):
        for step in range(n_steps):
            qs = range(step * q_batch, (step + 1) * q_batch)
            kern = torch.cat([torch.cat(canvas_variants(canvas_of(q), qparams[q]), 0)
                              for q in qs], 0)
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
    VALLEY_COUNTS["calls.streamed"] += 1
    dem = _standardized(as_field(dem, device), sigma, stats)
    n_flats = len(flat_list)
    kmax, qparams, slot_angle, slot_valid, q_batch = streamed_schedule(size, n_angles, q_batch)
    h, w = dem.shape

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
    VALLEY_COUNTS[f"conv.{conv}"] += 1

    canvas_of = quadrant_canvases(size, mode, flat_list, n_angles, q_batch, qparams, kmax,
                                  dem.device)
    norm, direction = _streamed_scan(canvas_of, conv_fn, qparams, slot_angle, slot_valid,
                                     q_batch, n_flats, (h, w), dem.device)
    return [torch.clamp(norm, min=0.0), direction]


def streamed_schedule(size: int, n_angles: int = 180, q_batch: int = 4):
    """``(kmax, qparams, slot_angle, slot_valid, q_batch)`` of the streamed
    route: the rotated extent's square canvas side, one float64
    rotation-parameter row per quadrant angle (scipy's own coordinates,
    :func:`~.spline_rotate.rotation_params64`), each angle's four slots,
    and the schedule padded with all-invalid slots so that every step holds
    ``q_batch`` angles."""
    ky_max, kx_max = rotated_extent(size, np.arange(n_angles))
    kmax = max(ky_max, kx_max)
    q_angles, slot_angle, slot_valid = quadrant_schedule(n_angles)
    qparams = rotation_params64(size, q_angles.astype(np.float64), kmax, kmax)
    q_batch = max(1, min(int(q_batch), len(q_angles)))
    if pad := (-len(q_angles)) % q_batch:
        qparams = np.concatenate([qparams, np.repeat(qparams[:1], pad, 0)])
        slot_angle = np.concatenate([slot_angle, np.zeros((pad, 4), np.float32)])
        slot_valid = np.concatenate([slot_valid, np.zeros((pad, 4), bool)])
    return kmax, qparams, slot_angle, slot_valid, q_batch


def quadrant_canvases(size, mode, flat_list, n_angles, q_batch, qparams, kmax, device) -> Callable:
    """``canvas_of(q)``: quadrant angle ``q``'s rotated, folded canvas on
    ``device``. The stack is cached per (size, mode, flats, device) while
    it fits ``CFG.valley_canvas_cache_bytes`` (2 stacks at most); larger
    stacks are rotated inline, step by step."""
    n_flats = len(flat_list)
    if qparams.shape[0] * n_flats * kmax * kmax * 4 <= CFG.valley_canvas_cache_bytes:
        ckey = (size, mode, tuple(float(f) for f in flat_list), n_angles, n_flats, q_batch,
                torch.device(device))
        canvases = _CANVAS_DEV_CACHE.get(ckey)
        if canvases is None:
            VALLEY_COUNTS["builds.canvas"] += 1
            with span("valley.canvas"):
                tab = _rotation_table(size, mode, flat_list, device)
                canvases = torch.stack([_rotate_folded(tab, size, p, kmax) for p in qparams])
            _evict_to(_CANVAS_DEV_CACHE, 2)
            _CANVAS_DEV_CACHE[ckey] = canvases
        return canvases.__getitem__
    VALLEY_COUNTS["builds.canvas"] += 1
    with span("valley.canvas"):
        tab = _rotation_table(size, mode, flat_list, device)

    def canvas_of(q):
        with span("valley.canvas"):
            return _rotate_folded(tab, size, qparams[q], kmax)

    return canvas_of


def valley_ridge(
    dem,
    size: int,
    mode: str,
    flat_list: Sequence[float] = (0, 0.15, 0.3),
    sigma: Optional[float] = None,
    bank=None,
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
    angle). ``bank`` is an (A, F, KY, KX) bank, a tensor as
    :func:`device_valley_bank` builds it or a host array as
    :func:`prepare_valley_bank` does (the JAX package's exchange format),
    used as given; without one the bank routes rotate theirs on the device;
    ``method``:

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
        method == "stream" or (method == "auto" and not bank_fits(size, len(flat_list)))
    ):
        return valley_ridge_streamed(dem, size, mode, flat_list, sigma, stats, device=device)

    VALLEY_COUNTS["calls.bank"] += 1
    dem = _standardized(as_field(dem, device), sigma, stats)
    if method in ("auto", "dftmm"):
        signature = (size, mode, tuple(float(f) for f in flat_list))
        return _valley_ridge_bank_mm(dem, bank, angle_chunk, signature)

    with _bank_build():
        if bank is None:
            bank_dev = device_valley_bank(size, mode, flat_list, dem.device)
        else:
            bank_dev = _given_bank(bank, dem.device)
        a_angles, n_flats, ky, kx = bank_dev.shape
        while a_angles % angle_chunk:
            angle_chunk -= 1
        bank_chunks = bank_dev.reshape(a_angles // angle_chunk, angle_chunk * n_flats, ky, kx)

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

    return _scan_chunks(bank_chunks, n_flats, (h, w), conv_combined)
