"""Sx (Winstral wind-shelter) horizon scan."""

from __future__ import annotations

import numpy as np
import torch

from topo_descriptors_tpu_torch.device import TableCache, as_field, on_cuda
from topo_descriptors_tpu_torch.kernels.sx_geometry import sx_dedupe, sx_sweep_dedupe
from topo_descriptors_tpu_torch.ops.cuda import sx_block, sx_sweep as cuda_sweep


def sx(
    dem,
    offsets: np.ndarray,
    distances: np.ndarray,
    border: int,
    height: float = 10.0,
    method: str = "auto",
    zero_border: bool = True,
    device="cuda",
) -> torch.Tensor:
    """Maximum elevation angle (degrees) along the azimuth fan's ray pixels;
    counterpart of ``topo_descriptors_tpu.ops.sx``.

    For every pixel, ``atan(max_k (dem[p + o_k] - dem[p] - height) / d_k)``
    over the ray table from ``kernels.sx_offsets``, NaN-ignoring; a border
    of width ``border`` stays 0 when ``zero_border``. ``atan`` is monotonic,
    so it runs once, after the max. Quirks kept from the reference: NaN
    distances (``radius_min``) drop their candidates, and the distance-0
    pixel of even windows gives +-90 degrees through ``1/0 = inf`` (its
    ``0 * inf`` NaN is dropped). The exact deduplication
    (``kernels.sx_dedupe``) runs first.

    ``method`` keeps the JAX names: ``'auto'`` and ``'pallas'`` run
    ``sx_block`` (the CUDA kernel on a CUDA tensor, its plain twin on a CPU
    tensor); ``'xla'`` runs the plain twin on any device. The kernel stages
    the halo its rays reach in shared memory (route ``tile``), or, where
    that box exceeds one block's shared memory (10 km at an oblique
    azimuth, 20 km at any), streams the rays through two stages one
    distance band at a time (route ``chunked``); both give the same bits.
    """
    if method not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown Sx method {method!r}: expected auto, pallas or xla")
    dem = as_field(dem, device)
    offsets, distances = sx_dedupe(offsets, distances)
    run = sx_block.sx_block_plain if method == "xla" else sx_block.sx_block
    return run(dem, offsets, distances, border, height, zero_border)


SWEEP_METHODS = ("auto", "pallas_fan", "pallas_sweep", "pallas", "xla")
DEDUPED = TableCache()  # sx_sweep_dedupe's tables, read-only, by the tables' contents


def _sweep_deduped(offsets, distances):
    """:func:`sx_sweep_dedupe` of a padded fan, computed once per table
    while it stays in ``DEDUPED``."""
    o, d = np.ascontiguousarray(offsets), np.ascontiguousarray(distances)
    key = (o.tobytes(), o.shape, o.dtype.str, d.tobytes(), d.shape, d.dtype.str)

    def build():
        tables = sx_sweep_dedupe(o, d)
        for t in tables:
            t.setflags(write=False)
        return tables

    return DEDUPED.get(key, build)


def _sweep_auto_method(dem: torch.Tensor, offsets, distances, border: int,
                       zero_border: bool = True) -> str:
    """Backend for :func:`sx_sweep` when ``method='auto'``, for a
    deduplicated fan on ``dem``'s grid.

    A CPU tensor takes the plain twin (``'xla'``). A CUDA tensor takes the
    faster of the two whole-fan kernels, never the twin: the JAX rule
    (``topo_descriptors_tpu.ops.sx._sweep_auto_method``) weighs Mosaic
    compile costs, which the CUDA build does not have.

    That is ``sx_sweep`` (``'pallas_sweep'``) where its boxes exceed one
    block's shared memory and the grid leaves SMs idle: its busy tiles
    (:func:`sx_block.busy_tiles`) times the fan's azimuths make fewer
    blocks than the most per SM of ``sx_block.CHUNK_STAGES`` times the
    card's SMs (one to three azimuths at 10 km on 900 x 1440, whose 104
    busy tiles meet 132 SMs). There both kernels run the one chunked block
    loop, ``sx_fan`` one block per (tile, azimuth), ``sx_sweep`` on its
    split plan, which can cut an azimuth's distance bands over several
    blocks. ``chip_smoke.py`` phase 5 on an NVIDIA H100 80GB HBM3 at a
    700.00 W power limit (CUDA events, median of 20), 10 km on 900 x 1440,
    ``sx_fan`` against ``sx_sweep`` on the plan its model picked (not a
    forced one): 1.1680 against 0.9297 ms on azimuths 0 and 45 (S = 7
    items per azimuth); 12.6364 against 12.3972 ms on 36 azimuths, where
    the grid is busy and the plan has S = 1, the fan's loop.

    Everywhere else ``sx_fan`` (``'pallas_fan'``). Both kernels run their
    shared-memory tile route on the 36-azimuth fans up to 2000 m;
    ``chip_smoke.py``'s times on the same card and limit, ``sx_fan``
    against ``sx_sweep``: 0.2620 against 0.3245 ms at 900 x 1440 and r =
    200 m, 5.2242 against 5.1324 ms at r = 2000 m (BASELINE.json
    configs[3]), 24.4394 against 30.3623 ms at 8192 x 8192 and r = 500 m;
    29.93 against 35.82 ms summed. A fan block stages its group's box and
    reads each output's DEM value once for all its azimuths, where a sweep
    block does both for one azimuth; that per-block work counts at the
    short radii and is lost in the ray loop at 2000 m. The per-azimuth
    ``sx_block`` loop (``'pallas'``) took 4.9438, 10.1693 and 46.2821 ms on
    the same run.
    """
    if not on_cuda(dem):
        return "xla"
    n_sms = torch.cuda.get_device_properties(dem.device).multi_processor_count
    blocks = sx_block.busy_tiles(dem.shape, border, zero_border) * len(offsets)
    if blocks < max(sx_block.CHUNK_STAGES) * n_sms:
        t = cuda_sweep.device_tables(offsets, distances, border, dem.device)
        if cuda_sweep.route(t.sweep_smem) == "chunked":
            return "pallas_sweep"
    return "pallas_fan"


def _strip_pad_rows(offsets: np.ndarray, distances: np.ndarray):
    """One azimuth's rows without the trailing pad rows (zero offset, NaN
    distance); genuine ``radius_min`` NaNs sit mid-table and never have a
    (0, 0) offset, as in ``topo_descriptors_tpu.ops.sx.sx_sweep``."""
    k = len(distances)
    while k > 0 and np.isnan(distances[k - 1]) and not offsets[k - 1].any():
        k -= 1
    return offsets[:k], distances[:k]


def sx_sweep(
    dem,
    offsets: np.ndarray,
    distances: np.ndarray,
    border: int,
    height: float = 10.0,
    method: str = "auto",
    zero_border: bool = True,
    device="cuda",
) -> torch.Tensor:
    """Sx for a whole fan of azimuths -> (A, H, W); counterpart of
    ``topo_descriptors_tpu.ops.sx_sweep``.

    ``offsets`` is (A, Kmax, 2) int32 and ``distances`` (A, Kmax), padded
    with zero offsets and NaN distances, as
    ``kernels.sx_geometry.sx_sweep_offsets`` builds them; the exact
    per-azimuth deduplication (``sx_sweep_dedupe``, cached per table) runs
    first. Plane ``a`` equals :func:`sx` on azimuth ``a``'s table.

    ``method`` keeps the JAX names: ``'pallas_sweep'`` runs the kernel with
    one azimuth per block (on its chunked route, one work item of its split
    plan), ``'pallas_fan'`` the kernel with one group of
    azimuths per block, ``'pallas'`` ``sx_block`` per azimuth, each plane
    written into one preallocated output, and ``'xla'`` the plain twin on
    any device. Each kernel route takes its plain twin on a CPU tensor.
    ``'auto'``: see :func:`_sweep_auto_method`.
    """
    if method not in SWEEP_METHODS:
        raise ValueError(
            f"unknown Sx sweep method {method!r}: expected one of {SWEEP_METHODS}"
        )
    dem = as_field(dem, device)
    offsets, distances = _sweep_deduped(offsets, distances)
    if method == "auto":
        method = _sweep_auto_method(dem, offsets, distances, border, zero_border)
    if method == "pallas":  # each plane written into one (A, H, W) output
        out = torch.empty((len(offsets),) + tuple(dem.shape), dtype=dem.dtype, device=dem.device)
        for a, (o, d) in enumerate(zip(offsets, distances)):
            out[a] = sx_block.sx_block(dem, *_strip_pad_rows(o, d), border, height, zero_border)
        return out
    run = {
        "pallas_sweep": cuda_sweep.sx_sweep,
        "pallas_fan": cuda_sweep.sx_fan,
        "xla": cuda_sweep.sx_sweep_plain,
    }[method]
    return run(dem, offsets, distances, border, height, zero_border)
