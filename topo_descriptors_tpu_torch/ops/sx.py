"""Sx (Winstral wind-shelter) horizon scan."""

from __future__ import annotations

import numpy as np
import torch

from topo_descriptors_tpu_torch.device import as_field, on_cuda
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
    tensor); ``'xla'`` runs the plain twin on any device.
    """
    if method not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown Sx method {method!r}: expected auto, pallas or xla")
    dem = as_field(dem, device)
    offsets, distances = sx_dedupe(offsets, distances)
    run = sx_block.sx_block_plain if method == "xla" else sx_block.sx_block
    return run(dem, offsets, distances, border, height, zero_border)


SWEEP_METHODS = ("auto", "pallas_fan", "pallas_sweep", "pallas", "xla")


def _sweep_auto_method(dem: torch.Tensor) -> str:
    """Backend for :func:`sx_sweep` when ``method='auto'``.

    A CPU tensor takes the plain twin (``'xla'``). A CUDA tensor takes the
    faster of the two whole-fan kernels, never the twin: the JAX rule
    (``topo_descriptors_tpu.ops.sx._sweep_auto_method``) weighs Mosaic
    compile costs, which the CUDA build does not have.

    That is ``sx_sweep`` (``'pallas_sweep'``). On the 36-azimuth sweep of
    the 900 x 1440 grid (BASELINE.json configs[3]), kernel device time
    from torch.profiler on an NVIDIA H100 80GB HBM3 at a 700.00 W power
    limit: 1.03 ms at r = 200 m and 31.58 ms at r = 2000 m for
    ``sx_sweep``, against 0.95 ms and 34.35 ms for ``sx_fan``. Their sum,
    32.61 against 35.30 ms, decides. A sweep block reads one azimuth's
    wedge of the halo; a fan block reads the whole disc for every azimuth,
    which costs L1 hits at the 67-pixel border of r = 2000 m. At 8192 x
    8192 and r = 500 m ``sx_fan`` leads by 2% (192.3 against 196.6 ms).
    """
    return "pallas_sweep" if on_cuda(dem) else "xla"


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
    per-azimuth deduplication (``sx_sweep_dedupe``) runs first. Plane ``a``
    equals :func:`sx` on azimuth ``a``'s table.

    ``method`` keeps the JAX names: ``'pallas_sweep'`` runs the kernel with
    one thread per (pixel, azimuth), ``'pallas_fan'`` the kernel with one
    thread per pixel looping over the azimuths, ``'pallas'`` ``sx_block``
    per azimuth, stacked, and ``'xla'`` the plain twin on any device. Each
    kernel route takes its plain twin on a CPU tensor. ``'auto'``: see
    :func:`_sweep_auto_method`.
    """
    if method not in SWEEP_METHODS:
        raise ValueError(
            f"unknown Sx sweep method {method!r}: expected one of {SWEEP_METHODS}"
        )
    dem = as_field(dem, device)
    offsets, distances = sx_sweep_dedupe(offsets, distances)
    if method == "auto":
        method = _sweep_auto_method(dem)
    if method == "pallas":
        return torch.stack([
            sx_block.sx_block(dem, *_strip_pad_rows(o, d), border, height, zero_border)
            for o, d in zip(offsets, distances)
        ])
    run = {
        "pallas_sweep": cuda_sweep.sx_sweep,
        "pallas_fan": cuda_sweep.sx_fan,
        "xla": cuda_sweep.sx_sweep_plain,
    }[method]
    return run(dem, offsets, distances, border, height, zero_border)
