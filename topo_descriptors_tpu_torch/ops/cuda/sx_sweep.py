"""Sx for a whole fan of azimuths: the two CUDA kernels' wrappers and their
shared plain PyTorch twin.

:func:`sx_sweep` replaces ``topo_descriptors_tpu/ops/pallas/sx_block.py::
_sx_sweep_kernel`` and :func:`sx_fan` replaces ``_sx_fan_kernel``, each
with the epilogue its ``sx_*_pallas`` entry point runs after it. Both CUDA
kernels are in ``csrc/sx_sweep.cu``, whose header says what bounds them on
the H100 and how the two designs differ. They compute the same (A, H, W)
function, so they share one plain twin, :func:`sx_sweep_plain`: the
transcription of the XLA branch of ``topo_descriptors_tpu/ops/sx.py::
sx_sweep`` (a NaN-padded DEM and one ``torch.fmax`` pass per ray for each
azimuth, then the atan epilogue per plane).

The tables come from :func:`sweep_tables`: each azimuth's rays grouped by
:func:`sx_block.ray_groups`, exactly as ``sx_block`` groups that azimuth
alone, so the three kernels run the same per-pixel arithmetic and their
planes agree bit for bit.

Each wrapper routes by the tensor: CPU tensors take the plain twin, CUDA
tensors the kernel, anything else raises. ``LAUNCHES`` counts each
kernel's launches by name.
"""

from __future__ import annotations

import numpy as np
import torch

from topo_descriptors_tpu_torch.device import on_cuda, upload
from topo_descriptors_tpu_torch.ops.cuda import _build, sx_block

LAUNCHES = {"sx_sweep": 0, "sx_fan": 0}


def sweep_tables(offsets, distances):
    """Flat runtime tables of a padded (A, Kmax, 2) / (A, Kmax) fan.

    Returns ``(offsets (K', 2) int32, group_ptr (G+1,) int32, inv (G,)
    float32, az_ptr (A+1,) int32)``: azimuth ``a`` owns groups ``az_ptr[a]
    .. az_ptr[a+1]-1``, in the order :func:`sx_block.ray_groups` gives for
    that azimuth's rows. Rows with a NaN distance (the table's pad rows and
    ``radius_min`` exclusions) are left out; an azimuth with no real ray
    owns no group. A distance of 0 keeps ``inv = +inf``.
    """
    parts = [sx_block.ray_groups(o, d) for o, d in zip(np.asarray(offsets),
                                                       np.asarray(distances))]
    group_ptr, az_ptr, n_rays = [np.zeros(1, np.int64)], [0], 0
    for offs, ptr, inv in parts:
        group_ptr.append(ptr[1:].astype(np.int64) + n_rays)
        n_rays += int(ptr[-1])
        az_ptr.append(az_ptr[-1] + len(inv))
    return (
        np.concatenate([p[0] for p in parts] + [np.zeros((0, 2), np.int32)]),
        np.concatenate(group_ptr).astype(np.int32),
        np.concatenate([p[2] for p in parts] + [np.zeros(0, np.float32)]),
        np.asarray(az_ptr, np.int32),
    )


def sx_sweep_plain(
    dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
    zero_border: bool = True,
) -> torch.Tensor:
    """Sx in degrees for each azimuth of a padded fan table -> (A, H, W):
    :func:`sx_block.sx_block_plain` on each azimuth's rows, pad rows
    included (their NaN ratios are dropped by the fmax)."""
    offsets, distances = np.asarray(offsets), np.asarray(distances)
    out = torch.empty((len(offsets),) + tuple(dem.shape), dtype=dem.dtype,
                      device=dem.device)
    for a, (o, d) in enumerate(zip(offsets, distances)):
        out[a] = sx_block.sx_block_plain(dem, o, d, border, height, zero_border)
    return out


def _launch(entry: str, dem, offsets, distances, border, height, zero_border):
    sx_block.check_dem(dem, entry)
    h, w = dem.shape
    offs, group_ptr, inv, az_ptr = sweep_tables(offsets, distances)
    tables = [upload(t, dem.device) for t in (offs, group_ptr, inv, az_ptr)]
    n_az = len(az_ptr) - 1
    out = torch.empty((n_az, h, w), dtype=torch.float32, device=dem.device)
    lib = _build.library()
    with torch.cuda.device(dem.device):
        err = getattr(lib, f"{entry}_forward")(
            dem.data_ptr(), *(t.data_ptr() for t in tables), n_az,
            out.data_ptr(), h, w, int(border), float(height),
            int(bool(zero_border)), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, entry)
    LAUNCHES[entry] += 1
    return out


def sx_sweep(
    dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
    zero_border: bool = True,
) -> torch.Tensor:
    """:func:`sx_sweep_plain` on a CPU tensor; on a CUDA tensor, which must
    be a contiguous float32 (H, W) DEM, the kernel with one thread per
    (pixel, azimuth)."""
    if not on_cuda(dem):
        return sx_sweep_plain(dem, offsets, distances, border, height, zero_border)
    return _launch("sx_sweep", dem, offsets, distances, border, height, zero_border)


def sx_fan(
    dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
    zero_border: bool = True,
) -> torch.Tensor:
    """:func:`sx_sweep_plain` on a CPU tensor; on a CUDA tensor, which must
    be a contiguous float32 (H, W) DEM, the kernel with one thread per
    pixel looping over the azimuths."""
    if not on_cuda(dem):
        return sx_sweep_plain(dem, offsets, distances, border, height, zero_border)
    return _launch("sx_fan", dem, offsets, distances, border, height, zero_border)
