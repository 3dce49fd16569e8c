"""Sx horizon scan: the CUDA kernel's wrapper and its plain PyTorch twin.

Replaces ``topo_descriptors_tpu/ops/pallas/sx_block.py::_sx_kernel`` with
the epilogue ``sx_pallas`` runs after it. The CUDA kernel is
``csrc/sx_block.cu``; its header says what bounds it on the H100 (bytes
and load instructions: K ray reads per pixel) and what its design does
about that. :func:`sx_block_plain` is the same function in plain PyTorch —
the transcription of the XLA scan in ``topo_descriptors_tpu/ops/sx.py``:
a NaN-padded DEM and one ``torch.fmax`` pass per ray offset.

:func:`sx_block` routes by the tensor: CPU tensors take the plain twin,
CUDA tensors the kernel, anything else raises. ``LAUNCHES`` counts the
kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from topo_descriptors_tpu_torch.device import on_cuda, upload
from topo_descriptors_tpu_torch.ops.cuda import _build

LAUNCHES = 0


def _inv_distances(distances) -> np.ndarray:
    # distance 0 (the even-window quirk) -> +inf, see topo_descriptors_tpu.ops.sx
    with np.errstate(divide="ignore"):
        return (1.0 / np.asarray(distances)).astype(np.float32)


def ray_groups(offsets, distances):
    """Rays grouped by identical 1/distance, as ``sx_pallas`` groups them.

    Returns ``(offsets (K', 2) int32 ordered by group, group_ptr (G+1,)
    int32, inv (G,) float32)``. Rays with a NaN distance (``radius_min``
    exclusions) are left out: their ratio is NaN, which fmax drops anyway.
    """
    inv = _inv_distances(distances)
    keep = ~np.isnan(inv)
    offs = np.asarray(offsets, np.int32).reshape(-1, 2)[keep]
    keys, group = np.unique(inv[keep], return_inverse=True)  # sorted 1/d
    order = np.argsort(group, kind="stable")  # table order within a group
    ptr = np.concatenate([[0], np.cumsum(np.bincount(group, minlength=len(keys)))])
    return offs[order], ptr.astype(np.int32), keys.astype(np.float32)


def _epilogue(max_ratio, border, zero_border):
    sx_deg = torch.rad2deg(torch.atan(max_ratio))
    # no valid candidate at all -> NaN, as the reference's np.nanmax
    sx_deg = torch.where(torch.isneginf(max_ratio), torch.nan, sx_deg)
    if not zero_border:
        return sx_deg
    h, w = max_ratio.shape
    yy = torch.arange(h, device=max_ratio.device)[:, None]
    xx = torch.arange(w, device=max_ratio.device)[None, :]
    interior = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    return torch.where(interior, sx_deg, 0.0)


def sx_block_plain(
    dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
    zero_border: bool = True,
) -> torch.Tensor:
    """Sx in degrees from a deduplicated ray table, one fmax pass per ray."""
    h, w = dem.shape
    pad = int(border)
    padded = F.pad(dem, (pad, pad, pad, pad), value=float("nan"))
    base = dem + torch.tensor(height, dtype=dem.dtype, device=dem.device)
    invs = upload(_inv_distances(distances), dem.device)
    max_ratio = torch.full((h, w), -torch.inf, dtype=dem.dtype, device=dem.device)
    for k, (oy, ox) in enumerate(np.asarray(offsets) + pad):
        shifted = padded[oy : oy + h, ox : ox + w]
        max_ratio = torch.fmax(max_ratio, (shifted - base) * invs[k])
    return _epilogue(max_ratio, pad, zero_border)


def check_dem(dem: torch.Tensor, kernel: str) -> None:
    """Raise unless ``dem`` is what the Sx kernels take: a contiguous
    float32 (H, W) tensor."""
    if dem.dtype != torch.float32 or dem.dim() != 2 or not dem.is_contiguous():
        raise ValueError(
            f"{kernel} needs a contiguous float32 (H, W) tensor, got "
            f"{dem.dtype} {tuple(dem.shape)} contiguous={dem.is_contiguous()}"
        )


def sx_block(
    dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
    zero_border: bool = True,
) -> torch.Tensor:
    """:func:`sx_block_plain` on a CPU tensor; the CUDA kernel on a CUDA
    tensor, which must be a contiguous float32 (H, W) DEM."""
    global LAUNCHES
    if not on_cuda(dem):
        return sx_block_plain(dem, offsets, distances, border, height, zero_border)
    check_dem(dem, "sx_block")
    h, w = dem.shape
    offs, ptr, inv = ray_groups(offsets, distances)
    offs_t = upload(offs, dem.device)
    ptr_t = upload(ptr, dem.device)
    inv_t = upload(inv, dem.device)
    out = torch.empty((h, w), dtype=torch.float32, device=dem.device)
    lib = _build.library()
    with torch.cuda.device(dem.device):
        err = lib.sx_block_forward(
            dem.data_ptr(), offs_t.data_ptr(), ptr_t.data_ptr(), inv_t.data_ptr(),
            len(inv), out.data_ptr(), h, w, int(border), float(height),
            int(bool(zero_border)), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sx_block")
    LAUNCHES += 1
    return out
