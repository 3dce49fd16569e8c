"""Sx horizon scan: the CUDA kernel's wrapper and its plain PyTorch twin.

Replaces ``topo_descriptors_tpu/ops/pallas/sx_block.py::_sx_kernel`` with
the epilogue ``sx_pallas`` runs after it. The CUDA kernels are in
``csrc/sx_block.cu``; its header says what bounds them on the H100 (load
instructions: K ray reads per pixel) and what the two routes do about
that: ``"tile"`` stages the halo its rays reach in shared memory,
``"global"`` (halos that do not fit) reads through L1/L2. :func:`route`
chooses between them from the halo's bytes and the shared-memory limit
alone. :func:`sx_block_plain` is the same function in plain PyTorch — the
transcription of the XLA scan in ``topo_descriptors_tpu/ops/sx.py``: a
NaN-padded DEM and one ``torch.fmax`` pass per ray offset.

:func:`sx_block` routes by the tensor: CPU tensors take the plain twin,
CUDA tensors the kernel, anything else raises. ``LAUNCHES`` counts the
kernel's launches and ``ROUTE_LAUNCHES`` splits them by route; ``TABLES``
keeps the ray tables on their device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from topo_descriptors_tpu_torch.device import TableCache, on_cuda, upload
from topo_descriptors_tpu_torch.ops.cuda import _build

LAUNCHES = 0
ROUTE_LAUNCHES = {"tile": 0, "global": 0}
TABLES = TableCache()

# csrc/sx_block.cu's output tile (kTileH x kTileW)
TILE_H, TILE_W = 32, 64


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


def halo_box(offsets) -> tuple:
    """``(min oy, max oy, min ox, max ox)`` of the (K, 2) ray offsets, from
    their signed values ((0, 0, 0, 0) for no rays)."""
    offs = np.asarray(offsets, np.int64).reshape(-1, 2)
    if not len(offs):
        return 0, 0, 0, 0
    (oy0, ox0), (oy1, ox1) = offs.min(axis=0), offs.max(axis=0)
    return int(oy0), int(oy1), int(ox0), int(ox1)


def tile_smem_bytes(box, n_rays: int, n_groups: int) -> int:
    """Dynamic shared memory of the tile route's block: the ray table
    (n_rays offsets, n_groups + 1 group pointers, n_groups reciprocal
    distances, padded to 16 bytes) and the output tile grown by the halo
    box."""
    oy0, oy1, ox0, ox1 = box
    table = -(-(n_rays + 2 * n_groups + 1) // 4) * 4
    return 4 * (table + (TILE_H + oy1 - oy0) * (TILE_W + ox1 - ox0))


def route(box, n_rays: int, n_groups: int) -> str:
    """``"tile"`` when the halo tile fits in shared memory, else
    ``"global"``; the grid's size plays no part."""
    return "tile" if tile_smem_bytes(box, n_rays, n_groups) <= _build.SMEM_PER_BLOCK else "global"


def device_tables(offsets, distances, border, device):
    """``(offsets, group_ptr, inv on device, n_rays, n_groups, halo box)``
    of :func:`ray_groups`, built and uploaded once per (offsets, distances,
    border, device) while it stays in ``TABLES``."""
    o = np.ascontiguousarray(offsets, np.int64)
    d = np.ascontiguousarray(distances, np.float64)
    key = (o.tobytes(), o.shape, d.tobytes(), int(border), torch.device(device))

    def build():
        offs, ptr, inv = ray_groups(offsets, distances)
        return (upload(offs, device), upload(ptr, device), upload(inv, device),
                len(offs), len(inv), halo_box(offs))

    return TABLES.get(key, build)


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
    offs_t, ptr_t, inv_t, n_rays, n_groups, box = device_tables(
        offsets, distances, border, dem.device)
    which = route(box, n_rays, n_groups)
    out = torch.empty((h, w), dtype=torch.float32, device=dem.device)
    lib = _build.library()
    with torch.cuda.device(dem.device):
        stream = torch.cuda.current_stream().cuda_stream
        if which == "tile":
            oy0, oy1, ox0, ox1 = box
            vec = int(dem.data_ptr() % 16 == 0 and w % 4 == 0)  # 16-byte row loads
            err = lib.sx_block_tile_forward(
                dem.data_ptr(), offs_t.data_ptr(), ptr_t.data_ptr(), inv_t.data_ptr(),
                n_rays, n_groups, out.data_ptr(), h, w, oy0, ox0, TILE_H + oy1 - oy0,
                TILE_W + ox1 - ox0, int(border), float(height), int(bool(zero_border)),
                tile_smem_bytes(box, n_rays, n_groups), vec, stream,
            )
        else:
            err = lib.sx_block_forward(
                dem.data_ptr(), offs_t.data_ptr(), ptr_t.data_ptr(), inv_t.data_ptr(),
                n_groups, out.data_ptr(), h, w, int(border), float(height),
                int(bool(zero_border)), stream,
            )
    _build.check(err, f"sx_block ({which})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[which] += 1
    return out
