"""Sx for a whole fan of azimuths: the two CUDA kernels' wrappers and their
shared plain PyTorch twin.

:func:`sx_sweep` replaces ``topo_descriptors_tpu/ops/pallas/sx_block.py::
_sx_sweep_kernel`` and :func:`sx_fan` replaces ``_sx_fan_kernel``, each
with the epilogue its ``sx_*_pallas`` entry point runs after it. Both CUDA
kernels are in ``csrc/sx_sweep.cu``, whose header says what bounds them on
the H100 and what their two routes do about it: ``"tile"`` stages the DEM
the rays reach in shared memory (the sweep one azimuth's wedge per block,
the fan the union box of a group of azimuths per block); for boxes above
227 KB the ``"chunked"`` route, one kernel for both, streams each
azimuth's rays through two shared-memory stages, one distance band at a
time, from :func:`sx_block.chunk_plan`: the fan one azimuth per block, the
sweep one work item of :func:`sx_block.split_plan` per block, so that on a
grid that leaves SMs idle several blocks share an azimuth's tile and a
second kernel folds their maxima. :func:`route` chooses from the
shared-memory bytes alone. They compute the same (A, H, W)
function, so they share one plain twin, :func:`sx_sweep_plain`: the
transcription of the XLA branch of ``topo_descriptors_tpu/ops/sx.py::
sx_sweep`` (a NaN-padded DEM and one ``torch.fmax`` pass per ray for each
azimuth, then the atan epilogue per plane).

The tables come from :func:`sweep_tables`: each azimuth's rays grouped by
:func:`sx_block.ray_groups`, exactly as ``sx_block`` groups that azimuth
alone, so the three kernels run the same per-pixel arithmetic and their
planes agree bit for bit. :func:`device_tables` adds the boxes and the
fan's azimuth groups and keeps all of it on the device in ``TABLES``.

Each wrapper routes by the tensor: CPU tensors take the plain twin, CUDA
tensors the kernel, anything else raises. ``LAUNCHES`` counts each
kernel's launches by name, ``ROUTE_LAUNCHES`` by name and route.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from topo_descriptors_tpu_torch.device import TableCache, on_cuda, upload
from topo_descriptors_tpu_torch.ops.cuda import _build, sx_block
from topo_descriptors_tpu_torch.ops.cuda.sx_block import TILE_H, TILE_W

LAUNCHES = {"sx_sweep": 0, "sx_fan": 0}
ROUTE_LAUNCHES = {"sx_sweep": {"tile": 0, "chunked": 0}, "sx_fan": {"tile": 0, "chunked": 0}}
TABLES = TableCache()

# the most shared memory one block of the fan's tile route may take (its
# group's staged tile and two table buffers): four blocks then fit on an SM,
# as the kernels' 64 registers allow, each with the 1 KB the hardware
# reserves per block
FAN_SMEM_BUDGET = _build.SMEM_PER_SM // 4 - 1024


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


def azimuth_boxes(offsets, group_ptr, az_ptr) -> np.ndarray:
    """(A, 4) ``sx_block.halo_box`` of each azimuth's rays in the flat
    tables of :func:`sweep_tables`: (min oy, max oy, min ox, max ox) from
    the signed offsets, (0, 0, 0, 0) for an azimuth without rays."""
    rays = group_ptr[az_ptr]
    return np.array([sx_block.halo_box(offsets[k0:k1]) for k0, k1 in zip(rays[:-1], rays[1:])],
                    np.int64).reshape(-1, 4)


def union_box(boxes) -> tuple:
    """The bounding box of several halo boxes."""
    b = np.asarray(boxes).reshape(-1, 4)
    return int(b[:, 0].min()), int(b[:, 1].max()), int(b[:, 2].min()), int(b[:, 3].max())


def staged_bytes(box) -> int:
    """Shared memory of the output tile grown by the halo box."""
    oy0, oy1, ox0, ox1 = box
    return 4 * (TILE_H + oy1 - oy0) * (TILE_W + ox1 - ox0)


def table_words(n_rays, n_groups) -> int:
    """Words of the largest azimuth's table in shared memory (its rays,
    group pointers and reciprocal distances), padded to 16 bytes."""
    words = np.asarray(n_rays) + 2 * np.asarray(n_groups) + 1
    return int(-(-words.max(initial=0) // 4) * 4)


def fan_groups(boxes, budget: int) -> list:
    """The fan kernel's groups of consecutive azimuths, as ``[(a0, a1),
    ...]``: each group grows while the staged tile of its union box stays
    within ``budget`` bytes; an azimuth whose own tile exceeds it is a
    group alone."""
    groups, a0, box = [], 0, None
    for a, b in enumerate(np.asarray(boxes).reshape(-1, 4)):
        grown = tuple(b) if box is None else union_box([box, b])
        if box is not None and staged_bytes(grown) > budget:
            groups.append((a0, a))
            a0, grown = a, tuple(b)
        box = grown
    if box is not None:
        groups.append((a0, len(boxes)))
    return groups


def route(smem_bytes: int) -> str:
    """Either kernel's route: ``"tile"`` when a block's shared memory
    (``FanTables.sweep_smem`` or ``fan_smem``) fits, else ``"chunked"``; the
    grid's size plays no part."""
    return "tile" if smem_bytes <= _build.SMEM_PER_BLOCK else "chunked"


def azimuth_tables(offs, group_ptr, inv, az_ptr) -> list:
    """Each azimuth's :func:`sx_block.ray_groups` tables ``(offsets,
    group_ptr, inv)`` out of the flat tables of :func:`sweep_tables`."""
    rays = group_ptr[az_ptr]
    return [(offs[rays[a] : rays[a + 1]], group_ptr[az_ptr[a] : az_ptr[a + 1] + 1] - rays[a],
             inv[az_ptr[a] : az_ptr[a + 1]]) for a in range(len(az_ptr) - 1)]


class SweepPlan(NamedTuple):
    """The chunked route's plan on the device: :func:`sx_block.chunk_plan`
    of every azimuth and the work items over its chunks."""

    plan: torch.Tensor  # sx_block.chunk_plan of every azimuth
    stage_floats: int  # one of its two stages, in floats
    items: torch.Tensor  # (M, 4) int32 work items: azimuth, first chunk, end chunk, split
    splits: torch.Tensor  # (A,) int32 work items per azimuth
    max_splits: int  # the most of any azimuth: the workspace's planes per azimuth


def upload_plan(plan, stage_floats: int, items, splits, device) -> SweepPlan:
    """:class:`SweepPlan` of host arrays, uploaded to ``device``."""
    return SweepPlan(upload(plan, device), stage_floats, upload(items, device),
                     upload(splits, device), int(np.max(splits, initial=1)))


class FanTables(NamedTuple):
    """A fan's device tables and the launch geometry of both kernels."""

    offsets: torch.Tensor  # (K', 2) int32, the rays of sweep_tables
    group_ptr: torch.Tensor  # (G + 1,) int32
    inv: torch.Tensor  # (G,) float32
    az_ptr: torch.Tensor  # (A + 1,) int32
    n_az: int
    boxes: np.ndarray  # (A, 4) signed halo box per azimuth
    sweep_boxes: torch.Tensor  # (A, 4) int32 (oy0, ox0, sh, sw) of each staged wedge
    sweep_smem: int  # the largest azimuth's staged wedge and ray table
    groups: list  # the fan kernel's azimuth groups (a0, a1)
    fan: torch.Tensor  # (J, 6) int32 (a0, a1, oy0, ox0, sh, sw) per group
    fan_soff: torch.Tensor  # (K',) int32, each ray's offset into its group's tile
    table_words: int  # one of the fan kernel's two table buffers, in words
    fan_smem: int  # the two table buffers and the largest group's staged tile
    fan_plan: Optional[SweepPlan]  # the fan's chunked route (one item per azimuth), or None
    sweep_plans: dict  # the sweep's chunked route: SweepPlan per grid (device_sweep_plan)


def fan_tables(offsets, distances, device) -> FanTables:
    """Builds and uploads :class:`FanTables` for a deduplicated padded fan."""
    offs, group_ptr, inv, az_ptr = sweep_tables(offsets, distances)
    boxes = azimuth_boxes(offs, group_ptr, az_ptr)
    rays, n_groups = group_ptr[az_ptr], np.diff(az_ptr)
    sweep_boxes = np.array([(oy0, ox0, TILE_H + oy1 - oy0, TILE_W + ox1 - ox0)
                            for oy0, oy1, ox0, ox1 in boxes], np.int32).reshape(-1, 4)
    sweep_smem = max((sx_block.tile_smem_bytes(b, int(k1 - k0), int(g))
                      for b, k0, k1, g in zip(boxes, rays[:-1], rays[1:], n_groups)), default=0)
    words = table_words(rays[1:] - rays[:-1], n_groups)
    groups = fan_groups(boxes, FAN_SMEM_BUDGET - 8 * words)
    fan, fan_soff = [], np.zeros(len(offs), np.int32)
    for a0, a1 in groups:
        oy0, oy1, ox0, ox1 = union_box(boxes[a0:a1])
        sh, sw = TILE_H + oy1 - oy0, TILE_W + ox1 - ox0
        k0, k1 = rays[a0], rays[a1]
        fan_soff[k0:k1] = (offs[k0:k1, 0] - oy0) * sw + (offs[k0:k1, 1] - ox0)
        fan.append((a0, a1, oy0, ox0, sh, sw))
    fan = np.array(fan, np.int32).reshape(-1, 6)
    fan_smem = 8 * words + max((4 * int(sh) * int(sw) for sh, sw in fan[:, 4:]), default=0)
    fan_plan = None
    if route(fan_smem) == "chunked":
        n_az = len(az_ptr) - 1
        plan, _, stage_floats = sx_block.chunk_plan(azimuth_tables(offs, group_ptr, inv, az_ptr))
        items, per_az, _ = sx_block.split_plan(plan, n_az, 0, 1, 1, splits=1)
        fan_plan = upload_plan(plan, stage_floats, items, per_az, device)
    return FanTables(
        *(upload(t, device) for t in (offs, group_ptr, inv, az_ptr)), len(az_ptr) - 1,
        boxes, upload(sweep_boxes, device), sweep_smem, groups, upload(fan, device),
        upload(fan_soff, device), words, fan_smem, fan_plan, {},
    )


def device_tables(offsets, distances, border, device) -> FanTables:
    """:func:`fan_tables`, built and uploaded once per (offsets, distances,
    border, device) while it stays in ``TABLES``."""
    o = np.ascontiguousarray(offsets, np.int64)
    d = np.ascontiguousarray(distances, np.float64)
    key = (o.tobytes(), o.shape, d.tobytes(), int(border), torch.device(device))
    return TABLES.get(key, lambda: fan_tables(offsets, distances, device))


def device_sweep_plan(offsets, distances, border, device, shape, zero_border, n_sms: int,
                      tables: FanTables = None) -> SweepPlan:
    """The sweep's chunked route on an (H, W) grid with ``n_sms`` SMs for a
    deduplicated padded fan: :func:`sx_block.sweep_plan` as a
    :class:`SweepPlan`, built and uploaded once per grid shape, zero border
    and SM count and kept with the fan's :func:`device_tables` (``tables``,
    where the caller has them)."""
    t = device_tables(offsets, distances, border, device) if tables is None else tables
    key = (tuple(shape), bool(zero_border), int(n_sms))
    if key not in t.sweep_plans:
        grid_tiles = sx_block.busy_tiles(shape, border, zero_border)
        t.sweep_plans[key] = upload_plan(*sx_block.sweep_plan(
            azimuth_tables(*sweep_tables(offsets, distances)), grid_tiles, n_sms), device)
    return t.sweep_plans[key]


def workspace_shape(p: SweepPlan, shape, border, zero_border) -> Optional[tuple]:
    """``(S, A, rows, columns)`` of the workspace where the plan ``p`` splits
    an azimuth on an (H, W) grid: S planes per azimuth over the box of the
    tiles that read rays (:func:`sx_block.busy_box`); None where every
    azimuth is one work item."""
    if p.max_splits <= 1:
        return None
    _, _, rows, cols = sx_block.busy_box(shape, border, zero_border)
    return p.max_splits, len(p.splits), rows, cols


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


def launch_sweep_chunked(dem: torch.Tensor, p: SweepPlan, border: int, height: float,
                         zero_border: bool, kernel: str = "sx_sweep") -> torch.Tensor:
    """Runs the chunked route on the plan ``p`` and returns the (A, H, W)
    planes; where an azimuth has several work items their maxima go through
    a :func:`workspace_shape` float32 workspace allocated here. Raises on a
    CUDA error, naming ``kernel``; counts nothing."""
    h, w = dem.shape
    n_az = len(p.splits)
    out = torch.empty((n_az, h, w), dtype=torch.float32, device=dem.device)
    shape = workspace_shape(p, dem.shape, border, zero_border)
    ws, splits, box = None, None, (0, 0, 0, 0)
    if shape is not None:
        ws = torch.empty(shape, dtype=torch.float32, device=dem.device)
        splits, box = p.splits.data_ptr(), sx_block.busy_box(dem.shape, border, zero_border)
    with torch.cuda.device(dem.device):
        err = _build.library().sx_sweep_chunked_forward(
            dem.data_ptr(), p.plan.data_ptr(), p.items.data_ptr(), len(p.items), n_az,
            p.stage_floats, out.data_ptr(), None if ws is None else ws.data_ptr(), splits,
            *box, h, w, int(border), float(height), int(bool(zero_border)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"{kernel} (chunked)")
    return out


def sx_sweep_chunked(dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
                     zero_border: bool = True, tables: FanTables = None) -> torch.Tensor:
    """The sweep's chunked route on a CUDA tensor whatever the boxes, on the
    split plan the model picks for this grid: :func:`sx_sweep` takes it,
    with the fan's ``tables``, where a wedge does not fit in shared
    memory."""
    sx_block.check_dem(dem, "sx_sweep")
    n_sms = torch.cuda.get_device_properties(dem.device).multi_processor_count
    p = device_sweep_plan(offsets, distances, border, dem.device, dem.shape, zero_border, n_sms,
                          tables)
    out = launch_sweep_chunked(dem, p, border, height, zero_border)
    LAUNCHES["sx_sweep"] += 1
    ROUTE_LAUNCHES["sx_sweep"]["chunked"] += 1
    return out


def _launch(kernel: str, dem, offsets, distances, border, height, zero_border):
    sx_block.check_dem(dem, kernel)
    h, w = dem.shape
    t = device_tables(offsets, distances, border, dem.device)
    smem = t.sweep_smem if kernel == "sx_sweep" else t.fan_smem
    which = route(smem)
    if which == "chunked" and kernel == "sx_sweep":
        return sx_sweep_chunked(dem, offsets, distances, border, height, zero_border, tables=t)
    if which == "chunked":
        out = launch_sweep_chunked(dem, t.fan_plan, border, height, zero_border, kernel)
    else:
        out = torch.empty((t.n_az, h, w), dtype=torch.float32, device=dem.device)
        vec = int(dem.data_ptr() % 16 == 0 and w % 4 == 0)  # 16-byte row loads
        if kernel == "sx_sweep":
            rays, boxes, n, extra = t.offsets, t.sweep_boxes, t.n_az, ()
        else:
            rays, boxes, n, extra = t.fan_soff, t.fan, len(t.groups), (t.table_words,)
        with torch.cuda.device(dem.device):
            err = getattr(_build.library(), f"{kernel}_tile_forward")(
                dem.data_ptr(), rays.data_ptr(), t.group_ptr.data_ptr(), t.inv.data_ptr(),
                t.az_ptr.data_ptr(), boxes.data_ptr(), n, out.data_ptr(), h, w, int(border),
                float(height), int(bool(zero_border)), smem, vec, *extra,
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"{kernel} (tile)")
    LAUNCHES[kernel] += 1
    ROUTE_LAUNCHES[kernel][which] += 1
    return out


def sx_sweep(
    dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
    zero_border: bool = True,
) -> torch.Tensor:
    """:func:`sx_sweep_plain` on a CPU tensor; on a CUDA tensor, which must
    be a contiguous float32 (H, W) DEM, the kernel with one azimuth per
    block (tile route) or one range of an azimuth's distance bands per block
    (chunked route, :func:`sx_sweep_chunked`)."""
    if not on_cuda(dem):
        return sx_sweep_plain(dem, offsets, distances, border, height, zero_border)
    return _launch("sx_sweep", dem, offsets, distances, border, height, zero_border)


def sx_fan(
    dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
    zero_border: bool = True,
) -> torch.Tensor:
    """:func:`sx_sweep_plain` on a CPU tensor; on a CUDA tensor, which must
    be a contiguous float32 (H, W) DEM, the kernel with one group of
    azimuths per block (tile route) or one azimuth per block, its rays
    streamed band by band (chunked route: the sweep's kernel on one work
    item per azimuth)."""
    if not on_cuda(dem):
        return sx_sweep_plain(dem, offsets, distances, border, height, zero_border)
    return _launch("sx_fan", dem, offsets, distances, border, height, zero_border)
