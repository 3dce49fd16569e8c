"""Sx horizon scan: the CUDA kernel's wrapper and its plain PyTorch twin.

Replaces ``topo_descriptors_tpu/ops/pallas/sx_block.py::_sx_kernel`` with
the epilogue ``sx_pallas`` runs after it. The CUDA kernels are in
``csrc/sx_block.cu``; its header says what bounds them on the H100 (load
instructions: K ray reads per pixel) and what the two routes do about
that: ``"tile"`` stages the halo its rays reach in shared memory;
``"chunked"`` (halos that do not fit) streams it through two
shared-memory stages, one band of distance groups at a time, from the
host plan :func:`chunk_plan` (the counterpart of the TPU kernel's
``CHUNK_RAYS`` chunks of whole distance groups). :func:`route` chooses
between them from the halo's bytes and the shared-memory limit alone.
:func:`split_plan` cuts such a plan's azimuths into work items for
``sx_sweep``'s chunked route, so that a grid that leaves SMs idle gets
several blocks per tile and azimuth.
:func:`sx_block_plain` is the same function in plain PyTorch — the
transcription of the XLA scan in ``topo_descriptors_tpu/ops/sx.py``: a
NaN-padded DEM and one ``torch.fmax`` pass per ray offset.

:func:`sx_block` routes by the tensor: CPU tensors take the plain twin,
CUDA tensors the kernel, anything else raises. ``LAUNCHES`` counts the
kernel's launches and ``ROUTE_LAUNCHES`` splits them by route; ``TABLES``
keeps the ray tables and chunk plans on their device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from topo_descriptors_tpu_torch.device import TableCache, on_cuda, upload
from topo_descriptors_tpu_torch.ops.cuda import _build

LAUNCHES = 0
ROUTE_LAUNCHES = {"tile": 0, "chunked": 0}
TABLES = TableCache()

# csrc/sx_block.cu's output tile (kTileH x kTileW), both routes
TILE_H, TILE_W = 32, 64
# the chunked route's stage (csrc/sx_chunked.cuh) for n blocks per SM: two
# stages per block, and the 1 KB each block takes
CHUNK_STAGES = {n: min(_build.SMEM_PER_BLOCK, _build.SMEM_PER_SM // n - 1024) // 2 // 16 * 16
                for n in (1, 2, 3)}
# the chunked route's speed with n blocks per SM against one, and the cost
# of a chunk (its barriers and staging) in ray reads per output: measured
# by chip_smoke.py::tune_chunk_stage on an NVIDIA H100 80GB HBM3 at 700 W
# (10 km at 45 degrees on 8192^2: 96.5, 58.5 and 51.9 ms; at 20 km two
# blocks per SM cut the plan into 154 chunks)
STAGE_SPEED = {1: 1.0, 2: 1.65, 3: 1.86}
CHUNK_COST_RAYS = 22
# a chunk record's flags: its first segment goes on with the group the
# previous chunk left open; its last segment's group goes on in the next
CARRY_IN, CARRY_OUT = 1, 2
# the split plan (sx_sweep's chunked route, :func:`split_plan`): the cost of
# a work item that shares its azimuth's chunks with others, in ray reads per
# output (its first stage fills before any sum hides it, and its maxima go
# through the workspace and the fold), taken as one more chunk's
SPLIT_COST_RAYS = CHUNK_COST_RAYS


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


def max_ratio_plain(dem: torch.Tensor, offsets, distances, border: int,
                    height: float = 10.0) -> torch.Tensor:
    """max over rays k of (dem[p + o_k] - dem[p] - height) / d_k, NaN
    dropped, -inf where no candidate is valid: the plane the kernels feed
    their atan epilogue, one fmax pass per ray."""
    h, w = dem.shape
    pad = int(border)
    padded = F.pad(dem, (pad, pad, pad, pad), value=float("nan"))
    base = dem + torch.tensor(height, dtype=dem.dtype, device=dem.device)
    invs = upload(_inv_distances(distances), dem.device)
    max_ratio = torch.full((h, w), -torch.inf, dtype=dem.dtype, device=dem.device)
    for k, (oy, ox) in enumerate(np.asarray(offsets) + pad):
        shifted = padded[oy : oy + h, ox : ox + w]
        max_ratio = torch.fmax(max_ratio, (shifted - base) * invs[k])
    return max_ratio


def sx_block_plain(
    dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
    zero_border: bool = True,
) -> torch.Tensor:
    """Sx in degrees from a deduplicated ray table: :func:`max_ratio_plain`
    and the atan epilogue."""
    return _epilogue(max_ratio_plain(dem, offsets, distances, border, height), int(border),
                     zero_border)


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
    ``"chunked"``; the grid's size plays no part."""
    return "tile" if tile_smem_bytes(box, n_rays, n_groups) <= _build.SMEM_PER_BLOCK else "chunked"


def _table_words(n_rays, n_segments):
    """Words of a chunk's table in its stage: its rays' offsets, segment
    pointers and reciprocal distances, padded to 16 bytes (the layout of
    the tile route's table)."""
    return -(-(n_rays + 2 * n_segments + 1) // 4) * 4


def chunk_bounds(offs, ptr, stage_bytes: int) -> list:
    """``[(k0, k1), ...]``: one azimuth's rays of :func:`ray_groups`, in
    order, cut into consecutive runs, each as long as its stage (the run's
    table and the output tile grown by the run's :func:`halo_box`) stays
    within ``stage_bytes``. The groups go by distance, so a run is one band
    of the wedge and its box is small. A run may end inside a group (the
    kernel then carries that group's running max into the next run), so any
    fan has a plan as long as one ray's stage fits."""
    offs = np.asarray(offs, np.int64).reshape(-1, 2)
    group = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))  # each ray's group
    bounds, k0, window = [], 0, 256
    while k0 < len(offs):
        while True:  # a window of rays long enough to hold the chunk
            rest = offs[k0 : k0 + window]
            lo = np.minimum.accumulate(rest, axis=0)
            hi = np.maximum.accumulate(rest, axis=0)
            words = (_table_words(np.arange(1, len(rest) + 1),
                                  group[k0 : k0 + window] - group[k0] + 1)
                     + (TILE_H + hi[:, 0] - lo[:, 0]) * (TILE_W + hi[:, 1] - lo[:, 1]))
            n = int(np.count_nonzero(4 * words <= stage_bytes))  # words only grow: a prefix
            if n < len(rest) or k0 + window >= len(offs):
                break
            window *= 4
        if n == 0:
            raise ValueError(f"a {stage_bytes}-byte stage holds no single ray's box")
        bounds.append((k0, k0 + n))
        k0 += n
    return bounds


def chunk_plan(tables, stage_bytes: int = None, max_blocks: int = None):
    """The chunked route's plan for one or more azimuths, each given as
    its :func:`ray_groups` tables ``(offsets, group_ptr, inv)``, with
    stages of ``stage_bytes``; or, with None, the plan of the stage of
    ``CHUNK_STAGES`` that the cost model finds cheapest: a smaller stage
    fits more blocks on an SM, but cuts a wide fan into many small chunks.
    The model's cost of a plan is its work per output in ray reads (each
    ray, each staged value, ``CHUNK_COST_RAYS`` per chunk) over
    ``STAGE_SPEED`` of its blocks per SM, of which the launch fills at most
    ``max_blocks`` (None: as many as fit).

    Returns ``(plan int32, n_chunks, stage_floats)``. Layout (words):
    ``n_az + 1`` chunk pointers (azimuth ``a`` owns chunks ``plan[a] ..
    plan[a + 1] - 1``), padded to 16 bytes; per chunk two int4 records
    ``(table word, rays, segments, flags), (oy0, ox0, sh, sw)``; then each
    chunk's table, copied word for word into its stage: its rays as
    offsets into its box (staged row ``i``, column ``j`` is
    ``dem[y0 + oy0 + i, x0 + ox0 + j]`` for the output tile at ``(y0,
    x0)``, ``sh x sw``), its segment pointers (the parts of the groups it
    meets, rebased to the chunk) and their reciprocal distances.
    ``stage_floats`` is the largest chunk's table and box, padded to 16
    bytes."""
    if stage_bytes is not None:
        return _chunk_plan(tables, stage_bytes)[:3]
    plans = [(_chunk_plan(tables, stage), min(n, max_blocks or n))
             for n, stage in CHUNK_STAGES.items()]
    (plan, n_chunks, stage_floats, _), _ = min(plans, key=lambda p: p[0][3] / STAGE_SPEED[p[1]])
    return plan, n_chunks, stage_floats


def busy_box(shape, border, zero_border) -> tuple:
    """``(first row, first column, rows, columns)`` of the box of the chunked
    route's output tiles on an (H, W) grid that read rays, clipped to the
    grid: with the zero border, the tiles that meet the interior (the others
    only write zeros; no rows or columns where there is no interior);
    without it, the grid."""
    h, w = shape
    if not zero_border:
        return 0, 0, int(h), int(w)
    y0 = np.arange(-(-h // TILE_H)) * TILE_H
    x0 = np.arange(-(-w // TILE_W)) * TILE_W
    y0 = y0[(y0 + TILE_H > border) & (y0 < h - border)]
    x0 = x0[(x0 + TILE_W > border) & (x0 < w - border)]
    if not len(y0) or not len(x0):
        return 0, 0, 0, 0
    return (int(y0[0]), int(x0[0]), int(min(h, y0[-1] + TILE_H) - y0[0]),
            int(min(w, x0[-1] + TILE_W) - x0[0]))


def busy_tiles(shape, border, zero_border) -> int:
    """The chunked route's output tiles on an (H, W) grid that read rays:
    those of :func:`busy_box`."""
    _, _, rows, cols = busy_box(shape, border, zero_border)
    return -(-rows // TILE_H) * -(-cols // TILE_W)


def busy_blocks_per_sm(shape, border, zero_border, n_sms: int) -> int:
    """Blocks per SM that the chunked route's launch on an (H, W) grid can
    keep busy, up to the most ``CHUNK_STAGES`` offers: its
    :func:`busy_tiles` over the SMs."""
    tiles = busy_tiles(shape, border, zero_border)
    return int(min(max(-(-tiles // n_sms), 1), max(CHUNK_STAGES)))


def _records(plan, n_az: int) -> np.ndarray:
    """The (n_chunks, 8) chunk records of a :func:`chunk_plan`."""
    head = -(-(n_az + 1) // 4) * 4
    return np.asarray(plan[head : head + 8 * int(plan[n_az])]).reshape(-1, 8)


def _chunk_costs(records) -> np.ndarray:
    """Each chunk's work per output in ray reads, the cost model's unit:
    its rays, its staged values and ``CHUNK_COST_RAYS``."""
    records = np.asarray(records, np.int64).reshape(-1, 8)
    return records[:, 1] + records[:, 6] * records[:, 7] / (TILE_H * TILE_W) + CHUNK_COST_RAYS


def _split_cuts(starts, prefix, n_splits: int) -> list:
    """Where ``n_splits`` work items of one azimuth begin: its first chunk
    ``starts[0]``, then ``n_splits - 1`` of the later group starts
    ``starts[1:]``, each the one whose cost before it (``prefix``, over the
    plan's chunks) comes nearest to its share of the azimuth's cost."""
    cuts, lo = [int(starts[0])], 1
    first, total = prefix[starts[0]], prefix[-1] - prefix[starts[0]]
    for j in range(1, n_splits):
        hi = len(starts) - (n_splits - 1 - j)  # leave a start for each later cut
        gap = np.abs(prefix[starts[lo:hi]] - (first + j * total / n_splits))
        i = lo + int(np.argmin(gap))
        cuts.append(int(starts[i]))
        lo = i + 1
    return cuts


def split_plan(plan, n_az: int, tiles: int, n_sms: int, blocks_per_sm: int, splits: int = None):
    """The work items of ``sx_sweep``'s chunked route on a :func:`chunk_plan`
    of ``n_az`` azimuths whose stage fits ``blocks_per_sm`` blocks on an SM,
    for a launch whose grid has ``tiles`` :func:`busy_tiles` on ``n_sms``
    SMs. A work item is a range of one azimuth's chunks that begins at a
    chunk without ``CARRY_IN`` (a group start) and ends where the next item
    begins, so no open group crosses it; the kernel runs one block per
    (tile, item), and folds an azimuth's items by an fmax.

    With ``splits=None`` the model splits only where the grid leaves SMs
    idle: ``tiles`` x ``n_az`` blocks under ``blocks_per_sm`` per SM. There
    it tries S = 1, 2, ... items per azimuth, as many as the azimuth's group
    starts allow, and keeps the S of the least time, the smallest on a tie.
    (On the card, items of one or two chunks were the fastest at 10 km,
    where a chunk holds hundreds of rays: ``chip_smoke.py::tune_split``.)
    The model's time of a launch,
    in ray reads per output: in one wave, the costliest item times the
    blocks k of the fullest SM over ``STAGE_SPEED[k]``; in more, all items'
    work over the SMs at ``STAGE_SPEED[blocks_per_sm]``, plus half the
    costliest item at that rate (the last wave's tail). An item's cost is
    its chunks' (:func:`_chunk_costs`), plus ``SPLIT_COST_RAYS`` where the
    plan splits. With ``splits`` an int, every azimuth is cut into
    ``min(splits, its group starts)`` items.

    Returns ``(items (M, 4) int32: azimuth, first chunk, end chunk, item's
    index in its azimuth; splits (n_az,) int32: each azimuth's items; the
    model's time)``."""
    az_chunk = np.asarray(plan[: n_az + 1], np.int64)
    recs = _records(plan, n_az)
    prefix = np.concatenate([[0.0], np.cumsum(_chunk_costs(recs))])
    starts = [np.flatnonzero((recs[c0:c1, 3] & CARRY_IN) == 0) + c0
              for c0, c1 in zip(az_chunk[:-1], az_chunk[1:])]
    capacity = blocks_per_sm * n_sms

    def items_of(per_az):
        items = []
        for a, (n, c1) in enumerate(zip(per_az, az_chunk[1:])):
            cuts = _split_cuts(starts[a], prefix, n) if len(starts[a]) else [int(c1)]
            items += [(a, c, e, s) for s, (c, e) in enumerate(zip(cuts, cuts[1:] + [int(c1)]))]
        return items

    def cost(items):
        extra = SPLIT_COST_RAYS if len(items) > n_az else 0.0
        return np.array([prefix[e] - prefix[c] + extra for _, c, e, _ in items])

    def model_time(items):
        blocks, c = tiles * len(items), cost(items)
        if blocks == 0:  # no tile reads a ray
            return 0.0
        if blocks <= capacity:
            k = -(-blocks // n_sms)
            return c.max() * k / STAGE_SPEED[k]
        speed = STAGE_SPEED[blocks_per_sm]
        return tiles * c.sum() / (n_sms * speed) + c.max() * blocks_per_sm / (2 * speed)

    if splits is not None:
        per_az = [max(1, min(int(splits), len(st))) for st in starts]
    else:
        most = [max(1, len(st)) for st in starts]
        tries = range(1, max(most, default=1) + 1) if 0 < tiles * n_az < capacity else [1]
        per_az = min(([min(n, m) for m in most] for n in tries),
                     key=lambda p: model_time(items_of(p)))
    items = items_of(per_az)
    return (np.asarray(items, np.int32).reshape(-1, 4), np.asarray(per_az, np.int32),
            model_time(items))


def sweep_plan(tables, tiles: int, n_sms: int):
    """``sx_sweep``'s chunked route for a fan given as per-azimuth
    :func:`ray_groups` tables on a grid of ``tiles`` :func:`busy_tiles`: the
    :func:`chunk_plan` at the stage of ``CHUNK_STAGES`` whose
    :func:`split_plan` the model finds fastest, the largest stage on a tie.

    Returns ``(plan, stage_floats, items, splits per azimuth)``."""
    best = None
    for n, stage in CHUNK_STAGES.items():
        plan, _, stage_floats, _ = _chunk_plan(tables, stage)
        items, per_az, t = split_plan(plan, len(tables), tiles, n_sms, n)
        if best is None or t < best[0]:
            best = (t, plan, stage_floats, items, per_az)
    return best[1:]


def _chunk_plan(tables, stage_bytes: int):
    """:func:`chunk_plan` with stages of ``stage_bytes``, and the plan's
    work per output in ray reads."""
    n_az = len(tables)
    head = -(-(n_az + 1) // 4) * 4
    az_chunk, records, parts = [0], [], []
    for offs, ptr, inv in tables:
        offs = np.asarray(offs, np.int64).reshape(-1, 2)
        ptr = np.asarray(ptr, np.int64)
        inv_bits = np.asarray(inv, np.float32).view(np.int32)
        for k0, k1 in chunk_bounds(offs, ptr, stage_bytes):
            g0 = int(np.searchsorted(ptr, k0, side="right")) - 1  # the group of ray k0
            g1 = int(np.searchsorted(ptr, k1 - 1, side="right"))  # past the group of ray k1 - 1
            oy0, oy1, ox0, ox1 = halo_box(offs[k0:k1])
            sh, sw = TILE_H + oy1 - oy0, TILE_W + ox1 - ox0
            n, n_seg = k1 - k0, g1 - g0
            table = np.zeros(_table_words(n, n_seg), np.int32)
            table[:n] = (offs[k0:k1, 0] - oy0) * sw + (offs[k0:k1, 1] - ox0)
            table[n : n + n_seg + 1] = np.clip(ptr[g0 : g1 + 1], k0, k1) - k0
            table[n + n_seg + 1 : n + 2 * n_seg + 1] = inv_bits[g0:g1]
            flags = CARRY_IN * int(ptr[g0] < k0) | CARRY_OUT * int(ptr[g1] > k1)
            records.append([0, n, n_seg, flags, oy0, ox0, sh, sw])
            parts.append(table)
        az_chunk.append(len(records))
    word = head + 8 * len(records)
    for rec, table in zip(records, parts):
        rec[0] = word
        word += len(table)
    stage = max((len(t) + r[6] * r[7] for r, t in zip(records, parts)), default=0)
    plan = np.concatenate([np.asarray(az_chunk + [0] * (head - n_az - 1), np.int32),
                           np.asarray(records, np.int32).reshape(-1), *parts]).astype(np.int32)
    reads = float(_chunk_costs(records).sum())
    return plan, len(records), -(-stage // 4) * 4, reads


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


def device_plan(offsets, distances, border, device, stage_bytes: int = None,
                max_blocks: int = None):
    """``(plan on device, n_chunks, stage_floats)`` of :func:`chunk_plan`
    for one azimuth's rays, built and uploaded once per (offsets,
    distances, border, device, stage or blocks per SM) while it stays in
    ``TABLES``."""
    o = np.ascontiguousarray(offsets, np.int64)
    d = np.ascontiguousarray(distances, np.float64)
    key = ("chunked", o.tobytes(), o.shape, d.tobytes(), int(border), torch.device(device),
           stage_bytes, max_blocks)

    def build():
        plan, n_chunks, stage_floats = chunk_plan([ray_groups(offsets, distances)], stage_bytes,
                                                  max_blocks)
        return upload(plan, device), n_chunks, stage_floats

    return TABLES.get(key, build)


def sx_block_chunked(dem: torch.Tensor, offsets, distances, border: int, height: float = 10.0,
                     zero_border: bool = True,
                     stage_bytes: int = None) -> torch.Tensor:
    """The chunked route on a CUDA tensor whatever the halo, with stages of
    ``stage_bytes`` or (None) the model's stage for this grid
    (:func:`busy_blocks_per_sm`): :func:`sx_block` takes it where the tile
    does not fit; a plan of one chunk computes what the tile route does."""
    global LAUNCHES
    check_dem(dem, "sx_block")
    max_blocks = None
    if stage_bytes is None:
        n_sms = torch.cuda.get_device_properties(dem.device).multi_processor_count
        max_blocks = busy_blocks_per_sm(dem.shape, border, zero_border, n_sms)
    plan, _, stage_floats = device_plan(offsets, distances, border, dem.device, stage_bytes,
                                        max_blocks)
    h, w = dem.shape
    out = torch.empty((h, w), dtype=torch.float32, device=dem.device)
    with torch.cuda.device(dem.device):
        err = _build.library().sx_block_chunked_forward(
            dem.data_ptr(), plan.data_ptr(), 1, stage_floats, out.data_ptr(), h, w,
            int(border), float(height), int(bool(zero_border)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sx_block (chunked)")
    LAUNCHES += 1
    ROUTE_LAUNCHES["chunked"] += 1
    return out


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
    if route(box, n_rays, n_groups) == "chunked":
        return sx_block_chunked(dem, offsets, distances, border, height, zero_border)
    out = torch.empty((h, w), dtype=torch.float32, device=dem.device)
    oy0, oy1, ox0, ox1 = box
    vec = int(dem.data_ptr() % 16 == 0 and w % 4 == 0)  # 16-byte row loads
    with torch.cuda.device(dem.device):
        err = _build.library().sx_block_tile_forward(
            dem.data_ptr(), offs_t.data_ptr(), ptr_t.data_ptr(), inv_t.data_ptr(),
            n_rays, n_groups, out.data_ptr(), h, w, oy0, ox0, TILE_H + oy1 - oy0,
            TILE_W + ox1 - ox0, int(border), float(height), int(bool(zero_border)),
            tile_smem_bytes(box, n_rays, n_groups), vec, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sx_block (tile)")
    LAUNCHES += 1
    ROUTE_LAUNCHES["tile"] += 1
    return out
