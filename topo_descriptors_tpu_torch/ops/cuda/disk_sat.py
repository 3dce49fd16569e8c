"""Disk ({0,1}-kernel) convolution through row prefix sums.

Replaces ``topo_descriptors_tpu/ops/pallas/disk_sat.py::_sat_kernel`` (and
its launcher ``disk_conv_sat_pallas``). The CUDA kernels are in
``csrc/disk_sat.cu``; its header says what bounds them on the H100 (load
instructions: 2 x runs prefix reads per pixel) and what the two routes do
about that: ``"fused"`` stages a tile of the field in shared memory and
scans it there; ``"wide"`` (kernels whose tile does not fit) scans only
the field's rows into a prefix plane in device memory and streams it
through shared memory in chunks of kernel rows (:func:`wide_plan`, built
on the host and cached in place of the run table). :func:`route` chooses
between them from the kernel's shape and run table and the shared-memory
limit alone.
:func:`disk_conv_sat_plain` is the same algorithm in plain PyTorch — the
transcription of the XLA twin ``ops/conv.py::_conv2d_sat``.

:func:`disk_conv_sat` routes by the tensor: CPU tensors take the plain
twin, CUDA tensors the kernel, anything else raises. ``LAUNCHES`` counts
the convolutions run on the card and ``ROUTE_LAUNCHES`` splits them by
route; ``TABLES`` keeps each kernel's run table or wide plan on its device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from topo_descriptors_tpu_torch.device import TableCache, on_cuda, upload
from topo_descriptors_tpu_torch.ops.cuda import _build

LAUNCHES = 0
ROUTE_LAUNCHES = {"fused": 0, "wide": 0}
TABLES = TableCache()

# csrc/disk_sat.cu's output tile (kTileH x kTileW), both routes
TILE_H, TILE_W = 32, 128
# widest kernel whose staged rows a warp scans in registers (kSegMax = 10)
SCAN_MAX_KW = 32 * 10 - TILE_W + 1

# the wide route's chunks (csrc/disk_sat.cu::disk_sat_wide): two stages
# fill the block's shared memory; a strip's run columns spread over at most
# WIDE_SPREAD columns
WIDE_STAGE_FLOATS = _build.SMEM_PER_BLOCK // 8 // 4 * 4
WIDE_SPREAD = 64
# most consecutive rows of one group a step reads from one window (kWideSpan)
WIDE_SPAN = 4

_INT_MAX = 2**31 - 1


def group_runs(runs):
    """``[(a, b, (r0, r1, ...)), ...]``: kernel rows that share the run
    ``[a, b]``, in order of first appearance — the order in which both the
    twin and the kernel sum them."""
    by_cols: dict = {}
    for r, a, bcol in runs:
        by_cols.setdefault((a, bcol), []).append(r)
    return [(a, bcol, tuple(rows)) for (a, bcol), rows in by_cols.items()]


def run_table(runs):
    """``(table, n_groups)``: the run groups as the kernel reads them —
    ``(a, b, first, end)`` per group, then the row indices that
    ``first..end-1`` point into."""
    groups = group_runs(runs)
    head, rows = [], []
    for a, bcol, grows in groups:
        head.append((a, bcol, len(rows), len(rows) + len(grows)))
        rows.extend(grows)
    table = np.concatenate(
        [np.asarray(head, np.int32).reshape(-1), np.asarray(rows, np.int32)]
    )
    return table, len(groups)


def fused_smem_bytes(kshape, table_len: int) -> int:
    """Dynamic shared memory of the fused route's block: the run table
    (padded to 16 bytes) and (TILE_H + kh - 1) staged rows of TILE_W + kw
    prefix values."""
    kh, kw = kshape
    return 4 * (-(-table_len // 4) * 4 + (TILE_H + kh - 1) * (TILE_W + kw))


def route(kshape, table_len: int) -> str:
    """``"fused"`` when the fused tile fits in shared memory (and its rows
    in the scan's registers, kw <= 193), else ``"wide"``; the grid's size
    plays no part."""
    smem = fused_smem_bytes(kshape, table_len)
    fits = smem <= _build.SMEM_PER_BLOCK and kshape[1] <= SCAN_MAX_KW
    return "fused" if fits else "wide"


def _steps(rows):
    """The wide route's steps over a chunk's ``(r, a, b, last)`` rows, in
    order: ``(index, span, ends)``. A step is up to ``WIDE_SPAN``
    consecutive rows r, r + 1, ... of one group (one window of staged rows
    serves them all); ``ends`` when the group's last row is in it."""
    steps, i = [], 0
    while i < len(rows):
        span = 1
        while (span < WIDE_SPAN and i + span < len(rows) and not rows[i + span - 1][3]
               and rows[i + span][0] == rows[i][0] + span):
            span += 1
        steps.append((i, span, rows[i + span - 1][3]))
        i += span
    return steps


def _chunk_layout(recs):
    """``(bands, stage_floats)`` of one wide-route chunk, ``recs`` its
    ``(r, a, b, last)`` rows: the chunk's kernel rows cut into bands of
    consecutive rows, each staged as ``rows + TILE_H - 1`` padded rows of
    two column strips (run starts ``a``, run ends ``b + 1``), each strip
    ``TILE_W`` wide plus the spread of its columns, on 16-byte bounds.
    Shared memory holds the steps' records (4 words each), then every
    band's lo and hi strips."""
    rows = {r for r, _, _, _ in recs}
    starts = sorted(r for r in rows if r - 1 not in rows)
    bands, base = [], 4 * len(_steps(recs))
    for r_s in starts:
        r_e = r_s
        while r_e + 1 in rows:
            r_e += 1
        mine = [(a, b) for r, a, b, _ in recs if r_s <= r <= r_e]
        lo_col = min(a for a, _ in mine) & ~3
        hi_col = (min(b for _, b in mine) + 1) & ~3
        lo_pitch = -(-(max(a for a, _ in mine) + TILE_W - lo_col) // 4) * 4
        hi_pitch = -(-(max(b for _, b in mine) + 1 + TILE_W - hi_col) // 4) * 4
        staged = r_e - r_s + TILE_H
        bands.append((r_s, staged, lo_col, lo_pitch, hi_col, hi_pitch, base,
                      base + staged * lo_pitch))
        base += staged * (lo_pitch + hi_pitch)
    return bands, base


def wide_plan(runs, stage_floats: int = WIDE_STAGE_FLOATS):
    """``(plan, n_chunks, n_bands, stage_floats)``: the wide route's chunks
    as ``csrc/disk_sat.cu::disk_sat_wide`` reads them, one int32 array.

    The run table's rows, in table order (groups in order, each group's
    rows in order: the twin's summation order), are cut into chunks of
    consecutive rows, each summed in steps (:func:`_steps`); a group may
    span chunks, its partial sums stay in registers. A chunk takes rows
    while its stage fits in ``stage_floats`` and no strip spreads its
    columns over more than ``WIDE_SPREAD`` (near the top and bottom of a
    disk ``a`` moves fast from row to row: a new chunk is cheaper than a
    wide strip). One row always fits in the kernel's stage (8452 floats);
    the tests pass a smaller ``stage_floats`` to replay short chunks.

    Layout: per chunk two int4 ``(rec_begin, rec_end, band_begin,
    band_end), (stage_floats, groups ending in it, 0, 0)``; per band two
    int4 ``(r_s, staged_rows, lo_col, lo_pitch), (hi_col, hi_pitch,
    lo_base, hi_base)``; per step one int4 ``(lo_off, hi_off, lo_pitch |
    hi_pitch << 16, r | (span - 1) << 28 | ends << 30)``, offsets into the
    stage of the tile's first output row and column. The returned
    ``stage_floats`` is the largest chunk's."""
    recs = [(r, a, bcol, i == len(rows) - 1)
            for a, bcol, rows in group_runs(runs) for i, r in enumerate(rows)]
    limit = TILE_W + 4 + WIDE_SPREAD
    chunks, cur, layout = [], [], ([], 0)
    for rec in recs:
        trial = _chunk_layout(cur + [rec])
        fits = trial[1] <= stage_floats and all(
            b[3] <= limit and b[5] <= limit for b in trial[0])
        if cur and not fits:
            chunks.append((cur, layout))
            cur, trial = [], _chunk_layout([rec])
        cur, layout = cur + [rec], trial
    if cur:
        chunks.append((cur, layout))
    head, band_rows, rec_rows = [], [], []
    for chunk, (bands, floats) in chunks:
        steps = _steps(chunk)
        head.append((len(rec_rows), len(rec_rows) + len(steps), len(band_rows),
                     len(band_rows) + len(bands), floats, sum(e for _, _, e in steps), 0, 0))
        for i, span, ends in steps:
            r, a, bcol, _ = chunk[i]
            band = next(b for b in bands if b[0] <= r < b[0] + b[1] - TILE_H + 1)
            r_s, _, lo_col, lo_pitch, hi_col, hi_pitch, lo_base, hi_base = band
            rec_rows.append((lo_base + (r - r_s) * lo_pitch + a - lo_col,
                             hi_base + (r - r_s) * hi_pitch + bcol + 1 - hi_col,
                             lo_pitch | hi_pitch << 16, r | (span - 1) << 28 | int(ends) << 30))
        band_rows.extend(bands)
    plan = np.concatenate([np.asarray(head, np.int32).reshape(-1),
                           np.asarray(band_rows, np.int32).reshape(-1),
                           np.asarray(rec_rows, np.int32).reshape(-1)])
    return plan, len(head), len(band_rows), max((h[4] for h in head), default=0)


def device_table(runs, kshape, device):
    """``(route, array on device, ints)``: :func:`route`'s choice for the
    kernel, with the fused route's run table and ``(n_groups, table_len)``,
    or the wide route's plan (:func:`wide_plan`) and ``(n_chunks, n_bands,
    stage_floats)``. One entry per (runs, kshape, device), built and
    uploaded once while it stays in ``TABLES``; the pads reach the kernels
    as launch arguments, so 'same' and 'valid' calls share it."""
    key = (tuple(map(tuple, runs)), tuple(kshape), torch.device(device))

    def build():
        table, n_groups = run_table(runs)
        which = route(kshape, len(table))
        if which == "fused":
            return which, upload(table, device), (n_groups, len(table))
        plan, n_chunks, n_bands, stage_floats = wide_plan(runs)
        return which, upload(plan, device), (n_chunks, n_bands, stage_floats)

    return TABLES.get(key, build)


def _out_shape(xs, kshape, pads):
    kh, kw = kshape
    (ly, hy), (lx, hx) = pads
    _, h, w = xs.shape
    return h + ly + hy - kh + 1, w + lx + hx - kw + 1


def disk_conv_sat_plain(xs: torch.Tensor, kshape, runs, pads) -> torch.Tensor:
    """Correlation of the (B, H, W) stack with a {0,1} kernel given as the
    row runs of its flipped form, zero boundary; ``pads`` =
    ``((ly, hy), (lx, hx))`` places the 'same' or 'valid' output."""
    (ly, hy), (lx, hx) = pads
    b = xs.shape[0]
    h_out, w_out = _out_shape(xs, kshape, pads)
    # sentinel zero column on the left so P[..., x+a] with a=0 reads 0
    p = torch.cumsum(F.pad(xs, (lx + 1, hx, ly, hy)), dim=2)
    acc = None
    for a, bcol, rows in group_runs(runs):
        rs = None
        for r in rows:
            sl = p[:, r : r + h_out, :]
            rs = sl if rs is None else rs + sl
        term = rs[:, :, bcol + 1 : bcol + 1 + w_out] - rs[:, :, a : a + w_out]
        acc = term if acc is None else acc + term
    if acc is None:
        acc = xs.new_zeros((b, h_out, w_out))
    return acc


def disk_conv_sat(xs: torch.Tensor, kshape, runs, pads) -> torch.Tensor:
    """:func:`disk_conv_sat_plain` on a CPU tensor; the CUDA kernel on a
    CUDA tensor, which must be a contiguous float32 (B, H, W) stack."""
    global LAUNCHES
    if not on_cuda(xs):
        return disk_conv_sat_plain(xs, kshape, runs, pads)
    if xs.dtype != torch.float32 or xs.dim() != 3 or not xs.is_contiguous():
        raise ValueError(
            "disk_conv_sat needs a contiguous float32 (B, H, W) tensor, got "
            f"{xs.dtype} {tuple(xs.shape)} contiguous={xs.is_contiguous()}"
        )
    (ly, hy), (lx, hx) = pads
    kh, kw = kshape
    b, h, w = xs.shape
    h_out, w_out = _out_shape(xs, kshape, pads)
    hp, wq = h + ly + hy, w + lx + hx + 1
    if h_out <= 0 or w_out <= 0:
        raise ValueError(f"kernel {kshape} does not fit the padded field")
    if b * hp > _INT_MAX or b > 65535 or max(hp, wq) > _INT_MAX:
        raise ValueError(f"field stack {tuple(xs.shape)} exceeds the launch grid")
    out = torch.empty((b, h_out, w_out), dtype=torch.float32, device=xs.device)
    which, table, ints = device_table(runs, kshape, xs.device)
    lib = _build.library()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if which == "fused":
            n_groups, table_len = ints
            carry = torch.empty((b, hp, -(-w_out // TILE_W)), dtype=torch.float32,
                                device=xs.device)
            err = lib.disk_sat_fused_forward(
                xs.data_ptr(), carry.data_ptr(), out.data_ptr(), table.data_ptr(),
                n_groups, table_len, b, h, w, ly, lx, hp, wq, kh, kw, h_out, w_out,
                fused_smem_bytes(kshape, table_len), stream,
            )
        else:
            n_chunks, n_bands, stage_floats = ints
            pq = -(-wq // 4) * 4  # 16-byte rows for the stages' copies
            prefix = torch.empty((b, h, pq), dtype=torch.float32, device=xs.device)
            err = lib.disk_sat_forward(
                xs.data_ptr(), prefix.data_ptr(), out.data_ptr(), table.data_ptr(),
                n_chunks, n_bands, stage_floats, b, h, w, ly, lx, wq, pq, h_out, w_out,
                stream,
            )
    _build.check(err, f"disk_sat ({which})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[which] += 1
    return out
