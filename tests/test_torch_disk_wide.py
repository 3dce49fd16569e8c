"""The wide route of the port's disk kernel, replayed on the CPU.

``csrc/disk_sat.cu::disk_sat_wide`` runs only on the card; what it reads
is the host plan ``ops/cuda/disk_sat.py::wide_plan``. :func:`replay` is a
numpy transcription of the kernel over that plan: the prefix plane of the
field rows only (its pad columns poisoned with NaN), per output tile the
chunks that meet the field staged as the kernel stages them (bands that do
not meet it left NaN), the steps summed in the kernel's order, skipping a
step wherever a warp's four output rows all miss the field. On
integer fields each prefix value is exact, and the outputs (sums past 2^24)
must give the plain twin's bits: float32 adds in any other order would
not.
"""

import numpy as np
import pytest
import torch

from topo_descriptors_tpu_torch.kernels.disk import circular_kernel
from topo_descriptors_tpu_torch.ops.conv import _binary_kernel_runs, _same_pads
from topo_descriptors_tpu_torch.ops.cuda import _build, disk_sat

TILE_H, TILE_W = disk_sat.TILE_H, disk_sat.TILE_W
ROWS_PER_WARP = 4


def _parse(plan, n_chunks, n_bands):
    chunks = plan[: 8 * n_chunks].reshape(-1, 8)
    bands = plan[8 * n_chunks : 8 * (n_chunks + n_bands)].reshape(-1, 8)
    recs = plan[8 * (n_chunks + n_bands) :].reshape(-1, 4)
    return chunks, bands, recs


def _live(band, y0, ly, h):
    r_s, staged = int(band[0]), int(band[1])
    r_e = r_s + staged - TILE_H
    return y0 + TILE_H - 1 + r_e >= ly and y0 + r_s < ly + h


def replay(xs, kshape, runs, pads, stage_floats=disk_sat.WIDE_STAGE_FLOATS):
    """The wide route's output for the (B, H, W) float32 stack ``xs``, on
    the plan for ``stage_floats`` floats per stage."""
    (ly, hy), (lx, hx) = pads
    b_n, h, w = xs.shape
    h_out, w_out = h + ly + hy - kshape[0] + 1, w + lx + hx - kshape[1] + 1
    wq = w + lx + hx + 1
    pq = -(-wq // 4) * 4
    plan, n_chunks, n_bands, stage_floats = disk_sat.wide_plan(runs, stage_floats)
    assert 2 * stage_floats * 4 <= _build.SMEM_PER_BLOCK
    chunks, bands, recs = _parse(plan, n_chunks, n_bands)
    out = np.empty((b_n, h_out, w_out), np.float32)
    rows = np.arange(TILE_H)[:, None]
    cols = np.arange(TILE_W)[None, :]
    for b in range(b_n):
        p = np.full((h, pq), np.nan, np.float32)  # pad columns: never read for an output
        p[:, :wq] = np.concatenate(
            [np.zeros((h, 1), np.float32),
             np.cumsum(np.pad(xs[b], ((0, 0), (lx, hx))), axis=1, dtype=np.float32)], axis=1)
        for y0 in range(0, h_out, TILE_H):
            for x0 in range(0, w_out, TILE_W):
                acc = np.zeros((TILE_H, TILE_W), np.float32)
                hi = np.zeros((TILE_H, TILE_W), np.float32)
                lo = np.zeros((TILE_H, TILE_W), np.float32)
                for rec0, rec1, band0, band1, _, ends, *_ in chunks:
                    if not any(_live(bands[i], y0, ly, h) for i in range(band0, band1)):
                        if ends:  # its rows add nothing here, its group ends still count
                            acc = acc + (hi - lo)
                            hi[:] = 0.0
                            lo[:] = 0.0
                        continue
                    buf = np.full(stage_floats, np.nan, np.float32)  # unstaged: poison
                    for i in range(band0, band1):
                        r_s, staged, lo_col, lo_pitch, hi_col, hi_pitch, lo_base, hi_base = bands[i]
                        if not _live(bands[i], y0, ly, h):
                            continue
                        for col, pitch, base in ((lo_col, lo_pitch, lo_base),
                                                 (hi_col, hi_pitch, hi_base)):
                            fr = y0 + r_s + np.arange(staged)[:, None] - ly
                            c = x0 + col + np.arange(pitch)[None, :]
                            ok = (fr >= 0) & (fr < h) & (c // 4 * 4 < pq)
                            vals = np.where(ok, p[np.clip(fr, 0, h - 1), np.clip(c, 0, pq - 1)], 0)
                            buf[base : base + staged * pitch] = vals.reshape(-1)
                    for lo_off, hi_off, pitches, tag in recs[rec0:rec1].tolist():
                        r, span, ends = tag & 0xFFFFFFF, (tag >> 28 & 3) + 1, tag >> 30
                        lp, hp = pitches & 0xFFFF, pitches >> 16
                        yw = y0 + rows[::ROWS_PER_WARP, 0]  # each warp's first row
                        warp_live = (yw + ROWS_PER_WARP - 1 + r + span - 1 >= ly) & (yw + r < ly + h)
                        live = np.repeat(warp_live, ROWS_PER_WARP)
                        for k in range(span):
                            vh = buf[hi_off + (rows + k) * hp + cols]
                            vl = buf[lo_off + (rows + k) * lp + cols]
                            hi[live] = hi[live] + vh[live]
                            lo[live] = lo[live] + vl[live]
                        if ends:
                            acc = acc + (hi - lo)
                            hi[:] = 0.0
                            lo[:] = 0.0
                ys, xs_ = min(TILE_H, h_out - y0), min(TILE_W, w_out - x0)
                out[b, y0 : y0 + ys, x0 : x0 + xs_] = acc[:ys, :xs_]
    return out


def _fields(shape, seed):
    """Integer fields, mostly positive, with row sums below 2^23: every
    prefix value is exact, the disk sums pass 2^24."""
    rng = np.random.default_rng(seed)
    top = (2**23 - 1) // shape[-1]
    return rng.integers(-top // 4, top, shape).astype(np.float32)


# (fields shape, disk px, exclude centre, mode)
CASES = {
    "3333px_20x30_every_output_clipped": ((1, 20, 30), 3333, False, "same"),
    "201px_50x61": ((1, 50, 61), 201, False, "same"),
    "201px_centre_excluded_40x300": ((1, 40, 300), 201, True, "same"),
    "201px_valid_240x330": ((1, 240, 330), 201, False, "valid"),
    "201px_stack3_37x150": ((3, 37, 150), 201, False, "same"),
}


# the kernel's plan, and one of chunks of a row or two: groups span chunks,
# and chunks that miss the field still end groups
@pytest.mark.parametrize("stage_floats", [disk_sat.WIDE_STAGE_FLOATS, 8452],
                         ids=["full_stage", "short_chunks"])
@pytest.mark.parametrize("case", list(CASES))
def test_wide_replay_gives_the_twins_bits(case, stage_floats):
    shape, size, centre, mode = CASES[case]
    kernel = circular_kernel(size, exclude_center=centre)
    runs = _binary_kernel_runs(kernel[::-1, ::-1])
    pads = ((_same_pads(size), _same_pads(size)) if mode == "same" else ((0, 0), (0, 0)))
    assert disk_sat.route(kernel.shape, len(disk_sat.run_table(runs)[0])) == "wide"
    xs = _fields(shape, size)
    plain = disk_sat.disk_conv_sat_plain(torch.from_numpy(xs), kernel.shape, runs, pads).numpy()
    assert np.abs(plain).max() > 2**24  # float32 sums that are exact only in one order
    got = replay(xs, kernel.shape, runs, pads, stage_floats)
    assert got.shape == plain.shape
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))


@pytest.mark.parametrize("size", [201, 333, 667, 1001, 2001, 3333])
@pytest.mark.parametrize("centre", [False, True], ids=["disk", "centre_excluded"])
def test_wide_plan_two_stages_fit(size, centre):
    """Every disk the batch sends to the wide route: two stages fit in one
    block's shared memory, no strip is wider than the tile plus the spread,
    every step points inside its stage, and the steps walk the run table's
    rows in table order, each group's end tagged."""
    runs = _binary_kernel_runs(circular_kernel(size, exclude_center=centre)[::-1, ::-1])
    plan, n_chunks, n_bands, stage_floats = disk_sat.wide_plan(runs)
    assert 2 * stage_floats * 4 <= _build.SMEM_PER_BLOCK
    chunks, bands, recs = _parse(plan, n_chunks, n_bands)
    assert (bands[:, 3] <= TILE_W + 4 + disk_sat.WIDE_SPREAD).all()
    assert (bands[:, 5] <= TILE_W + 4 + disk_sat.WIDE_SPREAD).all()
    assert (bands[:, 2:8] % 4 == 0).all()  # 16-byte copies
    assert chunks[0, 0] == 0 and (chunks[1:, 0] == chunks[:-1, 1]).all()
    assert chunks[-1, 1] == len(recs)
    for rec0, rec1, _, _, floats, *_ in chunks:
        assert floats <= stage_floats
        pitches, last_row = recs[rec0:rec1, 2], TILE_H - 1 + (recs[rec0:rec1, 3] >> 28 & 3)
        assert (recs[rec0:rec1, :2] >= 4 * (rec1 - rec0)).all()
        assert (recs[rec0:rec1, 0] + last_row * (pitches & 0xFFFF) + TILE_W <= floats).all()
        assert (recs[rec0:rec1, 1] + last_row * (pitches >> 16) + TILE_W <= floats).all()
    table, n_groups = disk_sat.run_table(runs)
    rows, ends = [], []
    for tag in recs[:, 3].tolist():
        r, span = tag & 0xFFFFFFF, (tag >> 28 & 3) + 1
        rows += list(range(r, r + span))
        if tag >> 30:
            ends.append(len(rows) - 1)
    assert rows == table[4 * n_groups :].tolist()
    assert ends == (table[: 4 * n_groups].reshape(-1, 4)[:, 3] - 1).tolist()


def test_wide_plan_is_uploaded_once_per_table():
    """A wide kernel's plan is its one entry in ``TABLES``, in place of the
    run table: built and uploaded once per (runs, kernel shape, device),
    whatever the pads, since they reach the kernel as launch arguments."""
    disk_sat.TABLES.clear()
    before = disk_sat.TABLES.builds
    runs = _binary_kernel_runs(circular_kernel(201)[::-1, ::-1])
    first = disk_sat.device_table(runs, (201, 201), "cpu")
    again = disk_sat.device_table(list(runs), [201, 201], torch.device("cpu"))
    assert again is first and disk_sat.TABLES.builds == before + 1
    assert len(disk_sat.TABLES) == 1
    plan, n_chunks, n_bands, stage_floats = disk_sat.wide_plan(runs)
    assert first[0] == "wide"
    np.testing.assert_array_equal(first[1].numpy(), plan)
    assert first[2] == (n_chunks, n_bands, stage_floats)
