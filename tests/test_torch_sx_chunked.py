"""The chunked route of the port's Sx kernels, replayed on the CPU.

``csrc/sx_chunked.cuh`` (the chunked route of ``sx_block`` and of
``sx_fan``) runs only on the card; what it reads is the host plan
``ops/cuda/sx_block.py::chunk_plan``. :func:`replay` is a numpy
transcription of the kernel over the plan's words: per 32 x 64 output tile,
each chunk's table taken from the plan, its box staged from the DEM with
NaN outside the grid, the rays read at the flat offsets the kernel reads
(``at + soff``), the segments run in order, the running max of a group that
a chunk boundary splits carried into the next chunk, and the maxima kept
across chunks. Its max-ratio plane must equal the plain twin's
(``sx_block.max_ratio_plain``) bit for bit: fmax picks one of its operands
and both sides compute the same float32 ratios, so any other order or a
lost or doubled ray would show only where it changes a maximum, and the
DEMs below make far rays win often. The plans are replayed at the stage
the cost model picks and at a stage so short that chunks end inside
groups.

Beside it: the plan's invariants (every ray once and in order, every stage
within its budget, the routes by radius and azimuth), the fan's plan
against the per-azimuth plans, and the port's Sx at 10 km against the JAX
package. The JAX side runs ``method='xla'``: its Pallas kernel under the
interpreter would compile one static slice per ray (3381 at 10 km).
Tolerance against JAX: ``tests/test_torch_sx.py``'s 2e-5 degrees (both
sides compute the same float32 ratios and differ only in ``atan``), NaN
positions identical.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_descriptors_tpu import kernels as jkernels
from topo_descriptors_tpu import ops as jops
from topo_descriptors_tpu_torch import ops as tops
from topo_descriptors_tpu_torch import pipeline as tpipe
from topo_descriptors_tpu_torch.host import (Raster, RasterGrid, read_raster, sx_dedupe,
                                             sx_offsets, sx_sweep_dedupe, sx_sweep_offsets)
from topo_descriptors_tpu_torch.ops.cuda import _build, sx_block, sx_sweep

TILE_H, TILE_W = sx_block.TILE_H, sx_block.TILE_W
JAX_ATOL = 2e-5
SHORT_STAGE = 20 * 1024  # chunks of a few hundred rays: many end inside a group


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The replays and twins issue thousands of small ops; with several
    test workers on the machine an intra-op thread team per op
    oversubscribes the cores (as in tests/test_torch_pipeline.py), so these
    tests run torch on one intra-op thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _dem(shape, seed):
    """A bowl rising ~30 m per pixel from its centre, with 200 m of noise:
    from most pixels the far rays climb the most, so every distance band
    sets some maxima."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[: shape[0], : shape[1]]
    bowl = 0.25 * ((y - shape[0] / 3) ** 2 + (x - shape[1] / 2) ** 2)
    return (1000.0 + bowl + rng.uniform(0.0, 200.0, shape)).astype(np.float32)


def _rays(azimuth, radius, dy=30.0, radius_min=0.0):
    o, d, b = sx_offsets(azimuth, radius, 30.0, dy, radius_min=radius_min)
    return (*sx_dedupe(o, d), b)


def _parse(plan, n_az):
    head = -(-(n_az + 1) // 4) * 4
    return plan[: n_az + 1], plan[head : head + 8 * int(plan[n_az])].reshape(-1, 8)


def replay_items(dem, plan, n_az, ranges, height=10.0):
    """The running maxima the chunked kernel computes from ``plan`` over each
    range ``(c0, c1)`` of its chunks, from -inf (one plane per range), and
    the chunks that set some in-grid maximum."""
    h, w = dem.shape
    _, recs = _parse(plan, n_az)
    ty, tx = -(-h // TILE_H), -(-w // TILE_W)
    pad = int(np.abs(recs[:, 4:6]).max(initial=0)) + 1
    big = np.full((ty * TILE_H + 2 * pad + max(int(recs[:, 6].max(initial=0)), 0),
                   tx * TILE_W + 2 * pad + max(int(recs[:, 7].max(initial=0)), 0)),
                  np.nan, np.float32)
    big[pad : pad + h, pad : pad + w] = dem
    yl, xl = np.mgrid[:TILE_H, :TILE_W]
    ys = (np.arange(ty) * TILE_H)[:, None, None, None] + yl
    xs = (np.arange(tx) * TILE_W)[None, :, None, None] + xl
    inside = ((ys < h) & (xs < w)).reshape(ty * tx, -1)
    base = np.where(inside, big[pad + ys, pad + xs].reshape(ty * tx, -1) + np.float32(height),
                    np.float32(0.0))
    planes, live = [], []
    for c0, c1 in ranges:
        acc = np.full(base.shape, -np.inf, np.float32)
        best = np.full(base.shape, np.nan, np.float32)
        with np.errstate(invalid="ignore"):  # the distance-0 quirk: 0 * inf
            for c in range(c0, c1):
                word, n, n_seg, flags, oy0, ox0, sh, sw = (int(v) for v in recs[c])
                table = plan[word : word + sx_block._table_words(n, n_seg)]
                soff, gp = table[:n], table[n : n + n_seg + 1]
                inv = table[n + n_seg + 1 : n + 2 * n_seg + 1].view(np.float32)
                windows = np.lib.stride_tricks.sliding_window_view(big, (sh, sw))
                boxes = windows[pad + oy0 :: TILE_H, pad + ox0 :: TILE_W][:ty, :tx]
                boxes = boxes.reshape(ty * tx, sh * sw)
                at = (yl * sw + xl).reshape(-1)
                assert soff.min(initial=0) >= 0 and at.max() + soff.max(initial=0) < sh * sw
                before = acc.copy()
                for g in range(n_seg):
                    k, k1 = int(gp[g]), int(gp[g + 1])
                    if g > 0 or not flags & sx_block.CARRY_IN:
                        best = boxes[:, at + soff[k]]
                        k += 1
                    for kk in range(k, k1):
                        best = np.fmax(best, boxes[:, at + soff[kk]])
                    if flags & sx_block.CARRY_OUT and g == n_seg - 1:
                        break
                    acc = np.fmax(acc, (best - base) * inv[g])
                if (acc[inside] != before[inside]).any():
                    live.append(c)
        plane = acc.reshape(ty, tx, TILE_H, TILE_W).transpose(0, 2, 1, 3)
        planes.append(plane.reshape(ty * TILE_H, tx * TILE_W)[:h, :w])
    return planes, live


def replay(dem, plan, n_az, a, height=10.0):
    """Azimuth ``a``'s max-ratio plane as the chunked kernel computes it from
    ``plan``, and the chunks that set some in-grid maximum."""
    az_chunk, _ = _parse(plan, n_az)
    planes, live = replay_items(dem, plan, n_az, [(az_chunk[a], az_chunk[a + 1])], height)
    return planes[0], live


def replay_split(dem, plan, n_az, items, a, height=10.0):
    """Azimuth ``a``'s max-ratio plane as ``sx_sweep``'s chunked route
    computes it on a split plan: each of the azimuth's work items ``(a, c0,
    c1, s)`` replayed alone from -inf, then the fmax over them in split
    order (``sx_sweep_combine``)."""
    mine = items[items[:, 0] == a]
    np.testing.assert_array_equal(mine[:, 3], np.arange(len(mine)))
    planes, _ = replay_items(dem, plan, n_az, [(c0, c1) for _, c0, c1, _ in mine], height)
    out = np.full(dem.shape, -np.inf, np.float32)
    for part in planes:
        out = np.fmax(out, part)
    return out


def _twin(dem, o, d, b):
    return sx_block.max_ratio_plain(torch.from_numpy(dem), o, d, b, 10.0).numpy()


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


# (azimuth, radius m, dy, radius_min m, grid): 10 and 20 km at every side of
# the wedge on a ragged grid, north-up, radius_min, the distance-0 fan, and
# a grid smaller than every box
CASES = {
    **{f"r{r // 1000}km_az{az}": (az, r, 30.0, 0.0, (100, 150))
       for r in (10_000, 20_000) for az in (0, 30, 45, 90, 180, 270)},
    "r10km_az45_northup": (45, 10_000, -30.0, 0.0, (100, 150)),
    "r10km_az30_northup": (30, 10_000, -30.0, 0.0, (100, 150)),
    "r10km_az45_radius_min100": (45, 10_000, 30.0, 100.0, (100, 150)),
    "r250_az225_distance0": (225, 250, 30.0, 0.0, (100, 150)),
    "r10km_az45_50x61": (45, 10_000, 30.0, 0.0, (50, 61)),
    "r20km_az45_50x61": (45, 20_000, 30.0, 0.0, (50, 61)),
    "r10km_az45_260x300": (45, 10_000, 30.0, 0.0, (260, 300)),  # every band inside
}


@functools.lru_cache(maxsize=None)
def _case(case):
    """(DEM, offsets, distances, border, the twin's max-ratio plane) of a
    case of ``CASES``, computed once per test process."""
    azimuth, radius, dy, radius_min, shape = CASES[case]
    o, d, b = _rays(azimuth, radius, dy, radius_min)
    dem = _dem(shape, seed=len(case))
    return dem, o, d, b, _twin(dem, o, d, b)


@pytest.mark.parametrize("stage", [None, SHORT_STAGE], ids=["model_stage", "short_stage"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunk_replay_gives_the_twins_bits(case, stage):
    radius, shape = CASES[case][1], CASES[case][4]
    dem, o, d, b, twin = _case(case)
    if case.endswith("distance0"):
        assert (d == 0).any()
    plan, n_chunks, _ = sx_block.chunk_plan([sx_block.ray_groups(o, d)], stage)
    got, live = replay(dem, plan, 1, 0)
    np.testing.assert_array_equal(_bits(got), _bits(twin))
    _, recs = _parse(plan, 1)
    if stage == SHORT_STAGE and radius >= 10_000:  # short stages split groups
        assert (recs[:, 3] & sx_block.CARRY_OUT).any()
    if shape == (260, 300) and stage is None:  # every band inside: each chunk sets maxima
        assert live == list(range(n_chunks)) and n_chunks >= 3, (live, n_chunks)
    elif shape == (100, 150) and radius == 10_000 and stage == SHORT_STAGE:
        assert len(live) >= 3, (live, n_chunks)


@pytest.mark.parametrize("splits", [1, 2, 3, "most"])
@pytest.mark.parametrize("stage", [None, SHORT_STAGE], ids=["model_stage", "short_stage"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_replay_gives_the_twins_bits(case, stage, splits):
    """``sx_sweep``'s chunked route on a split plan (``split_plan`` with S
    forced: 1, 2, 3, and one work item per group start): each work item
    replayed alone from -inf, then the fmax over the azimuth's items, gives
    the twin's plane bit for bit, on the model's stage and on a stage so
    short that chunks end inside groups."""
    dem, o, d, b, twin = _case(case)
    plan, n_chunks, _ = sx_block.chunk_plan([sx_block.ray_groups(o, d)], stage)
    _, recs = _parse(plan, 1)
    starts = int(((recs[:, 3] & sx_block.CARRY_IN) == 0).sum())
    n = n_chunks if splits == "most" else splits
    items, per_az, _ = sx_block.split_plan(plan, 1, 1, 132, 3, n)
    assert per_az.tolist() == [max(1, min(n, starts))] and len(items) == per_az[0]
    np.testing.assert_array_equal(_bits(replay_split(dem, plan, 1, items, 0)), _bits(twin))


@pytest.mark.parametrize("radius,azimuth", [(10_000, 45), (20_000, 45), (20_000, 0)])
def test_splits_start_at_group_starts(radius, azimuth):
    """With ``SHORT_STAGE`` some chunk boundaries fall inside distance
    groups (chunks with ``CARRY_IN``); no work item starts at one, whatever
    S, and the items cover the azimuth's chunks once, in order."""
    o, d, _ = _rays(azimuth, radius)
    plan, n_chunks, _ = sx_block.chunk_plan([sx_block.ray_groups(o, d)], SHORT_STAGE)
    _, recs = _parse(plan, 1)
    carry = (recs[:, 3] & sx_block.CARRY_IN) != 0
    assert carry.any() and not carry[0]
    for n in (2, 3, 5, 8, n_chunks):
        items, per_az, _ = sx_block.split_plan(plan, 1, 1, 132, 3, n)
        assert len(items) == per_az[0] == min(n, int((~carry).sum())) and per_az[0] >= 2
        assert not carry[items[:, 1]].any()
        assert items[0, 1] == 0 and items[-1, 2] == n_chunks
        assert (items[1:, 1] == items[:-1, 2]).all() and (items[:, 2] > items[:, 1]).all()


@pytest.mark.parametrize("stage", [*sx_block.CHUNK_STAGES.values(), SHORT_STAGE, 2048],
                         ids=["one_block_stage", "two_block_stage", "three_block_stage",
                              "short_stage", "one_ray_stage"])
@pytest.mark.parametrize("radius,azimuth", [(5000, 45), (10_000, 0), (10_000, 45),
                                            (20_000, 30)])
def test_plan_covers_every_ray_once_in_order(radius, azimuth, stage):
    """The chunks cut the grouped rays into consecutive runs: each ray once,
    in order, at its offset in its chunk's box; each segment a run of its
    group with the group's 1/d; the flags set exactly where a group crosses
    a chunk boundary; every stage within the budget, and two in a block."""
    o, d, _ = _rays(azimuth, radius)
    offs, ptr, inv = sx_block.ray_groups(o, d)
    if stage == 2048:  # a stage that holds one ray's box and little more
        stage = 4 * (TILE_H * TILE_W + 4) + 4 * 4 * (TILE_H + TILE_W)
    plan, n_chunks, stage_floats = sx_block.chunk_plan([(offs, ptr, inv)], stage)
    az_chunk, recs = _parse(plan, 1)
    assert tuple(az_chunk) == (0, n_chunks) and len(recs) == n_chunks
    assert stage_floats % 4 == 0 and 4 * stage_floats <= stage
    assert 2 * 4 * stage_floats <= _build.SMEM_PER_BLOCK
    group = np.repeat(np.arange(len(inv)), np.diff(ptr))
    k = 0
    for c, (word, n, n_seg, flags, oy0, ox0, sh, sw) in enumerate(recs):
        words = sx_block._table_words(n, n_seg)
        assert word % 4 == 0 and words + sh * sw <= stage_floats
        table = plan[word : word + words]
        row, col = np.divmod(table[:n], sw)
        np.testing.assert_array_equal(row + oy0, offs[k : k + n, 0])
        np.testing.assert_array_equal(col + ox0, offs[k : k + n, 1])
        assert row.max() <= sh - TILE_H and col.max() <= sw - TILE_W
        gp = table[n : n + n_seg + 1]
        assert gp[0] == 0 and gp[-1] == n and (np.diff(gp) > 0).all()
        segs = group[k + gp[:-1]]
        np.testing.assert_array_equal(segs, np.arange(segs[0], segs[0] + n_seg))
        np.testing.assert_array_equal(table[n + n_seg + 1 : n + 2 * n_seg + 1].view(np.float32),
                                      inv[segs])
        assert bool(flags & sx_block.CARRY_IN) == (k > 0 and group[k - 1] == group[k])
        end = k + n
        assert bool(flags & sx_block.CARRY_OUT) == (end < len(offs)
                                                     and group[end] == group[end - 1])
        k = end
    assert k == len(offs)


def test_model_picks_the_stage():
    """The stage the cost model picks: three blocks per SM at 10 km (its
    plans barely grow as the stage shrinks), two at 20 km and 45 degrees,
    where three would cut the wedge's far arcs into ~900 chunks, and the
    largest stage where a launch fills only one block per SM; every stage
    fits twice in a block and its blocks in an SM."""
    for n, stage in sx_block.CHUNK_STAGES.items():
        assert 2 * stage <= _build.SMEM_PER_BLOCK and n * (2 * stage + 1024) <= _build.SMEM_PER_SM
    for azimuth, radius, blocks in ((45, 10_000, 3), (30, 10_000, 3), (45, 20_000, 2)):
        tables = [sx_block.ray_groups(*_rays(azimuth, radius)[:2])]
        for max_blocks, want_blocks in ((None, blocks), (1, 1)):
            plan, n_chunks, stage_floats = sx_block.chunk_plan(tables, max_blocks=max_blocks)
            want = sx_block.chunk_plan(tables, sx_block.CHUNK_STAGES[want_blocks])
            np.testing.assert_array_equal(plan, want[0])
            assert (n_chunks, stage_floats) == want[1:]


@pytest.mark.parametrize("shape,border,zero_border,blocks", [
    ((900, 1440), 334, True, 1),  # 104 tiles meet the 10 km interior: under one per SM
    ((900, 1440), 334, False, 3),  # 667 tiles
    ((8192, 8192), 334, True, 3),
    ((50, 61), 334, True, 1),  # no interior at all
])
def test_busy_blocks_follow_the_interior(shape, border, zero_border, blocks):
    assert sx_block.busy_blocks_per_sm(shape, border, zero_border, 132) == blocks


def test_plan_routes_and_limits():
    """The tile route where the whole box fits (5 km at 45 degrees, 10 km
    along an axis), the chunked route where it does not (10 km at 45 and
    30 degrees, 20 km); a stage that holds no single ray's box is refused;
    a fan without rays has no chunk."""
    for azimuth, radius, want in ((45, 5000, "tile"), (0, 10_000, "tile"),
                                  (45, 10_000, "chunked"), (30, 10_000, "chunked"),
                                  (0, 20_000, "chunked")):
        offs, ptr, inv = sx_block.ray_groups(*_rays(azimuth, radius)[:2])
        assert sx_block.route(sx_block.halo_box(offs), len(offs), len(inv)) == want
    offs, ptr, inv = sx_block.ray_groups(*_rays(45, 10_000)[:2])
    with pytest.raises(ValueError, match="no single ray"):
        sx_block.chunk_plan([(offs, ptr, inv)], 4 * TILE_H * TILE_W)
    empty = (np.zeros((0, 2), np.int32), np.zeros(1, np.int32), np.zeros(0, np.float32))
    plan, n_chunks, stage_floats = sx_block.chunk_plan([empty])
    assert (n_chunks, stage_floats) == (0, 0) and list(plan) == [0, 0, 0, 0]


def test_chunk_plans_are_uploaded_once():
    sx_block.TABLES.clear()
    before = sx_block.TABLES.builds
    o, d, b = _rays(45, 10_000)
    first = sx_block.device_plan(o, d, b, "cpu")
    assert sx_block.device_plan(o.copy(), d.copy(), b, torch.device("cpu")) is first
    assert sx_block.TABLES.builds == before + 1
    np.testing.assert_array_equal(first[0].numpy(),
                                  sx_block.chunk_plan([sx_block.ray_groups(o, d)])[0])
    assert sx_block.device_plan(o, d, b, "cpu", SHORT_STAGE) is not first
    assert sx_block.TABLES.builds == before + 2


@pytest.mark.parametrize("dy", [30.0, -30.0], ids=["south_up", "north_up"])
def test_fan_plan_replays_each_azimuth(dy):
    """The fan's chunked plan (``sx_sweep.fan_tables`` at 10 km) holds each
    azimuth's chunks as ``sx_block``'s plan of that azimuth alone does: the
    replays of both give the twin's plane bit for bit."""
    azimuths = (0.0, 45.0, 130.0, 300.0)
    o, d, b = sx_sweep_offsets(azimuths, 10_000.0, 30.0, dy)
    o, d = sx_sweep_dedupe(o, d)
    t = sx_sweep.fan_tables(o, d, "cpu")
    assert sx_sweep.route(t.fan_smem) == "chunked"
    assert 2 * 4 * t.fan_plan.stage_floats <= _build.SMEM_PER_BLOCK
    plan = t.fan_plan.plan.numpy()
    az_chunk, _ = _parse(plan, len(azimuths))  # one work item per azimuth: all its chunks
    np.testing.assert_array_equal(t.fan_plan.items.numpy(),
                                  [(a, az_chunk[a], az_chunk[a + 1], 0)
                                   for a in range(len(azimuths))])
    assert t.fan_plan.splits.tolist() == [1] * len(azimuths) and t.fan_plan.max_splits == 1
    dem = _dem((64, 96), seed=7)
    for a in range(len(azimuths)):
        real = ~np.isnan(d[a])  # the pad rows' NaN distances: dropped, as ray_groups drops them
        one, _, _ = sx_block.chunk_plan([sx_block.ray_groups(o[a][real], d[a][real])])
        got, _ = replay(dem, plan, len(azimuths), a)
        alone, _ = replay(dem, one, 1, 0)
        np.testing.assert_array_equal(_bits(got), _bits(alone))
        np.testing.assert_array_equal(_bits(got), _bits(_twin(dem, o[a], d[a], b)))


@pytest.mark.parametrize("dy", [30.0, -30.0], ids=["south_up", "north_up"])
def test_sweep_plan_replays_each_azimuth(dy):
    """The sweep's split plan of a 10 km fan (``sx_block.sweep_plan``'s
    chunks, cut by ``split_plan`` into three work items per azimuth where
    its group starts allow): the fmax over each azimuth's items, each
    replayed alone, gives the twin's plane bit for bit."""
    azimuths = (0.0, 45.0, 130.0, 300.0)
    o, d, b = sx_sweep_offsets(azimuths, 10_000.0, 30.0, dy)
    o, d = sx_sweep_dedupe(o, d)
    tables = sx_sweep.azimuth_tables(*sx_sweep.sweep_tables(o, d))
    plan, stage_floats, _, _ = sx_block.sweep_plan(tables, 6, 132)
    items, per_az, _ = sx_block.split_plan(plan, len(azimuths), 6, 132, 3, 3)
    az_chunk, recs = _parse(plan, len(azimuths))
    starts = [int(((recs[c0:c1, 3] & sx_block.CARRY_IN) == 0).sum())
              for c0, c1 in zip(az_chunk[:-1], az_chunk[1:])]
    assert per_az.tolist() == [min(3, n) for n in starts] and (per_az >= 2).all()
    assert 2 * 4 * stage_floats <= _build.SMEM_PER_BLOCK
    dem = _dem((64, 96), seed=8)
    for a in range(len(azimuths)):
        got = replay_split(dem, plan, len(azimuths), items, a)
        np.testing.assert_array_equal(_bits(got), _bits(_twin(dem, o[a], d[a], b)))


AZIMUTHS36 = tuple(range(0, 360, 10))


# (azimuths, grid, zero_border, whether the model splits): the SMs idle at
# 10 km on 900 x 1440 (104 tiles meet the interior) for one azimuth; full
# with 36 azimuths, at 8192^2 and without the zero border (667 tiles)
@pytest.mark.parametrize("azimuths,shape,zero_border,split", [
    ((45.0,), (900, 1440), True, True),
    ((0.0, 45.0), (900, 1440), True, True),
    (AZIMUTHS36, (900, 1440), True, False),
    ((45.0,), (8192, 8192), True, False),
    ((0.0, 45.0), (8192, 8192), True, False),
    ((0.0, 45.0), (900, 1440), False, False),
], ids=["az45_900x1440", "az0_45_900x1440", "36az_900x1440", "az45_8192", "az0_45_8192",
        "az0_45_900x1440_nozero"])
def test_split_plan_follows_the_grid(azimuths, shape, zero_border, split):
    """The model's split plan at 10 km: each azimuth's work items cover its
    chunks once, in order, each starting at a group start and numbered in
    order; S > 1 only where the unsplit launch leaves SMs idle. With S = 1
    everywhere the plan is the fan's (``chunk_plan``'s stage)."""
    o, d, b = sx_sweep_offsets(azimuths, 10_000.0, 30.0, 30.0)
    o, d = sx_sweep_dedupe(o, d)
    tables = sx_sweep.azimuth_tables(*sx_sweep.sweep_tables(o, d))
    tiles = sx_block.busy_tiles(shape, b, zero_border)
    plan, _, items, per_az = sx_block.sweep_plan(tables, tiles, 132)
    az_chunk, recs = _parse(plan, len(azimuths))
    for a in range(len(azimuths)):
        mine = items[items[:, 0] == a]
        assert len(mine) == per_az[a] and (mine[:, 3] == np.arange(len(mine))).all()
        assert mine[0, 1] == az_chunk[a] and mine[-1, 2] == az_chunk[a + 1]
        assert (mine[1:, 1] == mine[:-1, 2]).all() and (mine[:, 2] > mine[:, 1]).all()
        assert not (recs[mine[:, 1], 3] & sx_block.CARRY_IN).any()
    assert (per_az.max() > 1) == split, per_az
    if not split:
        np.testing.assert_array_equal(plan, sx_block.chunk_plan(tables)[0])


def test_sweep_plans_are_kept_with_the_fan_tables():
    """The sweep's plan is built once per fan, grid shape, zero border and
    SM count, and kept with the fan's tables in ``sx_sweep.TABLES``: a
    second call builds and uploads nothing."""
    sx_sweep.TABLES.clear()
    before = sx_sweep.TABLES.builds
    o, d, b = sx_sweep_offsets((0.0, 45.0), 10_000.0, 30.0, 30.0)
    o, d = sx_sweep_dedupe(o, d)
    first = sx_sweep.device_sweep_plan(o, d, b, "cpu", (900, 1440), True, 132)
    again = sx_sweep.device_sweep_plan(o.copy(), d.copy(), b, torch.device("cpu"), (900, 1440),
                                       True, 132)
    t = sx_sweep.device_tables(o, d, b, "cpu")
    assert again is first and sx_sweep.TABLES.builds == before + 1
    assert sx_sweep.device_sweep_plan(o, d, b, "cpu", (900, 1440), True, 132, tables=t) is first
    tables = sx_sweep.azimuth_tables(*sx_sweep.sweep_tables(o, d))
    plan, stage_floats, items, per_az = sx_block.sweep_plan(
        tables, sx_block.busy_tiles((900, 1440), b, True), 132)
    np.testing.assert_array_equal(first.plan.numpy(), plan)
    np.testing.assert_array_equal(first.items.numpy(), items)
    assert first.stage_floats == stage_floats and first.max_splits == per_az.max() > 1
    for args in (((900, 1400), True, 132), ((900, 1440), False, 132), ((900, 1440), True, 114)):
        assert sx_sweep.device_sweep_plan(o, d, b, "cpu", *args) is not first
    assert len(t.sweep_plans) == 4 and sx_sweep.TABLES.builds == before + 1


@pytest.mark.parametrize("shape,zero_border,box", [
    ((900, 1440), True, (320, 320, 256, 832)),  # the 104 tiles that meet the interior
    ((678, 678), True, (320, 320, 32, 64)),  # one busy tile
    ((678, 678), False, (0, 0, 678, 678)),
    ((600, 601), True, (0, 0, 0, 0)),  # no tile meets the interior
])
def test_busy_box_holds_the_busy_tiles(shape, zero_border, box):
    """The box of the tiles that read rays at 10 km (border 334): it holds
    the interior, its tiles are ``busy_tiles``, and a grid without an
    interior has none."""
    b = 334
    assert sx_block.busy_box(shape, b, zero_border) == box
    y0, x0, rows, cols = box
    assert sx_block.busy_tiles(shape, b, zero_border) == -(-rows // TILE_H) * -(-cols // TILE_W)
    if zero_border and rows:
        assert y0 <= b and x0 <= b and y0 + rows >= shape[0] - b and x0 + cols >= shape[1] - b
        assert y0 % TILE_H == 0 and x0 % TILE_W == 0


def test_split_workspace_covers_the_busy_tiles_only():
    """Where the split plan cuts azimuths (two azimuths at 10 km on a grid
    with one busy tile), its workspace holds S planes per azimuth of that
    tile alone, not of the grid; a plan of one item per azimuth has none."""
    o, d, b = sx_sweep_offsets((0.0, 45.0), 10_000.0, 30.0, 30.0)
    o, d = sx_sweep_dedupe(o, d)
    p = sx_sweep.device_sweep_plan(o, d, b, "cpu", (678, 678), True, 132)
    assert p.max_splits > 1 and len(p.items) > 2
    shape = sx_sweep.workspace_shape(p, (678, 678), b, True)
    assert shape == (p.max_splits, 2, TILE_H, TILE_W)
    assert 4 * np.prod(shape) <= 4 * p.max_splits * 2 * TILE_H * TILE_W
    full = sx_sweep.device_sweep_plan(o, d, b, "cpu", (8192, 8192), True, 132)
    assert full.max_splits == 1 and sx_sweep.workspace_shape(full, (8192, 8192), b, True) is None


def test_sweep_at_10km_matches_jax():
    """The port's ``ops.sx_sweep(method='pallas_sweep')`` at 10 km (the
    sweep's chunked route on the card, the twin here) against the JAX
    package's ``ops.sx_sweep(method='xla')`` on the 90 m grid of
    ``test_drivers_at_10km_match_jax``, north-up as the drivers build it."""
    data = _dem((240, 272), seed=11)
    azimuths = [0, 45, 130, 300]
    o, d, b = jkernels.sx_sweep_offsets(azimuths, 10_000.0, 90.0, -90.0)
    port = tops.sx_sweep(data, o, d, b, 10.0, method="pallas_sweep", device="cpu").numpy()
    ref = np.asarray(jops.sx_sweep(jnp.asarray(data), o, d, b, 10.0, method="xla"))
    assert port.shape == ref.shape == (4, 240, 272) and b == 112
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_allclose(port, ref, rtol=0, atol=JAX_ATOL)
    interior = port[:, b:-b, b:-b]
    assert np.isfinite(interior).all() and (interior != 0).any()


@pytest.mark.parametrize("azimuth", [45.0, 30.0])
def test_sx_at_10km_matches_jax(azimuth):
    """The port's ``ops.sx`` at 10 km (the chunked route on the card, the
    twin here) against the JAX package's ``method='xla'`` on a 96 x 128
    grid, the geometry of a north-up grid as the drivers build it, without
    the zero border (a 333-px border would zero the whole grid)."""
    dem = _dem((96, 128), seed=int(azimuth))
    o, d, b = jkernels.sx_offsets(azimuth, 10_000.0, 30.0, -30.0)
    port = tops.sx(dem, o, d, b, 10.0, zero_border=False, device="cpu").numpy()
    ref = np.asarray(jops.sx(jnp.asarray(dem), o, d, b, 10.0, method="xla", zero_border=False))
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_allclose(port, ref, rtol=0, atol=JAX_ATOL)
    assert np.isfinite(port).mean() > 0.9


def _raster(data, res):
    ny, nx = data.shape
    grid = RasterGrid(y=np.arange(ny, dtype=np.float64)[::-1] * res + 5_100_000.0,
                      x=np.arange(nx, dtype=np.float64) * res + 680_000.0, crs="epsg:32632")
    return Raster(data=data, grid=grid, name="DEM", units="m")


def test_drivers_at_10km_match_jax(tmp_path):
    """``compute_sx`` at azimuth 45 and a 4-azimuth ``compute_sx_sweep`` at
    10 km through the port's drivers, against the JAX package's ``ops.sx``
    and ``ops.sx_sweep`` (``method='xla'``) on the drivers' geometry. The
    grid has 90 m pixels, so that its interior survives the 112-px zero
    border at a size the CPU twin runs in a second; on the card the same
    calls at 30 m take the chunked routes (``chip_smoke.py`` phase 4)."""
    data = _dem((240, 272), seed=11)
    dem = _raster(data, 90.0)
    jdem = jnp.asarray(data)
    azimuths = [0, 45, 130, 300]
    files = tpipe.compute_sx(dem, 45, 10_000, outdir=tmp_path / "sx", device="cpu")
    files += tpipe.compute_sx_sweep(dem, azimuths, 10_000, outdir=tmp_path / "sweep",
                                    device="cpu")
    o, d, b = jkernels.sx_offsets(45.0, 10_000.0, 90.0, -90.0)
    refs = {"SX_RADIUS10000_AZIMUTH45": np.asarray(jops.sx(jdem, o, d, b, 10.0, method="xla"))}
    so, sd, sb = jkernels.sx_sweep_offsets(azimuths, 10_000.0, 90.0, -90.0)
    sweep = np.asarray(jops.sx_sweep(jdem, so, sd, sb, 10.0, method="xla"))
    assert b == sb == 112
    names = ["SX_RADIUS10000_AZIMUTH45"]
    for a, az in enumerate(azimuths):
        names.append(f"SX_RADIUS10000_AZIMUTH{az}")
        refs[f"sweep/{names[-1]}"] = sweep[a]
    for i, f in enumerate(files):
        port = read_raster(f)
        ref = refs[names[i] if i == 0 else f"sweep/{names[i]}"]
        assert port.name == names[i]
        np.testing.assert_array_equal(np.isnan(port.data), np.isnan(ref))
        np.testing.assert_allclose(port.data, ref, rtol=0, atol=JAX_ATOL)
        interior = port.data[b:-b, b:-b]
        assert interior.size and np.isfinite(interior).all() and (interior != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dy", [30.0, -30.0], ids=["south_up", "north_up"])
def test_chunked_kernel_plans_agree_on_cuda(dy):
    """On the card: the chunked route at 10 km (45 degrees) on a ragged grid
    against the twin, its short-stage plan (chunks ending inside groups)
    and its plan of one chunk at 2000 m against the default plan and the
    tile route, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dem = torch.from_numpy(_dem((300, 410), seed=5)).cuda()
    o, d, b = _rays(45, 10_000, dy)
    before = dict(sx_block.ROUTE_LAUNCHES)
    out = sx_block.sx_block(dem, o, d, b, 10.0, zero_border=False)
    short = sx_block.sx_block_chunked(dem, o, d, b, 10.0, zero_border=False,
                                      stage_bytes=SHORT_STAGE)
    torch.cuda.synchronize()
    assert sx_block.ROUTE_LAUNCHES["chunked"] == before["chunked"] + 2
    plain = sx_block.sx_block_plain(dem, o, d, b, 10.0, zero_border=False).cpu().numpy()
    np.testing.assert_array_equal(np.isnan(out.cpu().numpy()), np.isnan(plain))
    np.testing.assert_allclose(out.cpu().numpy(), plain, rtol=0, atol=JAX_ATOL)
    assert torch.equal(out.view(torch.int32), short.view(torch.int32))
    o, d, b = _rays(90, 2000, dy)
    assert sx_block.device_plan(o, d, b, dem.device)[1] == 1
    one = sx_block.sx_block_chunked(dem, o, d, b, 10.0)
    assert torch.equal(one.view(torch.int32), sx_block.sx_block(dem, o, d, b, 10.0).view(torch.int32))
