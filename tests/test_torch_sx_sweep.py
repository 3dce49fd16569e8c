"""The port's Sx azimuth sweep against the JAX package.

References for every fan: JAX ``ops.sx_sweep(method="xla")`` and the JAX
Pallas kernels ``sx_sweep_pallas`` and ``sx_fan_pallas`` under the Pallas
interpreter, on the fans of tests/test_pallas.py (ragged per-azimuth ray
counts, ``radius_min`` NaN rays mid-table, the even-window distance-0
quirk, and a fan split into several ``FAN_RAY_BUDGET`` groups). On the CPU
the port runs the plain twin of its CUDA kernels; the kernels themselves
are held against that twin on a CUDA device by the ``cuda``-marked tests.

Tolerance against JAX: both sides compute the same float32 ratios and
differ only in ``atan`` (about one ulp of a value <= 90 degrees, 7.6e-6),
so 2e-5 degrees, rtol 0, with identical NaN positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import importlib

import topo_descriptors_tpu.ops.pallas.sx_block as sxb
from topo_descriptors_tpu import kernels
from topo_descriptors_tpu import ops as jops
from topo_descriptors_tpu_torch import ops as tops
from topo_descriptors_tpu_torch.ops.cuda import _build, sx_block, sx_sweep

tsx = importlib.import_module("topo_descriptors_tpu_torch.ops.sx")

JAX_ATOL = 2e-5


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)  # TPU-only knob
        return orig(*args, **kwargs)

    monkeypatch.setattr(sxb.pl, "pallas_call", interp)


# (sx_sweep_offsets kwargs, Pallas block, FAN_RAY_BUDGET for sx_fan_pallas)
FANS = {
    "ragged4_r300": (dict(azimuths=[0.0, 45.0, 120.0, 290.0], radius=300.0), (16, 32), None),
    "radius_min100": (dict(azimuths=[10.0, 200.0, 355.0], radius=300.0, radius_min=100.0),
                      (16, 32), None),
    "distance0_quirk": (dict(azimuths=[225.0, 45.0], radius=250.0), (32, 32), None),
    "fan_budget_split": (dict(azimuths=[0.0, 45.0, 120.0, 290.0], radius=300.0), (16, 32), 40),
}


def _fan(name):
    kw, _, _ = FANS[name]
    return kernels.sx_sweep_offsets(dx=30.0, dy=30.0, **kw)


def _assert_close(out, ref, **tol):
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, **tol)


@pytest.mark.parametrize("name", list(FANS))
def test_sx_sweep_matches_jax(name, dem_tiny, interpret_pallas, monkeypatch):
    _, block, budget = FANS[name]
    o, d, b = _fan(name)
    if name == "distance0_quirk":
        assert (d == 0).any()
    if name == "radius_min100":
        real = ~(np.isnan(d) & ~o.any(axis=2))
        assert np.isnan(d[real]).any()  # NaN rays mid-table, not only padding
    if budget is not None:
        monkeypatch.setattr(sxb, "FAN_RAY_BUDGET", budget)
    dem = jnp.asarray(dem_tiny)
    port = tops.sx_sweep(dem_tiny, o, d, b, 10.0, device="cpu").numpy()
    xla = np.asarray(jops.sx_sweep(dem, o, d, b, 10.0, method="xla"))
    do, dd = kernels.sx_sweep_dedupe(o, d)
    sweep = np.asarray(sxb.sx_sweep_pallas(dem, do, dd, b, block=block))
    fan = np.asarray(sxb.sx_fan_pallas(dem, do, dd, b, block=block))
    assert port.shape == (len(o),) + dem_tiny.shape
    for ref in (xla, sweep, fan):
        _assert_close(port, ref, rtol=0, atol=JAX_ATOL)
    if name == "distance0_quirk":
        assert (np.abs(port) == 90).any()  # the +-90 candidates win somewhere


@pytest.mark.parametrize("method", ["auto", "pallas_fan", "pallas_sweep", "pallas", "xla"])
def test_sweep_methods_agree(method, dem_tiny):
    o, d, b = _fan("radius_min100")
    ref = tops.sx_sweep(dem_tiny, o, d, b, method="xla", device="cpu").numpy()
    out = tops.sx_sweep(dem_tiny, o, d, b, method=method, device="cpu").numpy()
    np.testing.assert_array_equal(out, ref)  # same arithmetic on every route


def test_sweep_planes_equal_sx(dem_tiny):
    o, d, b = _fan("ragged4_r300")
    planes = tops.sx_sweep(dem_tiny, o, d, b, device="cpu").numpy()
    for a, az in enumerate(FANS["ragged4_r300"][0]["azimuths"]):
        oa, da, ba = kernels.sx_offsets(az, 300.0, 30.0, 30.0)
        assert ba == b
        plane = tops.sx(dem_tiny, oa, da, b, device="cpu").numpy()
        np.testing.assert_array_equal(planes[a], plane)


def test_sweep_without_zero_border(dem_tiny):
    o, d, b = _fan("ragged4_r300")
    port = tops.sx_sweep(dem_tiny, o, d, b, zero_border=False, device="cpu").numpy()
    xla = np.asarray(jops.sx_sweep(jnp.asarray(dem_tiny), o, d, b, method="xla",
                                   zero_border=False))
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    assert np.isnan(port).any()  # corner pixels whose rays all leave the grid


def test_sweep_azimuth_without_rays(dem_tiny):
    # every ray of azimuth 1 excluded (NaN distance): no candidate -> NaN
    o, d, b = _fan("ragged4_r300")
    d = d.copy()
    d[1] = np.nan
    port = tops.sx_sweep(dem_tiny, o, d, b, device="cpu").numpy()
    xla = np.asarray(jops.sx_sweep(jnp.asarray(dem_tiny), o, d, b, method="xla"))
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    assert np.isnan(port[1, b:-b, b:-b]).all() and (port[1, :b] == 0).all()
    offs, group_ptr, inv, az_ptr = sx_sweep.sweep_tables(*kernels.sx_sweep_dedupe(o, d))
    assert az_ptr[1] == az_ptr[2]  # azimuth 1 owns no group


@pytest.mark.parametrize("name", ["radius_min100", "distance0_quirk"])
def test_sweep_tables_cover_real_rays(name):
    o, d = kernels.sx_sweep_dedupe(*_fan(name)[:2])
    offs, group_ptr, inv, az_ptr = sx_sweep.sweep_tables(o, d)
    assert len(az_ptr) == len(o) + 1 and az_ptr[0] == 0 and az_ptr[-1] == len(inv)
    assert group_ptr[0] == 0 and group_ptr[-1] == len(offs) == (~np.isnan(d)).sum()
    for a in range(len(o)):
        ref_offs, ref_ptr, ref_inv = sx_block.ray_groups(o[a], d[a])
        g0, g1 = az_ptr[a], az_ptr[a + 1]
        np.testing.assert_array_equal(inv[g0:g1], ref_inv)
        np.testing.assert_array_equal(group_ptr[g0 : g1 + 1] - group_ptr[g0], ref_ptr)
        np.testing.assert_array_equal(offs[group_ptr[g0] : group_ptr[g1]], ref_offs)
    if name == "distance0_quirk":
        assert np.isinf(inv).any()  # the distance-0 ray keeps 1/0 = +inf


def test_sweep_auto_on_cpu_launches_no_kernel(dem_tiny):
    o, d, b = _fan("ragged4_r300")
    before = dict(sx_sweep.LAUNCHES), sx_block.LAUNCHES
    tops.sx_sweep(dem_tiny, o, d, b, device="cpu")
    assert (dict(sx_sweep.LAUNCHES), sx_block.LAUNCHES) == before


def test_sweep_unknown_method_raises(dem_tiny):
    o, d, b = _fan("ragged4_r300")
    with pytest.raises(ValueError, match="method"):
        tops.sx_sweep(dem_tiny, o, d, b, method="scan", device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FANS))
@pytest.mark.parametrize("kernel", ["sx_sweep", "sx_fan"])
def test_sweep_kernel_matches_twin_on_cuda(kernel, name, dem_tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    o, d = kernels.sx_sweep_dedupe(*_fan(name)[:2])
    b = _fan(name)[2]
    dem = torch.from_numpy(dem_tiny).cuda()
    before = sx_sweep.LAUNCHES[kernel]
    out = getattr(sx_sweep, kernel)(dem, o, d, b, 10.0)
    torch.cuda.synchronize()
    assert sx_sweep.LAUNCHES[kernel] == before + 1
    plain = sx_sweep.sx_sweep_plain(dem, o, d, b, 10.0)
    _assert_close(out.cpu().numpy(), plain.cpu().numpy(), rtol=0, atol=JAX_ATOL)
    # the same per-pixel code and groups as sx_block: bit-equal planes
    for a in range(len(o)):
        one = tops.sx(dem, o[a], d[a], b, 10.0, device=dem.device)
        assert torch.equal(out[a].view(torch.int32), one.view(torch.int32))


# 36-azimuth fans on 30 m (BASELINE.json configs[3] and the 8192^2 case):
# radius -> (rays, distance groups, largest azimuth's staged wedge and ray
# table in KiB, union box of the fan, its staged tile in KiB, all tables in
# KiB, routes of sx_sweep and sx_fan)
FAN_SIZES = {
    200.0: (296, 284, 9.7, (-6, 6, -6, 6), 13.1, 4.7, ("tile", "tile")),
    500.0: (1328, 1288, 13.3, (-16, 16, -16, 16), 24.0, 20.6, ("tile", "tile")),
    2000.0: (15136, 14076, 40.7, (-66, 66, -66, 66), 125.6, 228.4, ("tile", "tile")),
    10_000.0: (145136, 137764, 393.5, (-332, 332, -332, 332), 1979.2, 2210.3,
               ("chunked", "chunked")),
}
AZIMUTHS36 = tuple(range(0, 360, 10))


def _fan36(radius, dy=30.0):
    o, d, b = kernels.sx_sweep_offsets(AZIMUTHS36, radius, 30.0, dy)
    return (*kernels.sx_sweep_dedupe(o, d), b)


@pytest.mark.parametrize("dy", [30.0, -30.0], ids=["south_up", "north_up"])
@pytest.mark.parametrize("radius", list(FAN_SIZES))
def test_fan_boxes_groups_and_routes(radius, dy):
    """The box, group and route helpers on the 36-azimuth fans: the sizes
    of the table above, the north-up grid's boxes mirrored in y, the fan
    grouped so that four of its blocks fit on an SM (one group up to
    500 m), and the 10 km fan on both kernels' chunked routes; the fan's
    plan is built with its tables only for that route, the sweep's per grid
    (``device_sweep_plan``)."""
    rays, groups, wedge_kib, union, union_kib, tables_kib, routes = FAN_SIZES[radius]
    route = routes[0]
    o, d, _ = _fan36(radius, dy)
    flat = sx_sweep.sweep_tables(o, d)
    assert (len(flat[0]), len(flat[2])) == (rays, groups)
    assert round(sum(t.nbytes for t in flat) / 1024, 1) == tables_kib
    t = sx_sweep.fan_tables(o, d, "cpu")
    assert t.n_az == 36 and round(t.sweep_smem / 1024, 1) == wedge_kib
    assert sx_sweep.union_box(t.boxes) == union
    assert round(sx_sweep.staged_bytes(union) / 1024, 1) == union_kib
    for a, box in enumerate(t.boxes):  # each azimuth's box is sx_block's
        offs, ptr, inv = sx_block.ray_groups(o[a], d[a])
        assert tuple(box) == sx_block.halo_box(offs)
        assert sx_block.route(box, len(offs), len(inv)) == "tile" or route == "chunked"
        oy0, oy1, ox0, ox1 = box
        assert tuple(t.sweep_boxes[a].tolist()) == (oy0, ox0, 32 + oy1 - oy0, 64 + ox1 - ox0)
    if dy < 0:
        south = sx_sweep.fan_tables(*_fan36(radius)[:2], "cpu").boxes
        np.testing.assert_array_equal(t.boxes, south[:, [1, 0, 2, 3]] * [-1, -1, 1, 1])
    assert (sx_sweep.route(t.sweep_smem), sx_sweep.route(t.fan_smem)) == routes
    assert (t.fan_plan is not None) == (routes[1] == "chunked")
    assert [a for g in t.groups for a in range(*g)] == list(range(36))
    if route == "tile":
        assert 4 * (t.fan_smem + 1024) <= _build.SMEM_PER_SM  # four fan blocks per SM
        assert (len(t.groups) == 1) == (radius <= 500.0)


def test_fan_groups_follow_the_budget():
    """Consecutive azimuths, each group's union within the budget unless it
    holds a single azimuth whose own tile exceeds it."""
    o, d, _ = _fan36(2000.0, -30.0)
    boxes = sx_sweep.fan_tables(o, d, "cpu").boxes
    for budget in (30_000, sx_sweep.FAN_SMEM_BUDGET, 120_000, 10**9):
        groups = sx_sweep.fan_groups(boxes, budget)
        assert groups[0][0] == 0 and groups[-1][1] == 36
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(groups, groups[1:]))
        for a0, a1 in groups:
            size = sx_sweep.staged_bytes(sx_sweep.union_box(boxes[a0:a1]))
            assert size <= budget or a1 - a0 == 1
            if a1 < 36:  # the next azimuth would not have fitted
                assert sx_sweep.staged_bytes(sx_sweep.union_box(boxes[a0:a1 + 1])) > budget
    assert sx_sweep.fan_groups(boxes, 10**9) == [(0, 36)]
    assert sx_sweep.fan_groups(np.zeros((0, 4), np.int64), 10**9) == []


@pytest.mark.parametrize("name", ["radius_min100", "distance0_quirk", "fan_budget_split"])
def test_tile_offsets_address_the_rays(name):
    """Every ray lies in its azimuth's wedge (the sweep) and in its group's
    union box (the fan), and the fan's tile offsets decode to the ray."""
    o, d = kernels.sx_sweep_dedupe(*_fan(name)[:2])
    t = sx_sweep.fan_tables(o, d, "cpu")
    offs, ptr, az_ptr = t.offsets.numpy(), t.group_ptr.numpy(), t.az_ptr.numpy()
    rays = ptr[az_ptr]
    for a, (oy0, oy1, ox0, ox1) in enumerate(t.boxes):
        r = offs[rays[a] : rays[a + 1]]
        assert ((r[:, 0] >= oy0) & (r[:, 0] <= oy1) & (r[:, 1] >= ox0) & (r[:, 1] <= ox1)).all()
    for a0, a1, oy0, ox0, sh, sw in t.fan.numpy():
        k = slice(rays[a0], rays[a1])
        row, col = np.divmod(t.fan_soff.numpy()[k], sw)
        np.testing.assert_array_equal(row + oy0, offs[k, 0])
        np.testing.assert_array_equal(col + ox0, offs[k, 1])
        assert row.max(initial=0) <= sh - 32 and col.max(initial=0) <= sw - 64
    n_rays, n_groups = np.diff(rays), np.diff(az_ptr)
    assert t.table_words % 4 == 0 and t.table_words >= (n_rays + 2 * n_groups + 1).max()
    assert t.fan_smem == 8 * t.table_words + max(4 * int(sh) * int(sw)
                                                 for sh, sw in t.fan.numpy()[:, 4:])


def test_fan_tables_are_uploaded_once(monkeypatch):
    """A second call with the same table uploads nothing; a changed table,
    distances or border misses the cache."""
    uploads = []
    monkeypatch.setattr(sx_sweep, "upload", lambda a, dev: uploads.append(1) or torch.as_tensor(a))
    sx_sweep.TABLES.clear()
    before = sx_sweep.TABLES.builds
    o, d = kernels.sx_sweep_dedupe(*_fan("ragged4_r300")[:2])
    first = sx_sweep.device_tables(o, d, 10, "cpu")
    n_uploads = len(uploads)
    assert n_uploads == 7
    assert sx_sweep.device_tables(o.copy(), d.copy(), 10, torch.device("cpu")) is first
    assert len(uploads) == n_uploads and sx_sweep.TABLES.builds == before + 1
    d2 = d.copy()
    d2[0, 0] = np.nan
    o2 = o.copy()
    o2[1, 0] = o2[1, 1]
    for args in ((o, d2, 10), (o2, d, 10), (o, d, 11)):
        assert sx_sweep.device_tables(*args, "cpu") is not first
    assert sx_sweep.TABLES.builds == before + 4 and len(uploads) == 4 * n_uploads


def test_sweep_dedupe_runs_once_per_table(dem_tiny):
    o, d, b = _fan("radius_min100")
    tsx.DEDUPED.clear()
    before = tsx.DEDUPED.builds
    first = tops.sx_sweep(dem_tiny, o, d, b, device="cpu")
    again = tops.sx_sweep(dem_tiny, o.copy(), d.copy(), b, device="cpu")
    assert tsx.DEDUPED.builds == before + 1 and torch.equal(first, again)
    do, dd = tsx._sweep_deduped(o, d)
    ref_o, ref_d = kernels.sx_sweep_dedupe(o, d)
    np.testing.assert_array_equal(do, ref_o)
    np.testing.assert_array_equal(dd, ref_d)
    assert not do.flags.writeable and not dd.flags.writeable
    tops.sx_sweep(dem_tiny, o, d + 1.0, b, device="cpu")
    assert tsx.DEDUPED.builds == before + 2


@pytest.mark.parametrize("azimuths,radius,shape,zero_border,method", [
    ((45.0,), 10_000.0, (900, 1440), True, "pallas_sweep"),  # 104 busy tiles: SMs idle
    ((0.0, 45.0), 10_000.0, (900, 1440), True, "pallas_sweep"),
    ((0.0, 45.0), 10_000.0, (900, 1440), False, "pallas_fan"),  # 667 busy tiles
    (AZIMUTHS36, 10_000.0, (900, 1440), True, "pallas_fan"),
    ((45.0,), 10_000.0, (8192, 8192), True, "pallas_fan"),
    (AZIMUTHS36, 2000.0, (900, 1440), True, "pallas_fan"),  # the tile routes
    ((0.0, 45.0), 2000.0, (900, 1440), True, "pallas_fan"),
])
def test_sweep_auto_on_cuda_follows_the_idle_sms(azimuths, radius, shape, zero_border, method,
                                                 monkeypatch):
    """``auto`` on a CUDA tensor: the sweep where both kernels take their
    chunked routes and the busy tiles times the azimuths leave SMs idle (a
    short fan on a grid with few busy tiles), where its split plan can cut
    an azimuth over several blocks; else the fan. The rule read on the CPU
    with the card's 132 SMs, the tensor's device faked."""
    monkeypatch.setattr(tsx, "on_cuda", lambda t: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("Props", (), {"multi_processor_count": 132}))
    o, d, b = kernels.sx_sweep_offsets(azimuths, radius, 30.0, 30.0)
    o, d = kernels.sx_sweep_dedupe(o, d)
    dem = torch.empty(shape)
    assert tsx._sweep_auto_method(dem, o, d, b, zero_border) == method


# (grid, fan kwargs, zero_border, route): a grid that is no tile multiple,
# north-up and without the zero border; a grid smaller than the 2000 m halo;
# the radius_min and distance-0 fans; 10 km fans whose 45-degree box does
# not fit in shared memory (both kernels' chunked routes; azimuth 45 alone
# on 900 x 1440 leaves SMs idle, so the sweep's plan splits it)
ROUTE_CASES = {
    "ragged_r2000_northup_nozero": ((1000, 1337), dict(azimuths=AZIMUTHS36, radius=2000.0,
                                                       dy=-30.0), False, "tile"),
    "ragged_r500": ((1000, 1337), dict(azimuths=AZIMUTHS36, radius=500.0), True, "tile"),
    "small_r2000": ((50, 61), dict(azimuths=AZIMUTHS36, radius=2000.0), True, "tile"),
    "radius_min100": ((257, 333), dict(azimuths=(10.0, 200.0, 355.0), radius=300.0,
                                       radius_min=100.0), True, "tile"),
    "distance0": ((257, 333), dict(azimuths=(225.0, 45.0), radius=250.0), True, "tile"),
    "chunked_r10000": ((400, 420), dict(azimuths=(0.0, 45.0), radius=10_000.0), True, "chunked"),
    "small_chunked_r10000": ((50, 61), dict(azimuths=(0.0, 45.0), radius=10_000.0), True,
                             "chunked"),
    "chunked_r10000_az45": ((900, 1440), dict(azimuths=(45.0,), radius=10_000.0), True,
                            "chunked"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("kernel", ["sx_sweep", "sx_fan"])
def test_sweep_routes_bit_equal_to_sx_block_on_cuda(kernel, case):
    """Each route of each kernel: the route the box bytes give, every plane
    within SX atol of the twin and bit-equal to sx_block on the azimuth's
    table; on the sweep's chunked route, also bit-equal to its plans of one
    work item per azimuth and of one per group start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    shape, kw, zero_border, route = ROUTE_CASES[case]
    kw = dict(kw)
    o, d, b = kernels.sx_sweep_offsets(dx=30.0, dy=kw.pop("dy", 30.0), **kw)
    o, d = kernels.sx_sweep_dedupe(o, d)
    dem = torch.from_numpy(
        np.random.default_rng(len(case)).uniform(500, 3000, shape).astype(np.float32)).cuda()
    before = dict(sx_sweep.ROUTE_LAUNCHES[kernel])
    out = getattr(sx_sweep, kernel)(dem, o, d, b, 10.0, zero_border)
    torch.cuda.synchronize()
    assert sx_sweep.ROUTE_LAUNCHES[kernel][route] == before[route] + 1
    for a in range(len(o)):
        plain = sx_sweep.sx_sweep_plain(dem, o[a : a + 1], d[a : a + 1], b, 10.0, zero_border)[0]
        _assert_close(out[a].cpu().numpy(), plain.cpu().numpy(), rtol=0, atol=JAX_ATOL)
        one = sx_block.sx_block(dem, o[a], d[a], b, 10.0, zero_border)
        assert torch.equal(out[a].view(torch.int32), one.view(torch.int32))
    if (kernel, route) == ("sx_sweep", "chunked"):
        n_sms = torch.cuda.get_device_properties(dem.device).multi_processor_count
        p = sx_sweep.device_sweep_plan(o, d, b, dem.device, dem.shape, zero_border, n_sms)
        for splits in (1, 10**6):  # S forced: one work item per azimuth, one per group start
            items, per_az, _ = sx_block.split_plan(p.plan.cpu().numpy(), len(o), 0, n_sms, 3,
                                                   splits)
            forced = sx_sweep.upload_plan(p.plan.cpu().numpy(), p.stage_floats, items, per_az,
                                          dem.device)
            again = sx_sweep.launch_sweep_chunked(dem, forced, b, 10.0, zero_border)
            assert torch.equal(out.view(torch.int32), again.view(torch.int32))
