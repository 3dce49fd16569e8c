"""The port's Sx horizon scan against the JAX package and the scipy oracle.

References for every geometry: JAX ``ops.sx(method="xla")``, the JAX Pallas
kernel ``sx_pallas`` under the Pallas interpreter, and the reference's
per-pixel loop ``oracles._sx_oracle``. On the CPU the port runs the plain
twin of its CUDA kernel; the kernel itself is held against that twin on a
CUDA device by the ``cuda``-marked test.

Tolerances: against JAX both sides compute the same float32 ratios and
differ only in ``atan`` (about one ulp of a value <= 90 degrees, 7.6e-6), so
2e-5 degrees; against the float64 oracle the test_ops.py tolerance
(rtol 1e-4, atol 1e-3). NaN positions must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import topo_descriptors_tpu.ops.pallas.sx_block as sxb
from oracles import _sx_oracle
from topo_descriptors_tpu import kernels
from topo_descriptors_tpu import ops as jops
from topo_descriptors_tpu_torch import ops as tops
from topo_descriptors_tpu_torch.ops.cuda import sx_block

JAX_ATOL = 2e-5


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)  # TPU-only knob
        return orig(*args, **kwargs)

    monkeypatch.setattr(sxb.pl, "pallas_call", interp)


# (sx_offsets kwargs, Pallas block): the geometries of tests/test_ops.py
# (radius_min 0 and 100, narrow arc, the even-window distance-0 quirk) and
# the ragged-block case of tests/test_pallas.py
GEOMETRIES = {
    "r300": (dict(azimuth=0.0, radius=300.0), (16, 32)),
    "r300_radius_min100": (dict(azimuth=0.0, radius=300.0, radius_min=100.0), (16, 32)),
    "narrow_arc": (dict(azimuth=45.0, radius=250.0, azimuth_arc=0.0), (16, 32)),
    "distance0_quirk": (dict(azimuth=225.0, radius=250.0), (32, 32)),
    "az90_ragged": (dict(azimuth=90.0, radius=250.0), (32, 32)),
}


def _geometry(name):
    kw, block = GEOMETRIES[name]
    o, d, b = kernels.sx_offsets(dx=30.0, dy=30.0, **kw)
    return o, d, b, block


def _assert_close(out, ref, **tol):
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, **tol)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_sx_matches_jax_and_oracle(name, dem_tiny, interpret_pallas):
    o, d, b, block = _geometry(name)
    if name == "distance0_quirk":
        assert (d == 0).any()
    if name == "r300_radius_min100":
        assert np.isnan(d).any()
    port = tops.sx(dem_tiny, o, d, b, 10.0, device="cpu").numpy()
    xla = np.asarray(jops.sx(jnp.asarray(dem_tiny), o, d, b, 10.0, method="xla"))
    pallas = np.asarray(sxb.sx_pallas(jnp.asarray(dem_tiny), o, d, b, block=block))
    ref = _sx_oracle(dem_tiny, o, d, b, height=10.0)
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    _assert_close(port, pallas, rtol=0, atol=JAX_ATOL)
    _assert_close(port, ref, rtol=1e-4, atol=1e-3)
    if name == "distance0_quirk":
        assert (np.abs(port) == 90).any()  # the +-90 candidates win somewhere


@pytest.mark.parametrize("method", ["xla", "pallas", "auto"])
def test_sx_methods_match_jax(method, dem_tiny):
    # JAX call sites name a backend: the port takes the same names
    o, d, b, _ = _geometry("r300_radius_min100")
    port = tops.sx(dem_tiny, o, d, b, 10.0, method=method, device="cpu").numpy()
    xla = np.asarray(jops.sx(jnp.asarray(dem_tiny), o, d, b, 10.0, method="xla"))
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    with pytest.raises(ValueError, match="method"):
        tops.sx(dem_tiny, o, d, b, method="scan", device="cpu")


def test_sx_without_zero_border(dem_tiny):
    o, d, b, _ = _geometry("r300")
    port = tops.sx(dem_tiny, o, d, b, 10.0, zero_border=False, device="cpu").numpy()
    xla = np.asarray(
        jops.sx(jnp.asarray(dem_tiny), o, d, b, 10.0, method="xla", zero_border=False)
    )
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    assert np.isnan(port).any()  # corner pixels whose rays all leave the grid


def test_ray_groups_cover_the_table():
    o, d, _ = kernels.sx_offsets(0.0, 2000.0, 30.0, 30.0, radius_min=100.0)
    o, d = kernels.sx_dedupe(o, d)
    offs, ptr, inv = sx_block.ray_groups(o, d)
    keep = ~np.isnan(d)
    assert len(offs) == keep.sum() and ptr[-1] == len(offs)
    assert np.all(np.diff(inv) > 0)  # sorted, one group per distinct 1/d
    with np.errstate(divide="ignore"):
        inv_of = {tuple(x): np.float32(1.0 / v) for x, v in zip(o[keep], d[keep])}
    for g in range(len(inv)):
        for x in offs[ptr[g] : ptr[g + 1]]:
            assert inv_of[tuple(x)] == inv[g]


def test_sx_plain_route_counts_no_launch(dem_tiny):
    o, d, b, _ = _geometry("r300")
    before = sx_block.LAUNCHES
    tops.sx(dem_tiny, o, d, b, device="cpu")
    assert sx_block.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_sx_kernel_matches_twin_on_cuda(name, dem_tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    o, d, b, _ = _geometry(name)
    o, d = kernels.sx_dedupe(o, d)
    dem = torch.from_numpy(dem_tiny).cuda()
    before = sx_block.LAUNCHES
    out = sx_block.sx_block(dem, o, d, b, 10.0)
    torch.cuda.synchronize()
    assert sx_block.LAUNCHES == before + 1
    plain = sx_block.sx_block_plain(dem, o, d, b, 10.0)
    _assert_close(out.cpu().numpy(), plain.cpu().numpy(), rtol=0, atol=JAX_ATOL)


def _dedupe(azimuth, radius, dy=30.0):
    o, d, b = kernels.sx_offsets(azimuth, radius, 30.0, dy)
    return (*kernels.sx_dedupe(o, d), b)


@pytest.mark.parametrize("azimuth", [0.0, 90.0, 180.0, 270.0, 45.0])
@pytest.mark.parametrize("radius", [500.0, 2000.0])
def test_halo_box_follows_the_signed_offsets(azimuth, radius):
    """The halo box is the bounding box of the rays' signed offsets: one
    side of the pixel for one azimuth, mirrored in y when the grid's dy is
    negative; at 500 m and 2000 m it fits, so the tile route runs."""
    o, d, b = _dedupe(azimuth, radius)
    offs, ptr, inv = sx_block.ray_groups(o, d)
    box = sx_block.halo_box(offs)
    assert box == (offs[:, 0].min(), offs[:, 0].max(), offs[:, 1].min(), offs[:, 1].max())
    oy0, oy1, ox0, ox1 = box
    assert max(-oy0, oy1, -ox0, ox1) <= b
    assert oy0 * oy1 >= 0 or ox0 * ox1 >= 0  # one-sided along the ray's main axis
    mirrored = sx_block.halo_box(sx_block.ray_groups(*_dedupe(azimuth, radius, -30.0)[:2])[0])
    assert mirrored == (-oy1, -oy0, ox0, ox1)
    assert sx_block.route(box, len(offs), len(inv)) == "tile"


def test_route_is_chosen_by_the_halo_alone():
    """A 10 km halo at 45 degrees (a 334 x 334 box) does not fit in 227 KB
    of shared memory and takes the global route; the same radius along an
    axis, and every smaller one, fits."""
    for azimuth, expected in ((45.0, "global"), (0.0, "tile")):
        offs, _, inv = sx_block.ray_groups(*_dedupe(azimuth, 10_000.0)[:2])
        box = sx_block.halo_box(offs)
        assert sx_block.route(box, len(offs), len(inv)) == expected
        oy0, oy1, ox0, ox1 = box
        staged = (sx_block.TILE_H + oy1 - oy0) * (sx_block.TILE_W + ox1 - ox0) * 4
        smem = sx_block.tile_smem_bytes(box, len(offs), len(inv))
        assert staged < smem <= staged + 4 * (len(offs) + 2 * len(inv) + 4)
    assert sx_block.halo_box(np.zeros((0, 2), np.int32)) == (0, 0, 0, 0)


def test_ray_tables_are_uploaded_once_per_table():
    sx_block.TABLES.clear()
    before = sx_block.TABLES.builds
    o, d, b = _dedupe(0.0, 500.0)
    first = sx_block.device_tables(o, d, b, "cpu")
    assert sx_block.device_tables(o.copy(), d.copy(), b, torch.device("cpu")) is first
    assert sx_block.TABLES.builds == before + 1
    offs, ptr, inv = sx_block.ray_groups(o, d)
    for got, want in zip(first[:3], (offs, ptr, inv)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert first[3:] == (len(offs), len(inv), sx_block.halo_box(offs))
    sx_block.device_tables(*_dedupe(90.0, 500.0), "cpu")
    assert len(sx_block.TABLES) == 2 and sx_block.TABLES.builds == before + 2


# (grid, azimuth, radius m): every side of the one-sided halo at 2000 m, a
# ragged grid, a grid smaller than the 2000 m halo, and the global route
@pytest.mark.cuda
@pytest.mark.parametrize("shape,azimuth,radius,route", [
    ((300, 410), 90.0, 2000.0, "tile"),
    ((300, 410), 180.0, 2000.0, "tile"),
    ((300, 410), 270.0, 2000.0, "tile"),
    ((257, 333), 0.0, 500.0, "tile"),
    ((50, 61), 225.0, 2000.0, "tile"),
    ((400, 420), 45.0, 10_000.0, "global"),
], ids=["az90_r2000", "az180_r2000", "az270_r2000", "ragged_r500", "grid_below_halo",
        "global_r10000"])
def test_sx_routes_bit_equal_to_the_sweep_on_cuda(shape, azimuth, radius, route):
    """Both routes against the twin, and bit for bit against the sweep
    kernel's plane of the same azimuth (the same per-pixel operations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from topo_descriptors_tpu_torch.ops.cuda import sx_sweep

    dem = torch.from_numpy(
        np.random.default_rng(int(radius)).uniform(500, 3000, shape).astype(np.float32)).cuda()
    o, d, b = _dedupe(azimuth, radius, -30.0)
    offs, _, inv = sx_block.ray_groups(o, d)
    assert sx_block.route(sx_block.halo_box(offs), len(offs), len(inv)) == route
    before = dict(sx_block.ROUTE_LAUNCHES)
    out = sx_block.sx_block(dem, o, d, b, 10.0)
    torch.cuda.synchronize()
    assert sx_block.ROUTE_LAUNCHES[route] == before[route] + 1
    plain = sx_block.sx_block_plain(dem, o, d, b, 10.0)
    _assert_close(out.cpu().numpy(), plain.cpu().numpy(), rtol=0, atol=JAX_ATOL)
    sweep = sx_sweep.sx_sweep(dem, o[None], d[None], b, 10.0)[0]
    assert torch.equal(out.view(torch.int32), sweep.view(torch.int32))
