"""``RasterGrid.resolution_meters`` against the reference's meshgrid recipe.

A geographic grid goes to UTM from its 1-D coordinate vectors: ``y`` as a
column and ``x`` as a row, broadcast by ``geo.utm_from_latlon``, a band of
rows at a time with the zone of the grid's first point. The reference's
recipe (helpers.py:88-105) reprojects the full meshgrid instead; it stays
here as the oracle, and every plane and every size ``scale_to_pixel``
derives from them must match it bit for bit, across the projection's
branches: the southern hemisphere, the Norway and Svalbard zones, a zone
edge, grids two pixels wide, and bands of any height. ``RESOLUTION_COUNTS``
counts the calls by CRS kind with their host seconds.
"""

import numpy as np
import pytest

from topo_descriptors_tpu_torch import geo, grid
from topo_descriptors_tpu_torch.grid import Raster, RasterGrid

# The reference script's twelve scales (scripts/compute_topo_descriptors.py)
SCALES = [100, 300, 500, 1000, 2000, 4000, 6000, 10000, 20000, 30000, 60000, 100000]
ARCSEC = 1.0 / 3600.0


def _meshgrid_resolution(g: RasterGrid):
    """The reference's recipe: reproject the full meshgrid to UTM, cast to
    float32, then ``np.gradient`` along x and along y."""
    x_mesh, y_mesh = np.meshgrid(g.x, g.y)
    x_m, y_m = geo.utm_from_latlon(y_mesh, x_mesh)
    x_m, y_m = x_m.astype(np.float32), y_m.astype(np.float32)
    return np.gradient(x_m, axis=1), np.gradient(y_m, axis=0)


def _geographic(lat0, lon0, ny, nx, step=ARCSEC, ascending=False, dtype=np.float64):
    """A lat/lon grid of ``step`` degrees from (lat0, lon0); y descends
    from the northern edge unless ``ascending``."""
    rows = np.arange(ny, dtype=np.float64) * step
    y = lat0 + rows if ascending else lat0 - rows
    x = lon0 + np.arange(nx, dtype=np.float64) * step
    return RasterGrid(y=y.astype(dtype), x=x.astype(dtype), crs="epsg:4326")


GRIDS = {
    # the Basodino clip as portbench/configs/basodino_30m.json has it
    "basodino": lambda: _geographic(46.55, 8.2, 900, 1440),
    "ascending_y": lambda: _geographic(46.30, 8.2, 120, 160, ascending=True),
    "float32_vectors": lambda: _geographic(46.55, 8.2, 120, 160, dtype=np.float32),
    "southern": lambda: _geographic(-33.80, 18.40, 120, 160, step=10 * ARCSEC),
    "norway_zone32": lambda: _geographic(60.10, 5.00, 90, 140, step=10 * ARCSEC),
    "svalbard": lambda: _geographic(78.20, 15.00, 90, 140, step=10 * ARCSEC),
    # zone 31 from the first point, though half the grid lies in zone 32
    "zone_edge": lambda: RasterGrid(y=np.linspace(46.5, 46.3, 80), x=np.linspace(5.9, 6.1, 200),
                                    crs="epsg:4326"),
    "two_rows": lambda: _geographic(46.55, 8.2, 2, 300),
    "two_columns": lambda: _geographic(46.55, 8.2, 300, 2),
}


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_resolution_is_the_meshgrid_recipe_bit_for_bit(case):
    g = GRIDS[case]()
    res = g.resolution_meters()
    want_x, want_y = _meshgrid_resolution(g)
    assert res["x"].shape == res["y"].shape == g.shape
    assert res["x"].dtype == want_x.dtype and res["y"].dtype == want_y.dtype
    assert np.array_equal(res["x"], want_x)
    assert np.array_equal(res["y"], want_y)

    dem = Raster(data=np.zeros(g.shape, np.float32), grid=g)
    sizes, _ = geo.scale_to_pixel(SCALES, dem)
    mean_res = np.mean(np.abs([want_x.mean(), want_y.mean()]))
    assert np.array_equal(sizes, geo.round_up_to_odd(np.array(SCALES) / mean_res))


@pytest.mark.parametrize("band_pixels", [1, 7 * 160 + 3, 10**9],
                         ids=["one_row", "uneven_bands", "one_band"])
@pytest.mark.parametrize("case", ["zone_edge", "southern", "float32_vectors"])
def test_bands_of_any_height_are_bit_for_bit(monkeypatch, band_pixels, case):
    monkeypatch.setattr(grid, "_BAND_PIXELS", band_pixels)
    g = GRIDS[case]()
    res = g.resolution_meters()
    want_x, want_y = _meshgrid_resolution(g)
    assert np.array_equal(res["x"], want_x)
    assert np.array_equal(res["y"], want_y)


@pytest.mark.parametrize("y", [np.linspace(84.05, 83.9, 40), np.linspace(-79.9, -80.05, 40)],
                         ids=["north_first_row", "south_last_row"])
def test_latitude_outside_utm_range_raises(y):
    """One row beyond [-80, 84] is enough, wherever it lies in the grid."""
    g = RasterGrid(y=y, x=np.linspace(10.0, 10.1, 30), crs="epsg:4326")
    with pytest.raises(ValueError, match="UTM range"):
        g.resolution_meters()


def test_counts_calls_by_kind_and_their_host_seconds():
    geographic = _geographic(46.55, 8.2, 30, 40)
    projected = RasterGrid(y=5.1e6 + 30.0 * np.arange(30)[::-1], x=6.8e5 + 30.0 * np.arange(40),
                           crs="epsg:32632")
    counts = grid.RESOLUTION_COUNTS
    for g, kind, other in ((geographic, "calls.geographic", "calls.projected"),
                           (projected, "calls.projected", "calls.geographic")):
        for _ in range(2):
            before = dict(counts)
            g.resolution_meters()
            assert counts[kind] == before[kind] + 1
            assert counts[other] == before[other]
            assert counts["host_s"] > before["host_s"]
