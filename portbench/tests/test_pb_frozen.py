"""The benchmark's frozen copies and its reference's geometry equal what
the program and chip_smoke.py compute today, at small shapes. (The tests
may import the program; the harness's reference may not.)"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import terrain, trace, work
from portbench.reference import descriptors, geometry

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("size, shape", [(3, (1, 20, 30)), (17, (1, 40, 50)),
                                         (67, (1, 90, 144)), (201, (1, 120, 90))])
def test_disk_work_is_chip_smokes(chip_smoke, size, shape):
    from topo_descriptors_tpu_torch.host import circular_kernel
    from topo_descriptors_tpu_torch.ops.conv import _binary_kernel_runs, _same_pads

    k = circular_kernel(size, exclude_center=True)
    runs = _binary_kernel_runs(k[::-1, ::-1])
    pads = (_same_pads(size), _same_pads(size))
    assert work.kernel_runs(geometry.disk(size, exclude_center=True)) == runs
    assert work.tpi_work(shape[1], shape[2], size) == chip_smoke.disk_work(shape, k.shape,
                                                                           runs, pads)


@pytest.mark.parametrize("az, radius, dy", [(0, 500, -30.0), (0, 1000, -30.0), (45, 2000, 30.0),
                                            (225, 250, 30.0)])
def test_sx_work_is_chip_smokes(chip_smoke, az, radius, dy):
    from topo_descriptors_tpu_torch.host import sx_dedupe, sx_offsets

    o, d, b = sx_offsets(az, radius, 30.0, dy)
    o, d = sx_dedupe(o, d)
    assert work.sx_call_work(300, 400, az, radius, 30.0, dy) == chip_smoke.sx_work((300, 400),
                                                                                   o, d, b)


@pytest.mark.parametrize("ny, nx, seed", [(64, 96, 0), (90, 144, 7), (33, 50, 2**31 + 5)])
def test_terrain_is_the_programs(ny, nx, seed):
    from topo_descriptors_tpu_torch.io.synthetic import synthetic_dem

    phase = np.random.default_rng(seed).uniform(0, 2 * np.pi, size=(ny, nx // 2 + 1))
    ours = terrain.spectral_terrain(torch.from_numpy(phase), ny, nx, 2.2, 1400.0, 1800.0)
    theirs = synthetic_dem(ny, nx, seed=seed)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=4e-4)  # float32 ulps at 3200


def test_busy_union_is_the_programs():
    from topo_descriptors_tpu_torch.utils.profiling import device_busy_s

    rng = np.random.default_rng(3)
    starts = rng.integers(0, 10**9, 200)
    spans = [(int(s), int(s + d)) for s, d in zip(starts, rng.integers(1, 10**7, 200))]
    assert trace.busy_seconds(spans) == pytest.approx(device_busy_s(spans), abs=0)
    assert sum(e - s for s, e in trace.union(spans)) / 1e9 == pytest.approx(device_busy_s(spans))


@pytest.mark.parametrize("az, radius, dy, rmin", [(0, 500, -30.0, 0.0), (0, 1000, -30.0, 0.0),
                                                  (45, 2000, 30.0, 0.0), (225, 250, 30.0, 0.0),
                                                  (0, 500, 30.0, 100.0), (310, 700, -25.0, 0.0)])
def test_reference_rays_are_the_programs(az, radius, dy, rmin):
    from topo_descriptors_tpu_torch.host import sx_offsets

    o, d, b = sx_offsets(az, radius, 30.0, dy, radius_min=rmin)
    ro, rd, rb = geometry.sx_rays(az, radius, 30.0, dy, radius_min=rmin)
    assert rb == b
    np.testing.assert_array_equal(ro, o)
    np.testing.assert_array_equal(rd, d)


@pytest.mark.parametrize("projected", [True, False])
def test_reference_host_geometry_is_the_programs(projected):
    from topo_descriptors_tpu_torch import geo
    from topo_descriptors_tpu_torch.host import basodino_like_dem, circular_kernel
    from topo_descriptors_tpu_torch.kernels.gaussian import gaussian_kernel1d

    dem = basodino_like_dem(50, 70, projected=projected)
    g = dem.grid
    scales = [100, 300, 500, 1000, 2000, 6000, 30000, 100000]
    pixels, res = geo.scale_to_pixel(scales, dem)
    np.testing.assert_array_equal(geometry.scale_to_pixel(scales, g.x, g.y, g.crs), pixels)
    for ours, theirs in zip(geometry.resolution(g.x, g.y, g.crs), (res["x"], res["y"])):
        np.testing.assert_array_equal(ours, theirs)
    for size in (1, 3, 4, 5, 9, 17, 67):
        for centre in (False, True):
            np.testing.assert_array_equal(geometry.disk(size, centre),
                                          circular_kernel(size, centre))
    for sigma in (0.75, 2.25, 16.75, 83.25):
        np.testing.assert_allclose(geometry.gaussian_taps(sigma), gaussian_kernel1d(sigma),
                                   rtol=1e-14)


@pytest.mark.parametrize("projected", [True, False])
def test_reference_fill_is_the_programs(projected):
    from topo_descriptors_tpu_torch.grid import fill_na
    from topo_descriptors_tpu_torch.host import basodino_like_dem

    dem = basodino_like_dem(40, 60, projected=projected)
    data = dem.data.copy()
    data[3, 10:20] = np.nan
    data[7, :5] = np.nan
    data[8, -4:] = np.nan
    data[9, [1, 3, 5]] = np.nan
    for j, width in enumerate(range(1, 12), start=12):  # a middle void of every width
        data[j, 30 - width // 2:30 - width // 2 + width] = np.nan
    ind, filled = fill_na(dem.with_data(data))
    np.testing.assert_array_equal(descriptors.fill_na(data, dem.grid.x), filled.data)
    np.testing.assert_array_equal(np.argwhere(np.isnan(data)), np.transpose(ind))


def test_smoothing_matrix_is_scipys():
    from scipy.ndimage import gaussian_filter1d

    v = np.random.default_rng(1).normal(size=23)
    for sigma in (0.75, 3.0, 16.75):  # the last reaches past the axis more than once
        np.testing.assert_allclose(geometry.smoothing_matrix(23, sigma) @ v,
                                   gaussian_filter1d(v, sigma, mode="reflect"), atol=1e-12)
