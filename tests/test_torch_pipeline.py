"""The port's drivers end to end against the JAX drivers.

Both packages run the same driver on the same small Basodino-like DEM with
NaN holes (filled by ``grid.fill_na``, reassigned after compute), write
NetCDF through the shared writer, and the files are read back with the
shared ``read_raster`` and compared: file names, variable names, units,
crop coordinates and values. The port runs on the CPU (the plain twins of
its CUDA kernels). Tolerances are those of tests/test_torch_ops.py (TPI,
STD) and tests/test_torch_sx.py (Sx).
"""

import numpy as np
import pytest
import torch

from topo_descriptors_tpu import pipeline as jpipe
from topo_descriptors_tpu.grid import fill_na
from topo_descriptors_tpu.io import basodino_like_dem, read_raster
from topo_descriptors_tpu_torch import pipeline as tpipe

TOL = {"TPI": dict(rtol=1e-5, atol=1e-3), "STD": dict(rtol=1e-5, atol=2e-2),
       "SX": dict(rtol=0, atol=2e-5)}


@pytest.fixture(scope="module")
def dem_with_holes():
    raster = basodino_like_dem(ny=90, nx=144, projected=True)
    data = np.array(raster.data)
    data[10:13, 20:30] = np.nan
    data[50, 100:104] = np.nan
    return fill_na(raster.with_data(data))


CROP = {"x": slice(680_000.0 + 30 * 20, 680_000.0 + 30 * 120),
        "y": slice(5_100_000.0 + 30 * 80, 5_100_000.0 + 30 * 10)}

RUNS = {
    # several unsmoothed scales: the fused disk_descriptors batch
    "tpi_fused": ("compute_tpi", dict(scales=[500, 2000])),
    # a lone smoothed scale: ops.tpi with the Gaussian pre-smooth
    "tpi_smoothed": ("compute_tpi", dict(scales=[2000], smth_factors=0.5)),
    "tpi_std_cropped": ("compute_tpi_std", dict(scales=[100, 500], crop=CROP)),
    "std_single": ("compute_std", dict(scales=[300])),
    "sx_r500": ("compute_sx", dict(azimuth=0, radius=500)),
    "sx_quirk_radius_min": ("compute_sx", dict(azimuth=225, radius=250, radius_min=100)),
    # the azimuth sweep: a ragged 4-azimuth fan, and a cropped radius_min fan
    "sx_sweep_r300": ("compute_sx_sweep", dict(azimuths=[0, 45, 120, 290], radius=300)),
    "sx_sweep_cropped_radius_min": (
        "compute_sx_sweep", dict(azimuths=[10, 200, 355], radius=300, radius_min=100, crop=CROP)),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_driver_matches_jax(run, dem_with_holes, tmp_path):
    ind_nans, dem = dem_with_holes
    driver, kwargs = RUNS[run]
    # like the JAX drivers, the Sx drivers take no ind_nans
    extra = {} if driver.startswith("compute_sx") else {"ind_nans": ind_nans}
    port_files = getattr(tpipe, driver)(
        dem, outdir=tmp_path / "port", device="cpu", **extra, **kwargs
    )
    jax_files = getattr(jpipe, driver)(dem, outdir=tmp_path / "jax", **extra, **kwargs)
    assert [p.name for p in port_files] == [p.name for p in jax_files]
    for pf, jf in zip(port_files, jax_files):
        port, ref = read_raster(pf), read_raster(jf)
        assert port.name == ref.name and port.units == ref.units
        np.testing.assert_array_equal(port.grid.y, ref.grid.y)
        np.testing.assert_array_equal(port.grid.x, ref.grid.x)
        assert port.data.shape == ref.data.shape
        np.testing.assert_array_equal(np.isnan(port.data), np.isnan(ref.data))
        np.testing.assert_allclose(port.data, ref.data, **TOL[port.name.split("_")[0]])
    if "crop" in kwargs:
        assert read_raster(port_files[0]).data.shape == (71, 101)
    if extra:  # original NaNs are reassigned
        assert np.isnan(read_raster(port_files[0]).data).sum() >= 1


def test_skip_existing_keeps_files(dem_with_holes, tmp_path):
    _, dem = dem_with_holes
    first = tpipe.compute_tpi(dem, [100], outdir=tmp_path, device="cpu")
    stamp = first[0].stat().st_mtime_ns
    again = tpipe.compute_tpi(dem, [100], outdir=tmp_path, skip_existing=True, device="cpu")
    assert again == first and first[0].stat().st_mtime_ns == stamp


def test_sharded_backend_not_ported(dem_with_holes, tmp_path):
    _, dem = dem_with_holes
    with pytest.raises(NotImplementedError, match="A13"):
        tpipe.compute_tpi(dem, [100], outdir=tmp_path, sharded=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        tpipe.compute_sx(dem, 0, 300, outdir=tmp_path, sharded=object(), device="cpu")


def test_sx_sweep_sharded_backend_not_ported(dem_with_holes, tmp_path):
    _, dem = dem_with_holes
    with pytest.raises(NotImplementedError, match="A13.*A12"):
        tpipe.compute_sx_sweep(dem, [0, 90], 300, outdir=tmp_path, sharded=object(),
                               device="cpu")


def test_sx_sweep_skip_existing_keeps_files(dem_with_holes, tmp_path):
    _, dem = dem_with_holes
    first = tpipe.compute_sx_sweep(dem, [0, 90], 300, outdir=tmp_path, device="cpu")
    stamps = [f.stat().st_mtime_ns for f in first]
    again = tpipe.compute_sx_sweep(dem, [0, 90], 300, outdir=tmp_path, skip_existing=True,
                                   device="cpu")
    assert again == first and [f.stat().st_mtime_ns for f in first] == stamps


def test_drivers_default_to_cuda(dem_with_holes, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is missing")
    _, dem = dem_with_holes
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.compute_tpi(dem, [100], outdir=tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.compute_sx(dem, 0, 300, outdir=tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.compute_sx_sweep(dem, [0, 90], 300, outdir=tmp_path)
