"""The port's drivers end to end against the JAX drivers.

Both packages run the same driver on the same small Basodino-like DEM with
NaN holes (filled by ``grid.fill_na``, reassigned after compute), write
NetCDF through the shared writer, and the files are read back with the
shared ``read_raster`` and compared: file names, variable names, units,
crop coordinates and values. The port runs on the CPU (the plain twins of
its CUDA kernels). Tolerances are those of tests/test_torch_ops.py (TPI,
STD), tests/test_torch_sx.py (Sx), tests/test_torch_gradient.py (DEM and
the gradient family; aspect compared modulo 360) and
tests/test_torch_valley_ridge.py (valley/ridge norm; the direction may
differ on under 2% of the pixels, where angles are near-tied). One
exception: the 2 km gradient smooths with more than
``CFG.fft_correlate1d_min_taps`` taps, so both packages take the FFT route
of the Gaussian with their own FFT libraries, and each lands ~2e-5 from a
float64 run in dx and dy (1.5-2.4e-5 on this grid); dx and dy get atol
5e-5 here instead of 1e-5, and the aspect the turn such an error can cause
on a gentle slope on top of its 2e-2 degrees.
"""

import numpy as np
import pytest
import torch

from topo_descriptors_tpu import grid as jgrid
from topo_descriptors_tpu import io as jio
from topo_descriptors_tpu import pipeline as jpipe
from topo_descriptors_tpu.config import CFG as JCFG
from topo_descriptors_tpu.parallel.tiles import TiledRunner as JaxTiledRunner
from topo_descriptors_tpu_torch import pipeline as tpipe
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.host import basodino_like_dem, fill_na, read_raster
from topo_descriptors_tpu_torch.parallel import TiledRunner

TOL = {"TPI": dict(rtol=1e-5, atol=1e-3), "STD": dict(rtol=1e-5, atol=2e-2),
       "SX": dict(rtol=0, atol=2e-5), "DEM": dict(rtol=1e-5, atol=1e-3),
       "WE": dict(rtol=1e-3, atol=5e-5), "SN": dict(rtol=1e-3, atol=5e-5),
       "SLOPE": dict(rtol=1e-3, atol=1e-3), "ASPECT": dict(atol=2e-2),
       "VALLEY": dict(rtol=1e-3, atol=2e-3), "RIDGE": dict(rtol=1e-3, atol=2e-3)}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Banded runs issue many small torch ops; with several test workers on
    the machine, an intra-op thread team per op oversubscribes the cores
    and stalls each op at its barrier (a 0.09 s test took 45 s), so these
    tests run torch on one intra-op thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _with_holes(raster, fill):
    data = np.array(raster.data)
    data[10:13, 20:30] = np.nan
    data[50, 100:104] = np.nan
    return fill(raster.with_data(data))


@pytest.fixture(scope="module")
def dem_with_holes():
    """(ind_nans, filled DEM) built with the port's own host layer: the
    port's drivers take only the port's ``Raster``."""
    return _with_holes(basodino_like_dem(ny=90, nx=144, projected=True), fill_na)


@pytest.fixture(scope="module")
def jax_dem_with_holes():
    """The same grid built with the JAX package's host layer, for its drivers."""
    return _with_holes(jio.basodino_like_dem(ny=90, nx=144, projected=True), jgrid.fill_na)


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
    "dem": ("compute_dem", dict(scales=[100, 2000])),
    # 100 m is 3 px, sigma 0.75: the Sobel route; then np.gradient routes
    "gradient": ("compute_gradient", dict(scales=[100, 200, 2000], sig_ratios=1)),
    "gradient_anisotropic_cropped": ("compute_gradient", dict(scales=[2000], sig_ratios=2, crop=CROP)),
    # 33 px: a 4.8 MB bank, the dftmm route
    "valley_smoothed": ("compute_valley_ridge", dict(scales=[1000], mode="valley",
                                                     smth_factors=0.5, flat_list=[0, 0.2, 0.4])),
    # forced onto the streamed route below
    "ridge_streamed": ("compute_valley_ridge", dict(scales=[300], mode="ridge")),
}


def _assert_close(port, ref, refs):
    kind = port.name.split("_")[0]
    if kind in ("VALLEY", "RIDGE") and "_DIR_" in port.name:
        a, b = port.data[~np.isnan(ref.data)], ref.data[~np.isnan(ref.data)]
        assert (a != b).mean() < 0.02
    elif kind == "ASPECT":
        # the aspect of a gentle slope is ill-conditioned: a derivative
        # error e turns it by up to e*sqrt(2)/|grad| radians, |grad| being
        # tan(slope)
        slope = refs[port.name.replace("ASPECT", "SLOPE", 1)].data
        turn = np.rad2deg(np.sqrt(2.0) * TOL["WE"]["atol"] / np.tan(np.deg2rad(slope)))
        diff = (port.data - ref.data + 180.0) % 360.0 - 180.0
        assert np.nanmax(np.abs(diff) - TOL[kind]["atol"] - turn) <= 0
    else:
        np.testing.assert_allclose(port.data, ref.data, **TOL[kind])


@pytest.mark.parametrize("run", list(RUNS))
def test_driver_matches_jax(run, dem_with_holes, jax_dem_with_holes, tmp_path, monkeypatch):
    ind_nans, dem = dem_with_holes
    jind_nans, jdem = jax_dem_with_holes
    np.testing.assert_array_equal(dem.data, jdem.data)
    driver, kwargs = RUNS[run]
    if run == "ridge_streamed":  # both packages stream above this budget, each reads its CFG
        monkeypatch.setattr(CFG, "valley_bank_max_bytes", 1)
        monkeypatch.setattr(JCFG, "valley_bank_max_bytes", 1)
    # like the JAX drivers, the Sx drivers take no ind_nans
    extra = {} if driver.startswith("compute_sx") else {"ind_nans": ind_nans}
    jextra = {} if driver.startswith("compute_sx") else {"ind_nans": jind_nans}
    port_files = getattr(tpipe, driver)(
        dem, outdir=tmp_path / "port", device="cpu", **extra, **kwargs
    )
    jax_files = getattr(jpipe, driver)(jdem, outdir=tmp_path / "jax", **jextra, **kwargs)
    assert [p.name for p in port_files] == [p.name for p in jax_files]
    refs = {}
    for pf, jf in zip(port_files, jax_files):
        # each package reads the other's file
        port, ref = jio.read_raster(pf), read_raster(jf)
        refs[ref.name] = ref
        assert port.name == ref.name and port.units == ref.units
        np.testing.assert_array_equal(port.grid.y, ref.grid.y)
        np.testing.assert_array_equal(port.grid.x, ref.grid.x)
        assert port.data.shape == ref.data.shape
        np.testing.assert_array_equal(np.isnan(port.data), np.isnan(ref.data))
        _assert_close(port, ref, refs)
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


@pytest.mark.parametrize("driver,args", [
    ("compute_dem", ([100],)), ("compute_gradient", ([100],)),
    ("compute_valley_ridge", ([300], "ridge"))])
def test_slice3_skip_existing_keeps_files(dem_with_holes, tmp_path, driver, args):
    _, dem = dem_with_holes
    run = getattr(tpipe, driver)
    first = run(dem, *args, outdir=tmp_path, device="cpu")
    stamps = [f.stat().st_mtime_ns for f in first]
    again = run(dem, *args, outdir=tmp_path, skip_existing=True, device="cpu")
    assert again == first and [f.stat().st_mtime_ns for f in first] == stamps


def test_sharded_backend_not_ported(dem_with_holes, tmp_path):
    _, dem = dem_with_holes
    with pytest.raises(NotImplementedError, match="A13"):
        tpipe.compute_tpi(dem, [100], outdir=tmp_path, sharded=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        tpipe.compute_sx(dem, 0, 300, outdir=tmp_path, sharded=object(), device="cpu")


@pytest.mark.parametrize("driver,args", [
    ("compute_dem", ([100],)), ("compute_gradient", ([100],)),
    ("compute_valley_ridge", ([300], "valley"))])
def test_slice3_sharded_backends_not_ported(dem_with_holes, tmp_path, driver, args):
    _, dem = dem_with_holes
    with pytest.raises(NotImplementedError, match="A13"):
        getattr(tpipe, driver)(dem, *args, outdir=tmp_path, sharded=object(), device="cpu")


def test_sx_sweep_sharded_backend_not_ported(dem_with_holes, tmp_path):
    _, dem = dem_with_holes
    with pytest.raises(NotImplementedError, match="A13"):
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
    for driver, args in (("compute_dem", ([100],)), ("compute_gradient", ([100],)),
                         ("compute_valley_ridge", ([300], "valley"))):
        with pytest.raises(RuntimeError, match="cuda"):
            getattr(tpipe, driver)(dem, *args, outdir=tmp_path)


@pytest.mark.parametrize("run", list(RUNS))
def test_tiled_driver_matches_single_pass(run, dem_with_holes, tmp_path, monkeypatch):
    """Every driver with ``sharded=TiledRunner`` (bands of 32 rows on the
    90-row grid) against the same driver in one pass, at the tolerances
    above; the Sx planes bit for bit."""
    ind_nans, dem = dem_with_holes
    driver, kwargs = RUNS[run]
    if run == "ridge_streamed":
        monkeypatch.setattr(CFG, "valley_bank_max_bytes", 1)
    extra = {} if driver.startswith("compute_sx") else {"ind_nans": ind_nans}
    run_driver = getattr(tpipe, driver)
    tiled = run_driver(dem, outdir=tmp_path / "tiled", device="cpu",
                       sharded=TiledRunner(32, device="cpu"), **extra, **kwargs)
    single = run_driver(dem, outdir=tmp_path / "single", device="cpu", **extra, **kwargs)
    assert [p.name for p in tiled] == [p.name for p in single]
    refs = {}
    for tf, sf in zip(tiled, single):
        port, ref = read_raster(tf), read_raster(sf)
        refs[ref.name] = ref
        assert port.name == ref.name and port.units == ref.units
        assert port.data.shape == ref.data.shape
        np.testing.assert_array_equal(np.isnan(port.data), np.isnan(ref.data))
        if port.name.startswith("SX_"):
            np.testing.assert_array_equal(port.data.view(np.int32), ref.data.view(np.int32))
        else:
            _assert_close(port, ref, refs)


@pytest.mark.parametrize("driver", ["compute_dem", "compute_gradient"])
def test_tiled_dem_and_gradient_match_jax_runner(driver, dem_with_holes, jax_dem_with_holes,
                                                  tmp_path):
    """Fault C3 of the reference: its tiled compute_dem and compute_gradient
    pass ``valid_shape=`` to TiledRunner.gaussian/.gradient, which take
    none, and raise TypeError. The port's run, held against the JAX
    runner's methods called directly plus the NaN reassignment."""
    from topo_descriptors_tpu import geo

    ind_nans, dem = dem_with_holes
    _, jdem = jax_dem_with_holes
    files = getattr(tpipe, driver)(dem, [300, 2000], ind_nans=ind_nans, outdir=tmp_path,
                                   sharded=TiledRunner(32, device="cpu"), device="cpu")
    sizes, res = geo.scale_to_pixel([300, 2000], jdem)
    jrunner = JaxTiledRunner(32)
    data = np.asarray(jdem.data, np.float32)
    refs = []
    for size in sizes:
        if driver == "compute_dem":
            refs.append(jrunner.gaussian(data, float(size / JCFG.scale_std)))
        else:
            refs.extend(jrunner.gradient(data, float(size / JCFG.scale_std), res, 1.0))
    assert len(files) == len(refs)
    seen = {}
    for path, ref in zip(files, refs):
        port = read_raster(path)
        ref = np.array(ref)
        ref[ind_nans] = np.nan
        seen[port.name] = port.with_data(ref)
        np.testing.assert_array_equal(np.isnan(port.data), np.isnan(ref))
        _assert_close(port, seen[port.name], seen)


def test_tiled_runner_on_another_device_refused(dem_with_holes, tmp_path):
    _, dem = dem_with_holes
    runner = TiledRunner(32, device="cpu")
    runner.device = torch.device("meta")  # a runner bound to another device
    with pytest.raises(ValueError, match="TiledRunner"):
        tpipe.compute_tpi(dem, [100], outdir=tmp_path, sharded=runner, device="cpu")
