"""The port's two examples against the JAX package's, on the CPU.

``compute_batch`` (the reference's batch) runs on a 90 x 144 Basodino-like
grid with NaN holes at four of the example's scales, so that valley/ridge
(``scales[3:]``) runs the 2 km bank; the JAX side runs the JAX example's
own calls with its arguments (``examples/compute_topo_descriptors.py``) on
the same raster. The walkthrough runs the JAX example's ``main`` itself on
the same small raster. Every output file is held against its JAX
counterpart under the tolerances of tests/test_torch_pipeline.py, but
for the valley/ridge norm at 2 km (a 67-px kernel, ~4489 taps per sum,
norms up to ~5e3): there the atol also takes 1e-5 of the largest norm,
the rule of chip_smoke.py's phase 6 for its 67 and 667 px scales (the
mesh's row-channel convolution sums in another order than the JAX bank's
matmuls: 2.9e-3 on one pixel of the 2 x 2 mesh). The batch also runs on
the ``--tiled`` and ``--sharded`` (a 2 x 2 CPU mesh) backends.
"""

import importlib.util
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_pipeline import TOL, _assert_close
from topo_descriptors_tpu import grid as jgrid
from topo_descriptors_tpu import io as jio
from topo_descriptors_tpu import pipeline as jpipe
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.examples import compute_topo_descriptors as batch
from topo_descriptors_tpu_torch.examples import walkthrough as tour
from topo_descriptors_tpu_torch.host import basodino_like_dem, read_raster
from topo_descriptors_tpu_torch.parallel import ShardedOps, TiledRunner

ROOT = Path(__file__).resolve().parent.parent
SCALES = [100, 300, 500, 2000]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """As tests/test_torch_pipeline.py: many small torch ops per driver."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _holes(raster):
    data = np.array(raster.data)
    data[10:13, 20:30] = np.nan
    data[50, 100:104] = np.nan
    return raster.with_data(data)


def _jax_batch(raw, scales, outdir):
    """The JAX example's calls (examples/compute_topo_descriptors.py:47-73)
    with its arguments, on ``raw`` and ``scales``, writing to ``outdir``."""
    ind_nans, dem_ds = jgrid.fill_na(raw)
    common = dict(ind_nans=ind_nans, crop=None, sharded=None, skip_existing=True,
                  outdir=outdir)
    files = jpipe.compute_dem(dem_ds, scales, **common)
    files += jpipe.compute_tpi(dem_ds, scales, smth_factors=None, **common)
    files += jpipe.compute_tpi(dem_ds, scales, smth_factors=1, **common)
    files += jpipe.compute_gradient(dem_ds, scales, sig_ratios=1, **common)
    files += jpipe.compute_std(dem_ds, scales, **common)
    files += jpipe.compute_valley_ridge(dem_ds, scales[3:], mode="valley",
                                        flat_list=[0, 0.2, 0.4], smth_factors=0.5, **common)
    files += jpipe.compute_valley_ridge(dem_ds, scales[3:], mode="ridge",
                                        flat_list=[0, 0.15, 0.3], smth_factors=0.5, **common)
    files += jpipe.compute_sx(dem_ds, 0, 1000, crop=None, sharded=None, outdir=outdir)
    return files


@pytest.fixture(scope="module")
def jax_batch(tmp_path_factory):
    return _jax_batch(_holes(jio.basodino_like_dem(ny=90, nx=144, projected=True)), SCALES,
                      tmp_path_factory.mktemp("jax_batch"))


def _assert_files_match(port_files, jax_files, nan_holes=None):
    assert [p.name for p in port_files] == [p.name for p in jax_files]
    refs = {r.name: r for r in map(jio.read_raster, jax_files)}  # the aspect reads its slope
    for pf in port_files:
        port = read_raster(pf)
        ref = refs[port.name]
        assert port.name == ref.name and port.units == ref.units
        assert port.data.shape == ref.data.shape
        np.testing.assert_array_equal(np.isnan(port.data), np.isnan(ref.data))
        if nan_holes is not None and not port.name.startswith("SX_"):
            assert np.isnan(port.data[nan_holes]).all()
        if "_NORM_2000M" in port.name:
            atol = TOL["VALLEY"]["atol"] + 1e-5 * float(np.nanmax(ref.data))
            np.testing.assert_allclose(port.data, ref.data, rtol=TOL["VALLEY"]["rtol"], atol=atol)
        else:
            _assert_close(port, ref, refs)


@pytest.mark.parametrize("backend", [None, "tiled", "sharded"])
def test_batch_matches_jax_example(backend, jax_batch, tmp_path, monkeypatch):
    raw = _holes(basodino_like_dem(ny=90, nx=144, projected=True))
    monkeypatch.setattr(CFG, "mesh_shape", (2, 2))  # --sharded: four CPU blocks
    sharded = batch.make_backend(backend, device="cpu")
    if backend == "tiled":
        assert isinstance(sharded, TiledRunner) and sharded.tile_rows == 4096
    if backend == "sharded":
        assert isinstance(sharded, ShardedOps) and sharded.mesh.shape == (2, 2)
    files = batch.compute_batch(raw, SCALES, device="cpu", outdir=tmp_path, sharded=sharded)
    # 4 DEM, 2 x 4 TPI, 16 gradient, 4 STD, 2 x 2 valley/ridge at 2 km, 1 Sx
    assert len(files) == 37
    _assert_files_match(files, jax_batch, nan_holes=np.isnan(raw.data))


def test_batch_keeps_existing_files(tmp_path):
    raw = basodino_like_dem(ny=40, nx=48, projected=True)
    first = batch.compute_batch(raw, [100, 200, 300, 400], device="cpu", outdir=tmp_path)
    stamps = [f.stat().st_mtime_ns for f in first]
    again = batch.compute_batch(raw, [100, 200, 300, 400], device="cpu", outdir=tmp_path)
    assert again == first
    # every family but Sx skips its existing files (the example, as the
    # reference's script, passes no skip_existing to compute_sx)
    kept = [f.stat().st_mtime_ns == t for f, t in zip(first, stamps)]
    assert kept == [not f.name.startswith("topo_SX_") for f in first]


@pytest.mark.parametrize("argv,backend,crop", [
    (["--demo", "--device", "cpu"], type(None), None),
    (["--device", "cpu", "--tiled"], TiledRunner, None),
    (["DEM.nc", "--device", "cpu", "--sharded"], ShardedOps, batch.LV03_DOMAIN),
])
def test_batch_main_arguments(argv, backend, crop, monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(batch, "compute_batch", lambda *a, **k: calls.append((a, k)) or [])
    monkeypatch.setattr(batch, "get_dem_netcdf", lambda path: ("read", path))
    assert batch.main(argv + ["--outdir", str(tmp_path)]) == 0
    (dem_ds, scales, device, outdir), kwargs = calls[0]
    assert scales == batch.SCALES_METERS and len(scales) == 12 and scales[3:][0] == 1000
    assert device == "cpu" and outdir == str(tmp_path)
    assert isinstance(kwargs["sharded"], backend) and kwargs["crop"] == crop
    if argv[0] == "DEM.nc":
        assert dem_ds == ("read", "DEM.nc")
    else:
        assert dem_ds.data.shape == (900, 1440)


def _jax_walkthrough(raster, outdir, monkeypatch):
    """Run examples/walkthrough.py's ``main`` on ``raster`` into ``outdir``."""
    spec = importlib.util.spec_from_file_location("jax_walkthrough", ROOT / "examples" / "walkthrough.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with monkeypatch.context() as m:
        m.setattr(jio, "basodino_like_dem", lambda projected=True: raster)
        m.setattr(tempfile, "mkdtemp", lambda prefix="": outdir.mkdir() or str(outdir))
        module.main()
    return sorted(Path(outdir).glob("topo_*.nc"))


def test_walkthrough_matches_jax_example(tmp_path, monkeypatch, capsys):
    jax_files = _jax_walkthrough(jio.basodino_like_dem(ny=90, nx=144, projected=True),
                                 tmp_path / "jax", monkeypatch)
    capsys.readouterr()
    files = tour.walkthrough(basodino_like_dem(ny=90, nx=144, projected=True), device="cpu",
                             outdir=tmp_path / "port")
    printed = capsys.readouterr().out
    assert printed.startswith("device: cpu\n")
    # TPI 500 m, 2 x 4 gradient, 2 x 2 TPI+STD, 2 valley, 36 sweep planes (the
    # azimuth-0 plane rewrites compute_sx's file of the same name)
    assert len(files) == 51 and all(f.name in printed for f in files)
    _assert_files_match(files, jax_files)


def test_walkthrough_main(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(tour, "walkthrough", lambda *a, **k: calls.append((a, k)) or [])
    assert tour.main(["--device", "cpu", "--outdir", str(tmp_path)]) == 0
    (raster,), kwargs = calls[0]
    assert raster.data.shape == (900, 1440)
    assert kwargs == dict(device="cpu", outdir=str(tmp_path))
