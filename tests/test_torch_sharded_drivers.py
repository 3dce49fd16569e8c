"""The port's drivers on a CPU mesh: ``pipeline.*`` with
``sharded=ShardedOps``, the five ``streaming.*_sharded`` drivers, the
runtime's single-process rules and ingest, on the CPU.

Every pipeline driver case of tests/test_torch_pipeline.py runs on a (2, 4)
mesh that divides the 90 x 144 grid and on a (4, 4) one that does not
(padded, cropped back), against the same driver in one pass; the
pipeline cases of tests/test_sharded.py also against the JAX package's
drivers on its ShardedOps. The streaming drivers read a NetCDF DEM with
holes onto a (2, 2) mesh (61 rows: ragged) and are held against the
single pass on the same filled grid. Tolerances are those of
tests/test_torch_pipeline.py; Sx planes bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_pipeline import RUNS, _assert_close
from topo_descriptors_tpu import io as jio
from topo_descriptors_tpu import pipeline as jpipe
from topo_descriptors_tpu.parallel.mesh import make_mesh as jmake_mesh
from topo_descriptors_tpu.parallel.sharded import ShardedOps as JShardedOps
from topo_descriptors_tpu_torch import pipeline as tpipe
from topo_descriptors_tpu_torch import streaming as tstream
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.host import (
    DemWindowReader,
    basodino_like_dem,
    fill_na,
    read_raster,
    write_raster,
)
from topo_descriptors_tpu_torch.parallel import Mesh, ShardedOps, make_mesh, runtime


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _sops(shape):
    return ShardedOps(make_mesh(shape, ["cpu"] * (shape[0] * shape[1])))


def _jsops(shape):
    return JShardedOps(jmake_mesh(shape=shape, devices=jax.devices()[: shape[0] * shape[1]]))


@pytest.fixture(scope="module")
def dem_with_holes():
    data = np.array(basodino_like_dem(ny=90, nx=144, projected=True).data)
    data[10:13, 20:30] = np.nan
    data[50, 100:104] = np.nan
    return fill_na(basodino_like_dem(ny=90, nx=144, projected=True).with_data(data))


def _same_files(files, refs, bits_sx=True):
    assert [p.name for p in files] == [p.name for p in refs]
    seen = {}
    for f, r in zip(files, refs):
        out, ref = read_raster(f), read_raster(r)
        seen[ref.name] = ref
        assert out.name == ref.name and out.units == ref.units
        assert out.data.shape == ref.data.shape
        np.testing.assert_array_equal(np.isnan(out.data), np.isnan(ref.data))
        if bits_sx and out.name.startswith("SX_"):
            np.testing.assert_array_equal(out.data.view(np.int32), ref.data.view(np.int32))
        else:
            _assert_close(out, ref, seen)


@pytest.mark.parametrize("mesh", [(2, 4), (4, 4)], ids=["2x4", "4x4-ragged"])
@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_driver_matches_single_pass(run, mesh, dem_with_holes, tmp_path, monkeypatch):
    ind_nans, dem = dem_with_holes
    driver, kwargs = RUNS[run]
    if run == "ridge_streamed":  # the streamed route on the mesh too
        monkeypatch.setattr(CFG, "valley_bank_max_bytes", 1)
    extra = {} if driver.startswith("compute_sx") else {"ind_nans": ind_nans}
    run_driver = getattr(tpipe, driver)
    if run == "gradient_anisotropic_cropped":
        # sigma 33.5 along y: a 134-row reflect halo on a 90-row grid, which
        # the single pass reflects twice and a mesh refuses, as the JAX
        # package's does on the 2x4 mesh (on the ragged one the JAX package
        # reflects once where two reflections are due)
        with pytest.raises(ValueError, match="reflect halo"):
            run_driver(dem, outdir=tmp_path / "sharded", device="cpu", sharded=_sops(mesh),
                       **extra, **kwargs)
        return
    sharded = run_driver(dem, outdir=tmp_path / "sharded", device="cpu", sharded=_sops(mesh),
                         **extra, **kwargs)
    single = run_driver(dem, outdir=tmp_path / "single", device="cpu", **extra, **kwargs)
    _same_files(sharded, single)


@pytest.mark.parametrize("mesh", [(2, 4), (8, 1)], ids=["2x4", "8x1"])
def test_pipeline_ragged_sharded_drivers(mesh, tmp_path):
    """tests/test_sharded.py's case: TPI and the smoothed DEM on a 61 x 94
    grid through the drivers, which pad, compute and crop."""
    raster, jraster = basodino_like_dem(61, 94, seed=11), jio.basodino_like_dem(61, 94, seed=11)
    sops, jsops = _sops(mesh), _jsops(mesh)
    for driver in ("compute_tpi", "compute_dem"):
        port = getattr(tpipe, driver)(raster, 200, outdir=tmp_path / "port", sharded=sops,
                                      device="cpu")
        single = getattr(tpipe, driver)(raster, 200, outdir=tmp_path / "single", device="cpu")
        ref = getattr(jpipe, driver)(jraster, 200, outdir=tmp_path / "jax", sharded=jsops)
        _same_files(port, single)
        _same_files(port, ref)
        assert read_raster(port[0]).data.shape == (61, 94)


@pytest.mark.parametrize("mesh", [(2, 4), (8, 1)], ids=["2x4", "8x1"])
def test_pipeline_sx_sweep_sharded_ragged(mesh, tmp_path):
    raster, jraster = basodino_like_dem(61, 94, seed=13), jio.basodino_like_dem(61, 94, seed=13)
    port = tpipe.compute_sx_sweep(raster, [0.0, 90.0], 300.0, outdir=tmp_path / "port",
                                  sharded=_sops(mesh), device="cpu")
    single = tpipe.compute_sx_sweep(raster, [0.0, 90.0], 300.0, outdir=tmp_path / "single",
                                    device="cpu")
    ref = jpipe.compute_sx_sweep(jraster, [0.0, 90.0], 300.0, outdir=tmp_path / "jax",
                                 sharded=_jsops(mesh))
    _same_files(port, single)
    _same_files(port, ref, bits_sx=False)


@pytest.mark.parametrize("mesh", [(2, 4), (8, 1)], ids=["2x4", "8x1"])
def test_pipeline_fused_sharded_tpi_std(mesh, tmp_path):
    raster, jraster = basodino_like_dem(64, 96, seed=18), jio.basodino_like_dem(64, 96, seed=18)
    scales = [200, 500, 700]
    port = tpipe.compute_tpi_std(raster, scales, outdir=tmp_path / "port", sharded=_sops(mesh),
                                 device="cpu")
    assert len(port) == 6
    _same_files(port, tpipe.compute_tpi_std(raster, scales, outdir=tmp_path / "single",
                                            device="cpu"))
    _same_files(port, jpipe.compute_tpi_std(jraster, scales, outdir=tmp_path / "jax",
                                            sharded=_jsops(mesh)))


@pytest.mark.parametrize("mesh", [(2, 4), (8, 1)], ids=["2x4", "8x1"])
def test_host_local_to_global(mesh):
    sops = _sops(mesh)
    dem = basodino_like_dem(64, 96, seed=2).data.astype(np.float32)
    gy, gx = mesh
    bh, bw = 64 // gy, 96 // gx
    blocks = [dem[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw] for i in range(gy) for j in range(gx)]
    arr = runtime.host_local_to_global(sops.mesh, blocks)
    np.testing.assert_array_equal(arr.numpy(), dem)
    np.testing.assert_array_equal(np.asarray(sops.tpi(arr, 7)),
                                  np.asarray(sops.tpi(sops.put(dem), 7)))
    with pytest.raises(ValueError, match="local devices"):
        runtime.host_local_to_global(sops.mesh, blocks[:-1])


def test_runtime_initialize_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert runtime.initialize() is False  # nothing to join: an explicit no-op
    assert runtime.initialize() is False  # idempotent
    monkeypatch.setenv("RANK", "0")  # a partial torchrun environment is an error
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        runtime.initialize()
    with pytest.raises(ValueError, match="together"):
        runtime.initialize(init_method="tcp://127.0.0.1:1")


class _CountingReader:
    """A window reader that records the row windows it served."""

    def __init__(self, data):
        self.data, self.windows = data, []

    @property
    def shape(self):
        return self.data.shape

    def __getitem__(self, key):
        rows = key[0] if isinstance(key, tuple) else key
        self.windows.append((rows.start, rows.stop))
        return self.data[key]


def test_ingest_sharded_reads_only_its_rows():
    data = basodino_like_dem(61, 94, seed=4).data.astype(np.float32)
    mesh = make_mesh((2, 4), ["cpu"] * 8)
    reader = _CountingReader(data)
    arr, valid = runtime.ingest_sharded(reader, mesh, fill=0.0)
    assert valid == (61, 94) and arr.shape == (62, 96)
    assert reader.windows == [(0, 31), (31, 61)]  # one band per mesh row
    expect = np.zeros((62, 96), np.float32)
    expect[:61, :94] = data
    np.testing.assert_array_equal(arr.numpy(), expect)
    # a process that owns only the first mesh row reads only its rows
    half = Mesh([(0 if k < 4 else 1, "cpu") for k in range(8)], (2, 4))
    reader = _CountingReader(data)
    part, _ = runtime.ingest_sharded(reader, half, fill=np.nan)
    assert reader.windows == [(0, 31)] and sorted(part.blocks) == half.local_blocks()


def test_backends_refused(dem_with_holes, tmp_path):
    _, dem = dem_with_holes
    with pytest.raises(TypeError, match="ShardedOps or a TiledRunner"):
        tpipe.compute_tpi(dem, [100], outdir=tmp_path, sharded=object(), device="cpu")
    meta = ShardedOps(Mesh([(0, "meta")] * 4, (2, 2)))  # blocks on another device
    with pytest.raises(ValueError, match="mesh's blocks"):
        tpipe.compute_sx(dem, 0, 300, outdir=tmp_path, sharded=meta, device="cpu")
    assert not list(tmp_path.iterdir())


# --- streaming: windowed ingest onto the mesh ---------------------------------


@pytest.fixture(scope="module")
def dem_file(tmp_path_factory):
    r = basodino_like_dem(ny=61, nx=74, projected=True, seed=7)
    data = r.data.copy()
    data[12:15, 20:26] = -9999.0  # below the minimum elevation: masked to NaN
    data[40, 5] = np.nan
    path = tmp_path_factory.mktemp("sharded_stream") / "dem.nc"
    write_raster(r.with_data(data), path)
    return path


STREAMED = {
    # (streaming driver, args, kwargs, pipeline driver, args, kwargs)
    "tpi_std": ("compute_tpi_std_sharded", ([300, 500],), {},
                "compute_tpi_std", ([300, 500],), {}),
    "std_smoothed": ("compute_tpi_std_sharded", ([300],), {"kinds": ("std",), "smth_factors": [1]},
                     "compute_std", ([300],), {"smth_factors": [1]}),
    "dem": ("compute_dem_sharded", ([400],), {}, "compute_dem", ([400],), {}),
    "gradient": ("compute_gradient_sharded", ([300],), {}, "compute_gradient", ([300],), {}),
    "valley": ("compute_valley_ridge_sharded", ([500],), {"mode": "valley"},
               "compute_valley_ridge", ([500],), {"mode": "valley"}),
    "ridge_streamed": ("compute_valley_ridge_sharded", ([300],), {"mode": "ridge"},
                       "compute_valley_ridge", ([300],), {"mode": "ridge"}),
    "sx_single": ("compute_sx_sharded", (45.0, 300.0), {}, "compute_sx", (45.0, 300.0), {}),
    "sx_sweep": ("compute_sx_sharded", ([0.0, 90.0], 300.0), {},
                 "compute_sx_sweep", ([0.0, 90.0], 300.0), {}),
}


@pytest.mark.parametrize("case", list(STREAMED))
def test_streamed_sharded_driver_matches_single_pass(case, dem_file, tmp_path, monkeypatch):
    sdriver, sargs, skw, pdriver, pargs, pkw = STREAMED[case]
    if case == "ridge_streamed":
        monkeypatch.setattr(CFG, "valley_bank_max_bytes", 1)
    files = getattr(tstream, sdriver)(dem_file, *sargs, sops=_sops((2, 2)),
                                      outdir=tmp_path / "sharded", band_rows=16, **skw)
    with DemWindowReader(dem_file) as reader:
        h = reader.shape[0]
        ind_nans = np.where(reader.nan_rows(0, h))
        filled = reader.read_rows(0, h)
    from topo_descriptors_tpu_torch.host import Raster

    with DemWindowReader(dem_file) as reader:
        dem = Raster(data=filled, grid=reader.grid, name="DEM", units="m")
    extra = {} if pdriver.startswith("compute_sx") else {"ind_nans": ind_nans}
    single = getattr(tpipe, pdriver)(dem, *pargs, outdir=tmp_path / "single", device="cpu",
                                     **extra, **pkw)
    _same_files(files, single)
    if extra:
        assert np.isnan(read_raster(files[0]).data[ind_nans]).all()


def test_streamed_sharded_writer_failure_aborts_all(dem_file, tmp_path, monkeypatch):
    """Guard C1 on the sharded drivers: a writer failing on its second band
    aborts every writer of the call, and no file is published."""
    opened = []
    real = tstream._open_writer

    def failing(dem, name, outdir, units):
        path, writer = real(dem, name, outdir, units)
        write_rows = writer.write_rows

        def write(start, band):
            if start >= 16:
                raise OSError("writer failed on its second band")
            write_rows(start, band)

        writer.write_rows = write
        opened.append(writer)
        return path, writer

    monkeypatch.setattr(tstream, "_open_writer", failing)
    with pytest.raises(OSError, match="second band"):
        tstream.compute_tpi_std_sharded(dem_file, [300, 500], _sops((2, 2)),
                                        outdir=tmp_path, band_rows=16)
    assert len(opened) == 4 and not list(tmp_path.glob("*.nc*"))
