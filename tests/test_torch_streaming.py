"""The port's streaming drivers against the JAX streaming drivers, on the CPU.

Both packages stream the same DEM with holes (NaN and below
``CFG.min_elevation``) from NetCDF and from a strip GeoTIFF, in bands of
16 rows, and write NetCDF through the shared band writer; the files are
read back and compared: names, units, NaN positions and values, with the
tolerances of tests/test_torch_pipeline.py (Sx within 2e-5 degrees). The
port reads through a ``DemWindowReader`` whose ``max_rows_read`` must stay
within one band plus both halos.

Also here: a failing driver leaves no output file (fault C1 of the
reference), and pipelined equals serial bit for bit on strip GeoTIFFs,
where the prefetch and the NaN-mask reads share one file handle (fault C4
of the reference).
"""

import numpy as np
import pytest
import torch

from topo_descriptors_tpu import io as jio
from topo_descriptors_tpu import streaming as jstream
from topo_descriptors_tpu_torch import streaming as tstream
from topo_descriptors_tpu_torch.host import (
    DemWindowReader,
    RasterBandWriter,
    basodino_like_dem,
    gaussian_radius,
    read_raster,
    rotated_extent,
    scale_to_pixel,
    sx_offsets,
    sx_sweep_offsets,
    write_geotiff,
    write_raster,
)

TILE_ROWS = 16
TOL = {"TPI": dict(rtol=1e-5, atol=1e-3), "STD": dict(rtol=1e-5, atol=2e-2),
       "SX": dict(rtol=0, atol=2e-5), "DEM": dict(rtol=1e-5, atol=1e-3),
       "WE": dict(rtol=1e-3, atol=5e-5), "SN": dict(rtol=1e-3, atol=5e-5),
       "SLOPE": dict(rtol=1e-3, atol=1e-3), "ASPECT": dict(rtol=0, atol=2e-2),
       "VALLEY": dict(rtol=1e-3, atol=2e-3)}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Banded runs issue many small torch ops; with several test workers on
    the machine, an intra-op thread team per op oversubscribes the cores
    and stalls each op at its barrier (a 0.15 s test took 67 s), so these
    tests run torch on one intra-op thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def dem_raster():
    r = basodino_like_dem(ny=61, nx=74, projected=True, seed=7)
    data = r.data.copy()
    data[12:15, 20:26] = -9999.0  # below the minimum elevation: masked to NaN
    data[40, 5] = np.nan
    return r.with_data(data)


@pytest.fixture(scope="module")
def dem_paths(tmp_path_factory, dem_raster):
    root = tmp_path_factory.mktemp("stream")
    write_raster(dem_raster, root / "dem.nc")
    write_geotiff(dem_raster, root / "dem.tif", rows_per_strip=16)
    return {"nc": root / "dem.nc", "tif": root / "dem.tif"}


def _halo(driver, args, reader):
    """Rows of halo each band reads, from the driver's own geometry."""
    if driver == "compute_sx":
        res = reader.grid.resolution_meters()
        dx, dy = float(res["x"].mean()), float(res["y"].mean())
        if np.ndim(args[0]):
            return sx_sweep_offsets(args[0], args[1], dx, dy)[2]
        return sx_offsets(args[0], args[1], dx, dy)[2]
    sizes, _ = scale_to_pixel(args[0], reader)
    size = int(max(sizes))
    smooth = gaussian_radius(size / 4) if size / 4 > 1 else 0
    return {"compute_tpi_std": size // 2, "compute_std": size // 2 + smooth,
            "compute_dem": gaussian_radius(size / 4), "compute_gradient": smooth + 1,
            "compute_valley_ridge": rotated_extent(size)[0] // 2 + 1}[driver]


CALLS = {
    "tpi_std": ("compute_tpi_std", ([300, 500],), {}),
    "std_smoothed": ("compute_std", ([300],), {"smth_factors": [1]}),
    "dem": ("compute_dem", ([400],), {}),
    "gradient": ("compute_gradient", ([300],), {}),
    "valley": ("compute_valley_ridge", ([500],), {"mode": "valley"}),
    "sx_single": ("compute_sx", (45.0, 300.0), {}),
    "sx_sweep": ("compute_sx", ([0.0, 90.0], 300.0), {}),
}


@pytest.mark.parametrize("source", ["nc", "tif"])
@pytest.mark.parametrize("call", list(CALLS))
def test_streamed_driver_matches_jax(call, source, dem_paths, dem_raster, tmp_path):
    driver, args, kwargs = CALLS[call]
    ref = getattr(jstream, driver)(dem_paths[source], *args, outdir=tmp_path / "jax",
                                   tile_rows=TILE_ROWS, **kwargs)
    with DemWindowReader(dem_paths[source]) as reader:
        out = getattr(tstream, driver)(reader, *args, outdir=tmp_path / "port",
                                       tile_rows=TILE_ROWS, device="cpu", **kwargs)
        halo = _halo(driver, args, reader)
        assert reader.max_rows_read <= TILE_ROWS + 2 * halo
        assert reader.max_rows_read < reader.shape[0]
    assert [p.name for p in out] == [p.name for p in ref]
    for p, r in zip(out, ref):
        # the files the port wrote, read by the JAX package, and the other way round
        port, jax_out = jio.read_raster(p), read_raster(r)
        assert port.name == jax_out.name and port.units == jax_out.units
        assert port.data.shape == dem_raster.data.shape
        np.testing.assert_array_equal(np.isnan(port.data), np.isnan(jax_out.data))
        kind = port.name.split("_")[0]
        if port.name.startswith("VALLEY_DIR"):
            keep = ~np.isnan(jax_out.data)
            assert (port.data[keep] != jax_out.data[keep]).mean() < 0.02
            continue
        np.testing.assert_allclose(port.data, jax_out.data, equal_nan=True, **TOL[kind])
    if kwargs.get("reassign_nans", driver != "compute_sx"):
        assert np.isnan(read_raster(out[0]).data[12:15, 20:26]).all()
    assert not list((tmp_path / "port").glob("*.partial"))


def test_streamed_skip_existing(tmp_path, dem_paths):
    first = tstream.compute_tpi(dem_paths["tif"], [300], outdir=tmp_path, tile_rows=TILE_ROWS,
                                device="cpu")
    mtime = first[0].stat().st_mtime_ns
    again = tstream.compute_tpi(dem_paths["tif"], [300], outdir=tmp_path, tile_rows=TILE_ROWS,
                                skip_existing=True, device="cpu")
    assert again == first and first[0].stat().st_mtime_ns == mtime
    both = tstream.compute_tpi_std(dem_paths["tif"], [300], outdir=tmp_path,
                                   tile_rows=TILE_ROWS, skip_existing=True, device="cpu")
    assert [p.name for p in both] == ["topo_TPI_300M.nc", "topo_STD_300M.nc"]


@pytest.mark.parametrize("driver,args", [
    ("compute_tpi_std", ([300, 500],)), ("compute_gradient", ([300],)),
    ("compute_sx", ([0.0, 90.0], 300.0))])
def test_failed_driver_leaves_no_file(driver, args, dem_paths, tmp_path, monkeypatch):
    """A writer that fails on its third band: the driver re-raises and
    aborts every writer it opened, so neither a final-named file nor a
    .partial is left (the reference publishes the truncated file)."""

    class FailingWriter(RasterBandWriter):
        def write_rows(self, r0, block):
            if r0 >= 2 * TILE_ROWS:
                raise OSError("disk full")
            super().write_rows(r0, block)

    def open_failing(dem, name, outdir, units):
        outdir.mkdir(parents=True, exist_ok=True)
        path = outdir / f"topo_{name.upper()}.nc"
        return path, FailingWriter(path, dem.grid, name.upper(), units=units)

    monkeypatch.setattr(tstream, "_open_writer", open_failing)
    with pytest.raises(OSError, match="disk full"):
        getattr(tstream, driver)(dem_paths["nc"], *args, outdir=tmp_path, tile_rows=TILE_ROWS,
                                 device="cpu")
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def strip_tiffs(tmp_path_factory):
    """A 512x512 DEM with holes as strip GeoTIFFs of 8 rows, uncompressed
    and deflate."""
    r = basodino_like_dem(ny=512, nx=512, projected=True, seed=3)
    data = r.data.copy()
    rng = np.random.default_rng(5)
    for y, x in rng.integers(0, 500, size=(40, 2)):
        data[y : y + 3, x : x + 9] = np.nan
    data[200:203, :40] = -9999.0
    root = tmp_path_factory.mktemp("c4")
    paths = {}
    for compress in (False, True):
        paths[compress] = root / f"dem_{'deflate' if compress else 'raw'}.tif"
        write_geotiff(r.with_data(data), paths[compress], compress=compress, rows_per_strip=8)
    return paths


@pytest.mark.parametrize("compress", [False, True], ids=["uncompressed", "deflate"])
def test_pipelined_equals_serial_on_strip_geotiff(compress, strip_tiffs, tmp_path):
    """16 bands: the prefetch thread reads band k+1 while the writer thread
    asks the same reader for band k-1's NaN mask."""
    outs = {}
    for pipeline in (True, False):
        files = tstream.compute_tpi_std(strip_tiffs[compress], [300, 600],
                                        outdir=tmp_path / str(pipeline), tile_rows=32,
                                        pipeline=pipeline, device="cpu")
        outs[pipeline] = [read_raster(f).data for f in files]
    for a, b in zip(outs[True], outs[False]):
        assert np.isnan(a).sum() >= 40 * 3
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_streaming_defaults_to_cuda(dem_paths, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is missing")
    with pytest.raises(RuntimeError, match="cuda"):
        tstream.compute_tpi(dem_paths["nc"], [300], outdir=tmp_path)
    assert list(tmp_path.iterdir()) == []
