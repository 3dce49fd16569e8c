"""The port's CLI on the CPU (``--device cpu``): the cases of
tests/test_cli.py, with outputs held against the JAX CLI's within the
tolerances of tests/test_torch_pipeline.py; ``--sharded`` on a mesh of CPU
blocks, plain and streamed, against the port's single pass."""

import numpy as np
import pytest
import torch

from topo_descriptors_tpu.cli import main as jax_main
from topo_descriptors_tpu.io import basodino_like_dem, read_raster, write_raster
from topo_descriptors_tpu_torch.cli import main

TOL = {"TPI": dict(rtol=1e-5, atol=1e-3), "STD": dict(rtol=1e-5, atol=2e-2),
       "SX": dict(rtol=0, atol=2e-5), "DEM": dict(rtol=1e-5, atol=1e-3),
       "WE": dict(rtol=1e-3, atol=5e-5), "SN": dict(rtol=1e-3, atol=5e-5),
       "SLOPE": dict(rtol=1e-3, atol=1e-3), "ASPECT": dict(rtol=0, atol=2e-2)}


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


def _same_outputs(port_dir, jax_dir):
    names = sorted(p.name for p in jax_dir.glob("topo_*.nc"))
    assert names and sorted(p.name for p in port_dir.glob("topo_*.nc")) == names
    for name in names:
        a, b = read_raster(port_dir / name), read_raster(jax_dir / name)
        assert a.name == b.name and a.units == b.units
        np.testing.assert_allclose(a.data, b.data, equal_nan=True, **TOL[a.name.split("_")[0]])


def test_cli_synthetic_tpi_std(tmp_path):
    args = ["--synthetic", "48x64", "--descriptors", "tpi", "std", "--scales", "300", "600"]
    assert main(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert sorted(p.name for p in (tmp_path / "port").glob("topo_*.nc")) == [
        "topo_STD_300M.nc", "topo_STD_600M.nc", "topo_TPI_300M.nc", "topo_TPI_600M.nc"]
    _same_outputs(tmp_path / "port", tmp_path / "jax")


def test_cli_skip_existing(tmp_path):
    args = ["--synthetic", "48x64", "--descriptors", "tpi", "--scales", "300",
            "--outdir", str(tmp_path), "--skip-existing", "--device", "cpu"]
    assert main(args) == 0
    out = tmp_path / "topo_TPI_300M.nc"
    first_mtime = out.stat().st_mtime_ns
    assert main(args) == 0  # the second run skips, the file is untouched
    assert out.stat().st_mtime_ns == first_mtime


def test_cli_tiled_runs(tmp_path):
    args = ["--synthetic", "64x64", "--descriptors", "tpi", "sx", "--scales", "300",
            "--sx-azimuths", "0", "180", "--sx-radius", "200", "--device", "cpu"]
    assert main(args + ["--outdir", str(tmp_path / "tiled"), "--tiled", "16"]) == 0
    assert main(args + ["--outdir", str(tmp_path / "single")]) == 0
    _same_outputs(tmp_path / "tiled", tmp_path / "single")


def test_cli_tiled_default_descriptors(tmp_path):
    """The default battery (tpi std gradient) with --tiled: gradient runs
    banded here (the JAX CLI raises a TypeError at gradient, fault C3)."""
    args = ["--synthetic", "48x64", "--scales", "300", "600", "--device", "cpu"]
    assert main(args + ["--outdir", str(tmp_path / "tiled"), "--tiled", "16"]) == 0
    assert main(args + ["--outdir", str(tmp_path / "single")]) == 0
    assert len(list((tmp_path / "tiled").glob("topo_*.nc"))) == 2 * 2 + 2 * 4
    _same_outputs(tmp_path / "tiled", tmp_path / "single")


@pytest.fixture(scope="module")
def dem_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "dem.nc"
    write_raster(basodino_like_dem(ny=64, nx=64, projected=True), path)
    return path


def test_cli_stream_runs(tmp_path, dem_path):
    args = ["--dem", str(dem_path), "--descriptors", "dem", "tpi", "std", "gradient", "sx",
            "--scales", "300", "--sx-azimuths", "0", "180", "--sx-radius", "200",
            "--stream", "16"]
    assert main(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jax_main(args + ["--outdir", str(tmp_path / "jax")]) == 0
    assert (tmp_path / "port" / "topo_SLOPE_300M_SIGRATIO1.nc").exists()
    sx0 = read_raster(tmp_path / "port" / "topo_SX_RADIUS200_AZIMUTH0.nc")
    assert np.isfinite(sx0.data).all()
    _same_outputs(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("extra", [
    ["--synthetic", "32x32", "--stream", "8"],  # --stream needs --dem
    ["--dem", "dem.nc", "--stream", "8", "--tiled", "8"],
    ["--dem", "dem.nc", "--stream", "8", "--crop-x", "0", "100"],
], ids=["without-dem", "with-tiled", "with-crop"])
def test_cli_stream_refuses(tmp_path, extra):
    with pytest.raises(SystemExit):
        main(extra + ["--outdir", str(tmp_path), "--device", "cpu"])
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("extra,match", [
    (["--sharded", "--mesh", "0", "2"], "mesh shape"),
    (["--mesh", "2", "4"], "add --sharded"),
    (["--sharded", "--tiled", "8"], "mutually exclusive"),
], ids=["sharded", "mesh", "sharded-and-tiled"])
def test_cli_sharded_not_ported(tmp_path, extra, match):
    """Misuse of --sharded/--mesh exits before any output: an empty mesh,
    --mesh without --sharded, --sharded with --tiled (the mesh itself runs
    in test_cli_sharded_matches_single_pass)."""
    with pytest.raises(SystemExit, match=match):
        main(["--synthetic", "32x32", "--outdir", str(tmp_path), "--device", "cpu"] + extra)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("mode", ["plain", "stream"])
def test_cli_sharded_matches_single_pass(tmp_path, dem_path, mode):
    """``--sharded --mesh 2 2 --device cpu`` places four blocks on the CPU;
    with --stream each block is read straight onto the mesh and the
    outputs stream back in bands. The 61 x 94 grid does not divide the
    mesh. Outputs equal the single pass's (Sx bit for bit)."""
    write_raster(basodino_like_dem(ny=61, nx=94, projected=True), tmp_path / "dem.nc")
    args = ["--dem", str(tmp_path / "dem.nc"), "--descriptors", "dem", "tpi", "std", "gradient",
            "valley", "sx", "--scales", "200", "--sx-azimuths", "0", "90", "--sx-radius", "300",
            "--device", "cpu"]
    sharded = ["--sharded", "--mesh", "2", "2"] + (["--stream", "16"] if mode == "stream" else [])
    assert main(args + sharded + ["--outdir", str(tmp_path / "mesh")]) == 0
    assert main(args + ["--outdir", str(tmp_path / "single")]) == 0
    names = sorted(p.name for p in (tmp_path / "single").glob("topo_*.nc"))
    assert len(names) == 11 and sorted(p.name for p in (tmp_path / "mesh").glob("topo_*.nc")) == names
    for name in names:
        a, b = read_raster(tmp_path / "mesh" / name), read_raster(tmp_path / "single" / name)
        kind = a.name.split("_")[0]
        if kind == "SX":
            np.testing.assert_array_equal(a.data.view(np.int32), b.data.view(np.int32))
        elif kind != "VALLEY":
            np.testing.assert_allclose(a.data, b.data, equal_nan=True, **TOL[kind])
        elif "_NORM_" in a.name:
            np.testing.assert_allclose(a.data, b.data, rtol=1e-3, atol=2e-3)


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the exit where CUDA is missing")
    with pytest.raises(SystemExit, match="cuda"):
        main(["--synthetic", "32x32", "--descriptors", "tpi", "--scales", "300",
              "--outdir", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []
