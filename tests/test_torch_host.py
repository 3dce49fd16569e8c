"""The port's own host layer against the JAX package's, on the same inputs.

The port keeps copies of the JAX package's jax-free modules (``config``,
``geo``, ``grid``, ``io``, ``kernels``, ``utils.timing``); each copied
function must return exactly what its original returns. Files written by
one package are read by the other (GeoTIFF and NetCDF), and the port's
``Config.from_file`` parses the conf format of the JAX package.
"""

import numpy as np
import pytest

import topo_descriptors_tpu.config as jconfig
import topo_descriptors_tpu.geo as jgeo
import topo_descriptors_tpu.grid as jgrid
import topo_descriptors_tpu.io as jio
import topo_descriptors_tpu.kernels as jkernels
import topo_descriptors_tpu_torch.config as tconfig
import topo_descriptors_tpu_torch.geo as tgeo
import topo_descriptors_tpu_torch.grid as tgrid
import topo_descriptors_tpu_torch.io as tio
import topo_descriptors_tpu_torch.kernels as tkernels


def _grids(ny=24, nx=32, geographic=False):
    """The same grid as a JAX and a port ``RasterGrid``."""
    if geographic:
        y, x, crs = np.linspace(46.55, 46.30, ny), np.linspace(8.2, 8.6, nx), "epsg:4326"
    else:
        y, x, crs = 5.1e6 + 30.0 * np.arange(ny)[::-1], 6.8e5 + 30.0 * np.arange(nx), "epsg:32632"
    return jgrid.RasterGrid(y, x, crs), tgrid.RasterGrid(y, x, crs)


def _rasters(data, geographic=False):
    jg, tg = _grids(*data.shape, geographic=geographic)
    return (jgrid.Raster(data=data, grid=jg, name="DEM", units="m"),
            tgrid.Raster(data=data.copy(), grid=tg, name="DEM", units="m"))


def _dem_with_holes():
    data = jio.synthetic_dem(24, 32, seed=5)
    data[3:6, 4:9] = np.nan
    data[20, 30:] = np.nan
    return data


# (name, function of the package's modules) -> value; each case runs with
# the JAX modules and with the port's, on the same input
CASES = {
    "scale_to_pixel": lambda geo, grid, kernels, io: geo.scale_to_pixel(
        [100, 500, 2000], _rasters(io.synthetic_dem(24, 32, seed=1))[grid is tgrid]),
    "scale_to_pixel_geographic": lambda geo, grid, kernels, io: geo.scale_to_pixel(
        [100, 2000], _rasters(io.synthetic_dem(24, 32, seed=1), True)[grid is tgrid]),
    "get_sigmas": lambda geo, grid, kernels, io: geo.get_sigmas([None, 0.5, 1.0, 0], [3, 17, 67, 5]),
    "circular_kernel": lambda geo, grid, kernels, io: [
        kernels.circular_kernel(n, exclude_center=e) for n in (1, 3, 4, 17, 67) for e in (False, True)],
    "gaussian_kernel1d": lambda geo, grid, kernels, io: [
        kernels.gaussian_kernel1d(s) for s in (0.75, 2.25, 16.75)],
    "gaussian_radius": lambda geo, grid, kernels, io: [
        kernels.gaussian_radius(s, t) for s in (0.75, 16.75, 166.75) for t in (3.0, 4.0)],
    "sobel_kernel": lambda geo, grid, kernels, io: kernels.sobel_kernel(),
    "sx_offsets": lambda geo, grid, kernels, io: [
        kernels.sx_offsets(az, r, 30.0, dy, radius_min=rmin)
        for az, r, dy, rmin in ((0, 500, 30, 0), (225, 250, -30, 0), (130, 2000, -30, 100))],
    "sx_dedupe": lambda geo, grid, kernels, io: kernels.sx_dedupe(
        *kernels.sx_offsets(45, 500, 30.0, -30.0)[:2]),
    "sx_sweep_offsets": lambda geo, grid, kernels, io: kernels.sx_sweep_offsets(
        (0, 90, 225, 355), 300, 30.0, -30.0, radius_min=100),
    "sx_sweep_dedupe": lambda geo, grid, kernels, io: kernels.sx_sweep_dedupe(
        *kernels.sx_sweep_offsets((0, 90, 225, 355), 300, 30.0, -30.0)[:2]),
    "valley_kernels": lambda geo, grid, kernels, io: kernels.valley_kernels(9, [0, 0.2, 0.4]),
    "ridge_kernels": lambda geo, grid, kernels, io: kernels.ridge_kernels(15, [0, 0.15, 0.3]),
    "rotate_kernels": lambda geo, grid, kernels, io: [
        kernels.rotate_kernels(kernels.valley_kernels(9, [0, 0.2]), a) for a in (0.0, 37.0, 90.0)],
    "rotated_extent": lambda geo, grid, kernels, io: [
        kernels.valley.rotated_extent(n) for n in (9, 67, 667)],
    "synthetic_dem": lambda geo, grid, kernels, io: io.synthetic_dem(40, 56, seed=3),
    "basodino_like_dem": lambda geo, grid, kernels, io: [
        (r.data, r.grid.y, r.grid.x, r.grid.crs, r.name, r.units)
        for r in (io.basodino_like_dem(30, 48, projected=p) for p in (True, False))],
    "fill_na": lambda geo, grid, kernels, io: (
        lambda ind, r: (ind, r.data))(*grid.fill_na(_rasters(_dem_with_holes())[grid is tgrid])),
}


def _flat(value):
    """Nested tuples/lists/dicts of arrays and scalars as one list of leaves."""
    if isinstance(value, dict):
        return [leaf for k in sorted(value) for leaf in [k] + _flat(value[k])]
    if isinstance(value, (list, tuple)):
        return [leaf for v in value for leaf in _flat(v)]
    return [value]


@pytest.mark.parametrize("case", list(CASES))
def test_host_function_matches_jax_original(case):
    ref = _flat(CASES[case](jgeo, jgrid, jkernels, jio))
    port = _flat(CASES[case](tgeo, tgrid, tkernels, tio))
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        if isinstance(b, (np.ndarray, np.generic)) or isinstance(a, np.ndarray):
            assert np.asarray(a).dtype == np.asarray(b).dtype, case
            np.testing.assert_array_equal(a, b, err_msg=case)
        else:
            assert a == b, case


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["geotiff", "geotiff_deflate", "netcdf"])
def test_files_cross_read(tmp_path, fmt, writer):
    """A raster written by one package is read by the other, bit for bit,
    with its grid, name and units."""
    jr, tr = _rasters(_dem_with_holes())
    src, dst = (jio, tio) if writer == "jax" else (tio, jio)
    raster = jr if writer == "jax" else tr
    if fmt == "netcdf":
        pytest.importorskip("h5py")
        path = tmp_path / "dem.nc"
        src.write_raster(raster, path)
        back = dst.read_raster(path)
        assert back.units == "m"
        win = dst.NetCDFWindowReader(path)
    else:
        path = tmp_path / "dem.tif"
        src.write_geotiff(raster, path, compress=fmt.endswith("deflate"), rows_per_strip=8)
        back = dst.read_geotiff(path)
        win = dst.GeoTiffWindowReader(path)
    assert isinstance(back, (tgrid if dst is tio else jgrid).Raster)
    np.testing.assert_array_equal(back.data, raster.data)
    np.testing.assert_array_equal(back.grid.y, raster.grid.y)
    np.testing.assert_array_equal(back.grid.x, raster.grid.x)
    assert back.name == "DEM" and back.grid.crs.lower() == raster.grid.crs.lower()
    with win:
        np.testing.assert_array_equal(win.read_rows(5, 17), raster.data[5:17])


def test_config_from_file_matches_jax(tmp_path):
    conf = tmp_path / "topo.conf"
    conf.write_text(
        "# overrides\n"
        "min_elevation: -50\n"
        "scale_std: 3\n"
        "sat_conv_min_taps: 64  # comment\n"
        "std_int32_parity: false\n"
        "compute_dtype: float32\n"
        "valley_bank_max_bytes: 1e6\n"
        "mesh_shape: 2x4\n"  # a TPU-only field of the JAX package: ignored by the port
        "compilation_cache_dir: /nowhere\n"
        "no_such_key: 1\n"
    )
    port, ref = tconfig.Config.from_file(conf), jconfig.Config.from_file(conf)
    fields = [f.name for f in tconfig.dataclasses.fields(port)]
    assert set(fields) == {
        "min_elevation", "scale_std", "compute_dtype", "fft_conv_min_taps", "shift_acc_max_taps",
        "fft_correlate1d_min_taps", "sat_conv_min_taps", "valley_bank_max_bytes",
        "valley_chunk_bytes", "valley_canvas_cache_bytes", "std_int32_parity"}
    for name in fields:
        assert getattr(port, name) == getattr(ref, name), name
        assert type(getattr(port, name)) is type(getattr(ref, name)), name
    assert (port.min_elevation, port.scale_std, port.sat_conv_min_taps) == (-50.0, 3.0, 64)
    assert port.std_int32_parity is False and port.valley_bank_max_bytes == 1_000_000
    # the defaults are the JAX package's
    for name in fields:
        assert getattr(tconfig.Config(), name) == getattr(jconfig.Config(), name), name
