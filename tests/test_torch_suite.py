"""The port's TerrainSuite against the JAX suite, on the CPU.

Every key is compared at the tolerance of its op's own tests: TPI and STD
as tests/test_torch_ops.py, the gradient family as
tests/test_torch_gradient.py, the valley index as
tests/test_torch_valley_ridge.py, and Sx as tests/test_torch_sx.py. Sx is
compared at azimuth 90, where the two suites' ray geometries agree: the JAX
suite builds its rays from |res_y_m|, which mirrors other azimuths on a
north-up grid (ROADMAP C2); the port uses the signed resolutions, as the
``compute_sx`` drivers do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_descriptors_tpu.kernels.sx_geometry import sx_offsets
from topo_descriptors_tpu.models import SuiteConfig as JaxSuiteConfig
from topo_descriptors_tpu.models import TerrainSuite as JaxSuite
from topo_descriptors_tpu_torch import pipeline as tpipe
from topo_descriptors_tpu_torch.host import basodino_like_dem
from topo_descriptors_tpu_torch.models import SuiteConfig, TerrainSuite

TOL = {"tpi": dict(rtol=1e-5, atol=1e-3), "std": dict(rtol=1e-5, atol=2e-2),
       "dx": dict(rtol=1e-3, atol=1e-5), "dy": dict(rtol=1e-3, atol=1e-5),
       "slope": dict(rtol=1e-3, atol=1e-3), "valley": dict(rtol=1e-3, atol=2e-3),
       "sx": dict(rtol=0, atol=2e-5)}


def test_suite_matches_jax_suite(dem_small):
    port = TerrainSuite(dem_small.shape, SuiteConfig(sx_azimuth=90.0), device="cpu")
    ref = JaxSuite(dem_small.shape, JaxSuiteConfig(sx_azimuth=90.0)).forward(jnp.asarray(dem_small))
    out = port(dem_small)
    assert sorted(out) == sorted(ref)
    for key, value in out.items():
        assert value.device.type == "cpu" and value.dtype == torch.float32, key
        a, b = value.numpy(), np.asarray(ref[key])
        assert a.shape == b.shape == dem_small.shape, key
        kind = key.split("_")[0]
        if key == "valley_dir":
            assert (a != b).mean() < 0.02
        elif kind == "aspect":
            diff = (a - b + 180.0) % 360.0 - 180.0
            assert np.all(np.abs(diff) <= 2e-2 + 1e-3 * np.abs(b)), key
        else:
            np.testing.assert_allclose(a, b, err_msg=key, **TOL[kind])


def test_suite_sx_equals_the_driver_on_a_north_up_grid():
    raster = basodino_like_dem(ny=60, nx=80, projected=True)
    res = raster.grid.resolution_meters()
    assert float(res["y"].mean()) == -30.0 and float(res["x"].mean()) == 30.0
    cfg = SuiteConfig(tpi_scales_pxl=(), std_scales_pxl=(), gradient_sigmas=(),
                      valley_size_pxl=None, sx_azimuth=0.0)
    out = TerrainSuite(raster.data.shape, cfg, device="cpu")(raster.data)
    assert sorted(out) == ["sx"]
    driver = tpipe.sx(raster, azimuth=0.0, radius=cfg.sx_radius_m, device="cpu")
    np.testing.assert_array_equal(out["sx"].numpy(), driver)
    # the JAX suite's |res_y| geometry is another ray set at this azimuth
    assert not np.array_equal(sx_offsets(0.0, 500.0, 30.0, 30.0)[0],
                              sx_offsets(0.0, 500.0, 30.0, -30.0)[0])


def test_suite_is_a_module_that_follows_its_buffers(dem_small):
    suite = TerrainSuite(dem_small.shape, SuiteConfig(valley_size_pxl=None, sx_azimuth=None),
                         device="cpu")
    assert isinstance(suite, torch.nn.Module) and suite.state_dict() == {}
    moved = suite.to("cpu")
    assert moved is suite and suite.res_x.shape == (dem_small.shape[1],)
    out = suite(torch.from_numpy(dem_small))
    assert sorted(out) == sorted(["tpi_9px", "tpi_33px", "std_9px", "dx_s2.25", "dy_s2.25",
                                  "slope_s2.25", "aspect_s2.25"])


def test_suite_defaults_to_cuda(dem_small):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is missing")
    with pytest.raises(RuntimeError, match="cuda"):
        TerrainSuite(dem_small.shape)
