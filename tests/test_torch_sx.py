"""The port's Sx horizon scan against the JAX package and the scipy oracle.

References for every geometry: JAX ``ops.sx(method="xla")``, the JAX Pallas
kernel ``sx_pallas`` under the Pallas interpreter, and the reference's
per-pixel loop ``oracles._sx_oracle``. On the CPU the port runs the plain
twin of its CUDA kernel; the kernel itself is held against that twin on a
CUDA device by the ``cuda``-marked test.

Tolerances: against JAX both sides compute the same float32 ratios and
differ only in ``atan`` (about one ulp of a value <= 90 degrees, 7.6e-6), so
2e-5 degrees; against the float64 oracle the test_ops.py tolerance
(rtol 1e-4, atol 1e-3). NaN positions must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import topo_descriptors_tpu.ops.pallas.sx_block as sxb
from oracles import _sx_oracle
from topo_descriptors_tpu import kernels
from topo_descriptors_tpu import ops as jops
from topo_descriptors_tpu_torch import ops as tops
from topo_descriptors_tpu_torch.ops.cuda import sx_block

JAX_ATOL = 2e-5


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)  # TPU-only knob
        return orig(*args, **kwargs)

    monkeypatch.setattr(sxb.pl, "pallas_call", interp)


# (sx_offsets kwargs, Pallas block): the geometries of tests/test_ops.py
# (radius_min 0 and 100, narrow arc, the even-window distance-0 quirk) and
# the ragged-block case of tests/test_pallas.py
GEOMETRIES = {
    "r300": (dict(azimuth=0.0, radius=300.0), (16, 32)),
    "r300_radius_min100": (dict(azimuth=0.0, radius=300.0, radius_min=100.0), (16, 32)),
    "narrow_arc": (dict(azimuth=45.0, radius=250.0, azimuth_arc=0.0), (16, 32)),
    "distance0_quirk": (dict(azimuth=225.0, radius=250.0), (32, 32)),
    "az90_ragged": (dict(azimuth=90.0, radius=250.0), (32, 32)),
}


def _geometry(name):
    kw, block = GEOMETRIES[name]
    o, d, b = kernels.sx_offsets(dx=30.0, dy=30.0, **kw)
    return o, d, b, block


def _assert_close(out, ref, **tol):
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, **tol)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_sx_matches_jax_and_oracle(name, dem_tiny, interpret_pallas):
    o, d, b, block = _geometry(name)
    if name == "distance0_quirk":
        assert (d == 0).any()
    if name == "r300_radius_min100":
        assert np.isnan(d).any()
    port = tops.sx(dem_tiny, o, d, b, 10.0, device="cpu").numpy()
    xla = np.asarray(jops.sx(jnp.asarray(dem_tiny), o, d, b, 10.0, method="xla"))
    pallas = np.asarray(sxb.sx_pallas(jnp.asarray(dem_tiny), o, d, b, block=block))
    ref = _sx_oracle(dem_tiny, o, d, b, height=10.0)
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    _assert_close(port, pallas, rtol=0, atol=JAX_ATOL)
    _assert_close(port, ref, rtol=1e-4, atol=1e-3)
    if name == "distance0_quirk":
        assert (np.abs(port) == 90).any()  # the +-90 candidates win somewhere


@pytest.mark.parametrize("method", ["xla", "pallas", "auto"])
def test_sx_methods_match_jax(method, dem_tiny):
    # JAX call sites name a backend: the port takes the same names
    o, d, b, _ = _geometry("r300_radius_min100")
    port = tops.sx(dem_tiny, o, d, b, 10.0, method=method, device="cpu").numpy()
    xla = np.asarray(jops.sx(jnp.asarray(dem_tiny), o, d, b, 10.0, method="xla"))
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    with pytest.raises(ValueError, match="method"):
        tops.sx(dem_tiny, o, d, b, method="scan", device="cpu")


def test_sx_without_zero_border(dem_tiny):
    o, d, b, _ = _geometry("r300")
    port = tops.sx(dem_tiny, o, d, b, 10.0, zero_border=False, device="cpu").numpy()
    xla = np.asarray(
        jops.sx(jnp.asarray(dem_tiny), o, d, b, 10.0, method="xla", zero_border=False)
    )
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    assert np.isnan(port).any()  # corner pixels whose rays all leave the grid


def test_ray_groups_cover_the_table():
    o, d, _ = kernels.sx_offsets(0.0, 2000.0, 30.0, 30.0, radius_min=100.0)
    o, d = kernels.sx_dedupe(o, d)
    offs, ptr, inv = sx_block.ray_groups(o, d)
    keep = ~np.isnan(d)
    assert len(offs) == keep.sum() and ptr[-1] == len(offs)
    assert np.all(np.diff(inv) > 0)  # sorted, one group per distinct 1/d
    with np.errstate(divide="ignore"):
        inv_of = {tuple(x): np.float32(1.0 / v) for x, v in zip(o[keep], d[keep])}
    for g in range(len(inv)):
        for x in offs[ptr[g] : ptr[g + 1]]:
            assert inv_of[tuple(x)] == inv[g]


def test_sx_plain_route_counts_no_launch(dem_tiny):
    o, d, b, _ = _geometry("r300")
    before = sx_block.LAUNCHES
    tops.sx(dem_tiny, o, d, b, device="cpu")
    assert sx_block.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_sx_kernel_matches_twin_on_cuda(name, dem_tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    o, d, b, _ = _geometry(name)
    o, d = kernels.sx_dedupe(o, d)
    dem = torch.from_numpy(dem_tiny).cuda()
    before = sx_block.LAUNCHES
    out = sx_block.sx_block(dem, o, d, b, 10.0)
    torch.cuda.synchronize()
    assert sx_block.LAUNCHES == before + 1
    plain = sx_block.sx_block_plain(dem, o, d, b, 10.0)
    _assert_close(out.cpu().numpy(), plain.cpu().numpy(), rtol=0, atol=JAX_ATOL)
