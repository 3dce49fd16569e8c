"""The port's Sx azimuth sweep against the JAX package.

References for every fan: JAX ``ops.sx_sweep(method="xla")`` and the JAX
Pallas kernels ``sx_sweep_pallas`` and ``sx_fan_pallas`` under the Pallas
interpreter, on the fans of tests/test_pallas.py (ragged per-azimuth ray
counts, ``radius_min`` NaN rays mid-table, the even-window distance-0
quirk, and a fan split into several ``FAN_RAY_BUDGET`` groups). On the CPU
the port runs the plain twin of its CUDA kernels; the kernels themselves
are held against that twin on a CUDA device by the ``cuda``-marked tests.

Tolerance against JAX: both sides compute the same float32 ratios and
differ only in ``atan`` (about one ulp of a value <= 90 degrees, 7.6e-6),
so 2e-5 degrees, rtol 0, with identical NaN positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import topo_descriptors_tpu.ops.pallas.sx_block as sxb
from topo_descriptors_tpu import kernels
from topo_descriptors_tpu import ops as jops
from topo_descriptors_tpu_torch import ops as tops
from topo_descriptors_tpu_torch.ops.cuda import sx_block, sx_sweep

JAX_ATOL = 2e-5


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)  # TPU-only knob
        return orig(*args, **kwargs)

    monkeypatch.setattr(sxb.pl, "pallas_call", interp)


# (sx_sweep_offsets kwargs, Pallas block, FAN_RAY_BUDGET for sx_fan_pallas)
FANS = {
    "ragged4_r300": (dict(azimuths=[0.0, 45.0, 120.0, 290.0], radius=300.0), (16, 32), None),
    "radius_min100": (dict(azimuths=[10.0, 200.0, 355.0], radius=300.0, radius_min=100.0),
                      (16, 32), None),
    "distance0_quirk": (dict(azimuths=[225.0, 45.0], radius=250.0), (32, 32), None),
    "fan_budget_split": (dict(azimuths=[0.0, 45.0, 120.0, 290.0], radius=300.0), (16, 32), 40),
}


def _fan(name):
    kw, _, _ = FANS[name]
    return kernels.sx_sweep_offsets(dx=30.0, dy=30.0, **kw)


def _assert_close(out, ref, **tol):
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, **tol)


@pytest.mark.parametrize("name", list(FANS))
def test_sx_sweep_matches_jax(name, dem_tiny, interpret_pallas, monkeypatch):
    _, block, budget = FANS[name]
    o, d, b = _fan(name)
    if name == "distance0_quirk":
        assert (d == 0).any()
    if name == "radius_min100":
        real = ~(np.isnan(d) & ~o.any(axis=2))
        assert np.isnan(d[real]).any()  # NaN rays mid-table, not only padding
    if budget is not None:
        monkeypatch.setattr(sxb, "FAN_RAY_BUDGET", budget)
    dem = jnp.asarray(dem_tiny)
    port = tops.sx_sweep(dem_tiny, o, d, b, 10.0, device="cpu").numpy()
    xla = np.asarray(jops.sx_sweep(dem, o, d, b, 10.0, method="xla"))
    do, dd = kernels.sx_sweep_dedupe(o, d)
    sweep = np.asarray(sxb.sx_sweep_pallas(dem, do, dd, b, block=block))
    fan = np.asarray(sxb.sx_fan_pallas(dem, do, dd, b, block=block))
    assert port.shape == (len(o),) + dem_tiny.shape
    for ref in (xla, sweep, fan):
        _assert_close(port, ref, rtol=0, atol=JAX_ATOL)
    if name == "distance0_quirk":
        assert (np.abs(port) == 90).any()  # the +-90 candidates win somewhere


@pytest.mark.parametrize("method", ["auto", "pallas_fan", "pallas_sweep", "pallas", "xla"])
def test_sweep_methods_agree(method, dem_tiny):
    o, d, b = _fan("radius_min100")
    ref = tops.sx_sweep(dem_tiny, o, d, b, method="xla", device="cpu").numpy()
    out = tops.sx_sweep(dem_tiny, o, d, b, method=method, device="cpu").numpy()
    np.testing.assert_array_equal(out, ref)  # same arithmetic on every route


def test_sweep_planes_equal_sx(dem_tiny):
    o, d, b = _fan("ragged4_r300")
    planes = tops.sx_sweep(dem_tiny, o, d, b, device="cpu").numpy()
    for a, az in enumerate(FANS["ragged4_r300"][0]["azimuths"]):
        oa, da, ba = kernels.sx_offsets(az, 300.0, 30.0, 30.0)
        assert ba == b
        plane = tops.sx(dem_tiny, oa, da, b, device="cpu").numpy()
        np.testing.assert_array_equal(planes[a], plane)


def test_sweep_without_zero_border(dem_tiny):
    o, d, b = _fan("ragged4_r300")
    port = tops.sx_sweep(dem_tiny, o, d, b, zero_border=False, device="cpu").numpy()
    xla = np.asarray(jops.sx_sweep(jnp.asarray(dem_tiny), o, d, b, method="xla",
                                   zero_border=False))
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    assert np.isnan(port).any()  # corner pixels whose rays all leave the grid


def test_sweep_azimuth_without_rays(dem_tiny):
    # every ray of azimuth 1 excluded (NaN distance): no candidate -> NaN
    o, d, b = _fan("ragged4_r300")
    d = d.copy()
    d[1] = np.nan
    port = tops.sx_sweep(dem_tiny, o, d, b, device="cpu").numpy()
    xla = np.asarray(jops.sx_sweep(jnp.asarray(dem_tiny), o, d, b, method="xla"))
    _assert_close(port, xla, rtol=0, atol=JAX_ATOL)
    assert np.isnan(port[1, b:-b, b:-b]).all() and (port[1, :b] == 0).all()
    offs, group_ptr, inv, az_ptr = sx_sweep.sweep_tables(*kernels.sx_sweep_dedupe(o, d))
    assert az_ptr[1] == az_ptr[2]  # azimuth 1 owns no group


@pytest.mark.parametrize("name", ["radius_min100", "distance0_quirk"])
def test_sweep_tables_cover_real_rays(name):
    o, d = kernels.sx_sweep_dedupe(*_fan(name)[:2])
    offs, group_ptr, inv, az_ptr = sx_sweep.sweep_tables(o, d)
    assert len(az_ptr) == len(o) + 1 and az_ptr[0] == 0 and az_ptr[-1] == len(inv)
    assert group_ptr[0] == 0 and group_ptr[-1] == len(offs) == (~np.isnan(d)).sum()
    for a in range(len(o)):
        ref_offs, ref_ptr, ref_inv = sx_block.ray_groups(o[a], d[a])
        g0, g1 = az_ptr[a], az_ptr[a + 1]
        np.testing.assert_array_equal(inv[g0:g1], ref_inv)
        np.testing.assert_array_equal(group_ptr[g0 : g1 + 1] - group_ptr[g0], ref_ptr)
        np.testing.assert_array_equal(offs[group_ptr[g0] : group_ptr[g1]], ref_offs)
    if name == "distance0_quirk":
        assert np.isinf(inv).any()  # the distance-0 ray keeps 1/0 = +inf


def test_sweep_auto_on_cpu_launches_no_kernel(dem_tiny):
    o, d, b = _fan("ragged4_r300")
    before = dict(sx_sweep.LAUNCHES), sx_block.LAUNCHES
    tops.sx_sweep(dem_tiny, o, d, b, device="cpu")
    assert (dict(sx_sweep.LAUNCHES), sx_block.LAUNCHES) == before


def test_sweep_unknown_method_raises(dem_tiny):
    o, d, b = _fan("ragged4_r300")
    with pytest.raises(ValueError, match="method"):
        tops.sx_sweep(dem_tiny, o, d, b, method="scan", device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FANS))
@pytest.mark.parametrize("kernel", ["sx_sweep", "sx_fan"])
def test_sweep_kernel_matches_twin_on_cuda(kernel, name, dem_tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    o, d = kernels.sx_sweep_dedupe(*_fan(name)[:2])
    b = _fan(name)[2]
    dem = torch.from_numpy(dem_tiny).cuda()
    before = sx_sweep.LAUNCHES[kernel]
    out = getattr(sx_sweep, kernel)(dem, o, d, b, 10.0)
    torch.cuda.synchronize()
    assert sx_sweep.LAUNCHES[kernel] == before + 1
    plain = sx_sweep.sx_sweep_plain(dem, o, d, b, 10.0)
    _assert_close(out.cpu().numpy(), plain.cpu().numpy(), rtol=0, atol=JAX_ATOL)
    # the same per-pixel code and groups as sx_block: bit-equal planes
    for a in range(len(o)):
        one = tops.sx(dem, o[a], d[a], b, 10.0, device=dem.device)
        assert torch.equal(out[a].view(torch.int32), one.view(torch.int32))
