"""The port's prefix-sum disk convolution against the JAX package and scipy.

Three references for every case: the JAX XLA twin ``_conv2d_sat``, the JAX
Pallas kernel ``disk_conv_sat_pallas`` under the Pallas interpreter, and
``scipy.signal.convolve`` in float64. On the CPU the port runs the plain
twin of its CUDA kernel; the kernel itself is held against that twin on a
CUDA device by the ``cuda``-marked test.

Tolerances: both sides take float32 row prefix sums in another order. The
DEM cases have |x| < 1900 on 48-column rows, so prefix sums stay below ~1e5
(ulp ~8e-3); a <= 11-px disk adds <= 2 x 11 of them, each about one ulp
apart, so 0.25 absolute bounds the difference (measured: <= 0.05).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from scipy import signal

import topo_descriptors_tpu.ops.pallas.disk_sat as dsat
from topo_descriptors_tpu import kernels
from topo_descriptors_tpu.ops import conv as jconv
from topo_descriptors_tpu_torch.ops import conv as tconv
from topo_descriptors_tpu_torch.ops.cuda import disk_sat

RTOL, ATOL = 1e-5, 0.25


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)  # TPU-only knob
        return orig(*args, **kwargs)

    monkeypatch.setattr(dsat.pl, "pallas_call", interp)


def _even_kernel():
    kernel = np.ones((4, 6), np.float32)
    kernel[1, 2] = 0.0
    return kernel


# the five cases of tests/test_pallas.py: (fields, kernel, mode, pallas block)
CASES = {
    "same_disk": (lambda dem: dem[None], kernels.circular_kernel(9), "same", (16, 128)),
    # TPI's centre-zeroed disk: the centre row decomposes into two runs
    "center_zero_tpi_disk": (
        lambda dem: dem[None], kernels.circular_kernel(7, exclude_center=True),
        "same", (16, 128),
    ),
    # even kernel dims hit the asymmetric 'same' anchoring (k-1-s, s)
    "even_kernel_anchor": (lambda dem: dem[None], _even_kernel(), "same", (16, 128)),
    # STD's three moment fields in one call
    "valid_multifield": (
        lambda dem: np.random.default_rng(1).standard_normal((3, 40, 48)).astype(np.float32) * 100.0,
        kernels.circular_kernel(11), "valid", (16, 128),
    ),
    # output larger than one Pallas block in both dims, not divisible
    "multiblock_ragged": (
        lambda dem: np.random.default_rng(2).standard_normal((1, 37, 150)).astype(np.float32) * 100.0,
        kernels.circular_kernel(5), "same", (16, 128),
    ),
}


def _inputs(case, dem_tiny):
    make, kernel, mode, block = CASES[case]
    xs = np.ascontiguousarray(make(dem_tiny), np.float32)
    kernel = np.asarray(kernel, np.float32)
    runs = jconv._binary_kernel_runs(kernel[::-1, ::-1])
    kh, kw = kernel.shape
    if mode == "same":
        pads = (jconv._same_pads(kh), jconv._same_pads(kw))
    else:
        pads = ((0, 0), (0, 0))
    return xs, kernel, mode, block, runs, pads


def _port(xs, kernel, mode, runs, pads, device):
    x = torch.from_numpy(xs).to(device)
    if mode == "same":
        return tconv.conv2d_same_multi(x, kernel, method="sat")
    return disk_sat.disk_conv_sat(x, kernel.shape, runs, pads)


def _scipy(xs, kernel, mode):
    return np.stack([
        signal.convolve(x.astype(np.float64), kernel.astype(np.float64), mode=mode)
        for x in xs
    ])


@pytest.mark.parametrize("case", list(CASES))
def test_disk_sat_matches_jax_and_scipy(case, dem_tiny, interpret_pallas):
    xs, kernel, mode, block, runs, pads = _inputs(case, dem_tiny)
    port = _port(xs, kernel, mode, runs, pads, "cpu").numpy()
    if mode == "same" and xs.shape[0] == 1:
        single = tconv.conv2d_same(torch.from_numpy(xs[0]), kernel, method="sat")
        np.testing.assert_array_equal(single.numpy(), port[0])

    xla = np.asarray(jconv._conv2d_sat(jnp.asarray(xs), kernel.shape, runs, pads))
    pallas = np.asarray(
        dsat.disk_conv_sat_pallas(jnp.asarray(xs), kernel.shape, runs, pads, block=block)
    )
    ref = _scipy(xs, kernel, mode)
    assert port.shape == xla.shape == pallas.shape == ref.shape
    np.testing.assert_allclose(port, xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)


def test_disk_sat_plain_route_counts_no_launch(dem_tiny):
    xs, kernel, mode, _, runs, pads = _inputs("same_disk", dem_tiny)
    before = disk_sat.LAUNCHES
    out = disk_sat.disk_conv_sat(torch.from_numpy(xs), kernel.shape, runs, pads)
    assert disk_sat.LAUNCHES == before
    np.testing.assert_array_equal(
        out.numpy(),
        disk_sat.disk_conv_sat_plain(torch.from_numpy(xs), kernel.shape, runs, pads).numpy(),
    )


def test_disk_sat_rejects_other_devices(dem_tiny):
    xs, kernel, _, _, runs, pads = _inputs("same_disk", dem_tiny)
    with pytest.raises(ValueError, match="unsupported device"):
        disk_sat.disk_conv_sat(torch.from_numpy(xs).to("meta"), kernel.shape, runs, pads)


def test_run_table_layout():
    runs = jconv._binary_kernel_runs(kernels.circular_kernel(7, exclude_center=True))
    groups = disk_sat.group_runs(runs)
    table, n_groups = disk_sat.run_table(runs)
    assert n_groups == len(groups)
    head = table[: 4 * len(groups)].reshape(-1, 4)
    rows = table[4 * len(groups):]
    assert len(rows) == len(runs)
    for (a, b, grows), (ta, tb, r0, r1) in zip(groups, head):
        assert (a, b) == (ta, tb)
        assert tuple(rows[r0:r1]) == grows


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_disk_sat_kernel_matches_twin_on_cuda(case, dem_tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    xs, kernel, mode, _, runs, pads = _inputs(case, dem_tiny)
    x = torch.from_numpy(xs).cuda()
    before = disk_sat.LAUNCHES
    out = disk_sat.disk_conv_sat(x, kernel.shape, runs, pads)
    torch.cuda.synchronize()
    assert disk_sat.LAUNCHES == before + 1
    plain = disk_sat.disk_conv_sat_plain(x, kernel.shape, runs, pads)
    np.testing.assert_allclose(out.cpu().numpy(), plain.cpu().numpy(), rtol=RTOL, atol=ATOL)
