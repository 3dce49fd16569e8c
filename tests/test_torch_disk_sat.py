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
from topo_descriptors_tpu_torch.ops.cuda import _build, disk_sat

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


def _disk_table_len(size):
    runs = jconv._binary_kernel_runs(kernels.circular_kernel(size, exclude_center=True)[::-1, ::-1])
    return len(disk_sat.run_table(runs)[0])


@pytest.mark.parametrize("size,expected", [(17, "fused"), (67, "fused"), (667, "wide"),
                                           (3333, "wide")])
def test_route_is_chosen_by_the_kernel_alone(size, expected):
    """The fused tile of the 17- and 67-px disks fits in the 227 KB of
    shared memory, that of the 20 km (667 px) and 100 km (3333 px) disks
    does not; nothing but the kernel's shape and run table decides."""
    table_len = _disk_table_len(size)
    assert disk_sat.route((size, size), table_len) == expected
    smem = disk_sat.fused_smem_bytes((size, size), table_len)
    staged = (disk_sat.TILE_H + size - 1) * (disk_sat.TILE_W + size) * 4
    assert staged < smem <= staged + 4 * table_len + 12
    assert (smem <= _build.SMEM_PER_BLOCK) == (expected == "fused")


def test_run_table_is_uploaded_once_per_table():
    """A repeated call with the same runs and pads finds its table on the
    device; the cache holds a few tables, the oldest goes first."""
    disk_sat.TABLES.clear()
    before = disk_sat.TABLES.builds
    runs = jconv._binary_kernel_runs(kernels.circular_kernel(9)[::-1, ::-1])
    pads = ((4, 4), (4, 4))
    first = disk_sat.device_table(runs, pads, "cpu")
    again = disk_sat.device_table(list(runs), pads, torch.device("cpu"))
    assert again is first and disk_sat.TABLES.builds == before + 1
    table, n_groups = disk_sat.run_table(runs)
    np.testing.assert_array_equal(first[0].numpy(), table)
    assert first[1:] == (n_groups, len(table))
    for size in range(11, 11 + 2 * disk_sat.TABLES.size, 2):
        disk_sat.device_table(jconv._binary_kernel_runs(kernels.circular_kernel(size)), pads, "cpu")
    assert len(disk_sat.TABLES) == disk_sat.TABLES.size
    assert disk_sat.device_table(runs, pads, "cpu") is not first  # evicted, built again


def _integer_fields(shape, seed):
    """Integer-valued fields whose row sums stay below 2^23: every prefix
    is exact in float32 and the group sums run in the twin's order, so the
    kernel must give the twin's bits."""
    rng = np.random.default_rng(seed)
    return np.round(rng.uniform(-2000, 2000, shape)).astype(np.float32)


# (fields shape, disk size px, exclude centre, mode): a grid that is not a
# multiple of the fused tile, the 67-px TPI disk on a 3-field stack, a
# misaligned row width (no 16-byte loads), and the wide route's 667-px disk
@pytest.mark.cuda
@pytest.mark.parametrize("shape,size,centre,mode,route", [
    ((1, 1000, 1337), 67, True, "same", "fused"),
    ((3, 130, 250), 17, False, "valid", "fused"),
    ((2, 75, 301), 67, True, "same", "fused"),
    ((1, 900, 1440), 667, False, "same", "wide"),
], ids=["ragged_1000x1337_67px", "stack3_valid_17px", "misaligned_rows_67px",
        "wide_667px_900x1440"])
def test_disk_sat_routes_bit_equal_on_cuda(shape, size, centre, mode, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kernel = kernels.circular_kernel(size, exclude_center=centre)
    runs = jconv._binary_kernel_runs(kernel[::-1, ::-1])
    pads = ((jconv._same_pads(size), jconv._same_pads(size)) if mode == "same"
            else ((0, 0), (0, 0)))
    assert disk_sat.route(kernel.shape, len(disk_sat.run_table(runs)[0])) == route
    x = torch.from_numpy(_integer_fields(shape, size)).cuda()
    before = dict(disk_sat.ROUTE_LAUNCHES)
    out = disk_sat.disk_conv_sat(x, kernel.shape, runs, pads)
    torch.cuda.synchronize()
    assert disk_sat.ROUTE_LAUNCHES[route] == before[route] + 1
    plain = disk_sat.disk_conv_sat_plain(x, kernel.shape, runs, pads)
    assert out.shape == plain.shape
    assert torch.equal(out, plain)
