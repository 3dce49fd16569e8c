"""The port's TiledRunner against the JAX TiledRunner and against the
port's single-pass ops, on the CPU.

Both runners band the same fixtures (tile_rows 16: several bands, windows
clipped at both global edges) and the port also runs each op once on the
whole grid. Tolerances are those of tests/test_tiles.py (banded against
single-pass in the JAX package); the valley/ridge direction may differ on
under 2% of the pixels, where angles are near-tied. The Sx sweep is
compared bit for bit with the port's single pass (a band reads the same
neighbours with the same code) and within the Sx tolerance of
tests/test_torch_sx.py with the JAX runner. The band loop's error paths
run under a watchdog: a hang fails the test instead of stalling the suite.
"""

import re
import threading

import jax
import numpy as np
import pytest
import torch

from topo_descriptors_tpu import kernels
from topo_descriptors_tpu import ops as jops
from topo_descriptors_tpu.config import CFG
from topo_descriptors_tpu.parallel.tiles import TiledRunner as JaxTiledRunner
from topo_descriptors_tpu_torch import ops
from topo_descriptors_tpu_torch.config import CFG as TCFG
from topo_descriptors_tpu_torch.parallel import LockedReader, TiledRunner

SX_TOL = dict(rtol=0, atol=2e-5)


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
def runner():
    return TiledRunner(tile_rows=16, device="cpu")


@pytest.fixture(scope="module")
def jrunner():
    return JaxTiledRunner(tile_rows=16)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _agree(port, jax_tiled, single, **tol):
    np.testing.assert_allclose(port, _host(jax_tiled), **tol)
    np.testing.assert_allclose(port, _host(single), **tol)


def test_tiled_gaussian(dem_small, runner, jrunner):
    single = ops.gaussian_filter(torch.from_numpy(dem_small), 3.0)
    _agree(runner.gaussian(dem_small, 3.0), jrunner.gaussian(dem_small, 3.0), single,
           rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("size,sigma", [(9, None), (9, 1.5)])
def test_tiled_tpi(dem_small, runner, jrunner, size, sigma):
    _agree(runner.tpi(dem_small, size, sigma), jrunner.tpi(dem_small, size, sigma),
           ops.tpi(dem_small, size, sigma, device="cpu"), rtol=1e-5, atol=2e-2)


def test_tiled_std(dem_small, runner, jrunner):
    _agree(runner.std(dem_small, 9), jrunner.std(dem_small, 9),
           ops.std(dem_small, 9, device="cpu"), rtol=1e-3, atol=5e-1)


@pytest.mark.parametrize("sigma", [None, 1.5])
def test_tiled_disk_descriptors(dem_small, runner, jrunner, sigma):
    port = runner.disk_descriptors(dem_small, [7, 11], sigma)
    ref = jrunner.disk_descriptors(dem_small, [7, 11], sigma)
    single = ops.disk_descriptors(dem_small, [7, 11], sigma, device="cpu")
    assert sorted(port) == ["std", "tpi"] and port["tpi"].shape == (2,) + dem_small.shape
    _agree(port["tpi"], ref["tpi"], single["tpi"], rtol=1e-5, atol=2e-2)
    _agree(port["std"], ref["std"], single["std"], rtol=1e-3, atol=5e-1)


def test_tiled_disk_descriptors_one_kind_to_sinks(dem_small, runner):
    got = {}

    def sink_for(j):
        def sink(start, band):
            got.setdefault(j, np.full(dem_small.shape, np.nan, np.float32))[
                start : start + band.shape[0]] = band
        return sink

    assert runner.disk_descriptors(dem_small, [7, 11], compute_std=False,
                                   sinks={"tpi": [sink_for(0), sink_for(1)]}) is None
    stitched = runner.disk_descriptors(dem_small, [7, 11], compute_std=False)
    assert list(stitched) == ["tpi"]
    for j in (0, 1):
        np.testing.assert_array_equal(got[j], stitched["tpi"][j])


@pytest.mark.parametrize("sigma,ratio", [(0.5, 1.0), (2.25, 1.0), (2.0, 1.5)])
def test_tiled_gradient(dem_small, runner, jrunner, sigma, ratio):
    ny, nx = dem_small.shape
    res = {"x": np.full(nx, 30.0, np.float32), "y": np.full(ny, -30.0, np.float32)}
    port = runner.gradient(dem_small, sigma, res, ratio)
    ref = jrunner.gradient(dem_small, sigma, res, ratio)
    single = ops.gradient(dem_small, sigma, res, ratio, device="cpu")
    assert len(port) == 4
    for p, r, s in zip(port, ref, single):
        _agree(p, r, s, rtol=1e-3, atol=2e-2)


def test_tiled_gradient_2d_resolution(dem_small, runner, jrunner):
    # geographic grids: the 2-D resolution planes are banded with the DEM
    ny, nx = dem_small.shape
    rng = np.random.default_rng(3)
    res = {"x": (30.0 + rng.random((ny, nx))).astype(np.float32),
           "y": (-30.0 - rng.random((ny, nx))).astype(np.float32)}
    port = runner.gradient(dem_small, 2.25, res, 1.0)
    ref = jrunner.gradient(dem_small, 2.25, res, 1.0)
    single = ops.gradient(dem_small, 2.25, res, 1.0, device="cpu")
    for p, r, s in zip(port, ref, single):
        _agree(p, r, s, rtol=1e-3, atol=2e-2)


def _valley_agree(port, ref, atol):
    np.testing.assert_allclose(port[0], _host(ref[0]), rtol=1e-3, atol=atol)
    assert (port[1] != _host(ref[1])).mean() < 0.02


@pytest.mark.parametrize("sigma", [None, 1.5])
def test_tiled_valley_ridge(dem_tiny, runner, jrunner, sigma):
    port = runner.valley_ridge(dem_tiny, 7, "valley", (0, 0.2), sigma)
    _valley_agree(port, jrunner.valley_ridge(dem_tiny, 7, "valley", (0, 0.2), sigma), 2e-3)
    _valley_agree(port, ops.valley_ridge(dem_tiny, 7, "valley", [0, 0.2], sigma, device="cpu"),
                  2e-3)


def test_tiled_valley_ridge_streamed_branch(dem_tiny, runner, jrunner, monkeypatch):
    """A 1-byte bank budget sends every band down the streamed route, in
    both packages: each reads its own CFG."""
    single = ops.valley_ridge(dem_tiny, 7, "ridge", [0, 0.2], device="cpu")
    monkeypatch.setattr(CFG, "valley_bank_max_bytes", 1)
    monkeypatch.setattr(TCFG, "valley_bank_max_bytes", 1)
    port = runner.valley_ridge(dem_tiny, 7, "ridge", (0, 0.2))
    _valley_agree(port, jrunner.valley_ridge(dem_tiny, 7, "ridge", (0, 0.2)), 3e-3)
    _valley_agree(port, single, 3e-3)


def test_tiled_valley_ridge_rejects_mode(dem_tiny, runner):
    with pytest.raises(ValueError, match="mode"):
        runner.valley_ridge(dem_tiny, 7, "crest")


def test_tiled_sx(dem_small, runner, jrunner):
    offsets, distances, border = kernels.sx_offsets(45.0, 300.0, 30.0, 30.0)
    port = runner.sx(dem_small, offsets, distances, border)
    single = ops.sx(dem_small, offsets, distances, border, device="cpu").numpy()
    np.testing.assert_array_equal(port, single)
    np.testing.assert_allclose(port, np.asarray(jrunner.sx(dem_small, offsets, distances, border)),
                               **SX_TOL)


def test_tiled_sx_band_smaller_than_halo(dem_small):
    offsets, distances, border = kernels.sx_offsets(0.0, 500.0, 30.0, 30.0)
    assert border > 8
    port = TiledRunner(tile_rows=8, device="cpu").sx(dem_small, offsets, distances, border)
    single = ops.sx(dem_small, offsets, distances, border, device="cpu").numpy()
    np.testing.assert_array_equal(port, single)
    ref = JaxTiledRunner(tile_rows=8).sx(dem_small, offsets, distances, border)
    np.testing.assert_allclose(port, np.asarray(ref), **SX_TOL)


def test_tiled_sx_sweep(dem_small, runner, jrunner):
    offsets, distances, border = kernels.sx_sweep_offsets([0.0, 90.0, 225.0], 300.0, 30.0, 30.0)
    port = runner.sx_sweep(dem_small, offsets, distances, border)
    single = ops.sx_sweep(dem_small, offsets, distances, border, device="cpu").numpy()
    assert port.shape == (3,) + dem_small.shape
    np.testing.assert_array_equal(port.view(np.int32), single.view(np.int32))
    ref = np.asarray(jax.jit(lambda x: jops.sx_sweep(x, offsets, distances, border))(dem_small))
    np.testing.assert_allclose(port, np.asarray(jrunner.sx_sweep(dem_small, offsets, distances,
                                                                 border)), **SX_TOL)
    np.testing.assert_allclose(port, ref, **SX_TOL)


@pytest.mark.parametrize("op", ["tpi", "disk_descriptors", "sx_sweep", "gradient"])
def test_pipelined_and_serial_identical(dem_small, op):
    piped = TiledRunner(tile_rows=24, pipeline=True, device="cpu")
    serial = TiledRunner(tile_rows=24, pipeline=False, device="cpu")
    offsets, distances, border = kernels.sx_sweep_offsets([0.0, 135.0], 300.0, 30.0, 30.0)
    res = {"x": np.full(dem_small.shape[1], 30.0), "y": np.full(dem_small.shape[0], -30.0)}
    args = {"tpi": (11,), "disk_descriptors": ([7, 11],),
            "sx_sweep": (offsets, distances, border), "gradient": (2.25, res)}[op]
    a, b = getattr(piped, op)(dem_small, *args), getattr(serial, op)(dem_small, *args)
    pairs = [(a[k], b[k]) for k in a] if isinstance(a, dict) else (
        zip(a, b) if isinstance(a, list) else [(a, b)])
    for x, y in pairs:
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))


def test_bands_are_writable_and_owned_by_the_sink(dem_small, runner):
    before = dem_small.copy()
    seen = []

    def sink(start, band):
        assert band.flags.writeable
        band[...] = -1.0  # the band belongs to this sink
        seen.append(start)

    runner.sx(dem_small, *kernels.sx_offsets(0.0, 300.0, 30.0, 30.0), sink=sink)
    assert seen == list(range(0, dem_small.shape[0], 16))
    np.testing.assert_array_equal(dem_small, before)


def _raises_without_hanging(fn, exc_type, match):
    """Run ``fn`` under a watchdog: it must raise ``exc_type`` (matching
    ``match``) within 60 s, and leave no band-loop thread behind."""
    box = {}

    def target():
        try:
            fn()
        except BaseException as exc:  # handed to the test thread
            box["exc"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the band loop hung"
    assert isinstance(box.get("exc"), exc_type), box
    assert re.search(match, str(box["exc"]))
    assert not [x for x in threading.enumerate() if x.name.startswith("tiles-")]


def test_pipelined_compute_error_propagates(dem_small):
    runner = TiledRunner(tile_rows=8, pipeline=True, device="cpu")
    calls = {"n": 0}

    def boom(window, meta):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("synthetic compute failure")
        return [window[: meta[1] - meta[0]]]

    _raises_without_hanging(lambda: runner._drive(dem_small, (2, 2), boom, lambda m, r: None),
                            RuntimeError, "synthetic compute failure")


def test_pipelined_sink_error_propagates(dem_small):
    runner = TiledRunner(tile_rows=8, pipeline=True, device="cpu")

    def bad_sink(start, band):
        raise OSError("disk full")

    _raises_without_hanging(lambda: runner.tpi(dem_small, 7, sink=bad_sink), OSError,
                            "disk full")


def test_pipelined_read_error_propagates(dem_small):
    class FailingReader:
        shape = dem_small.shape

        def __getitem__(self, key):
            if key.start > 20:
                raise OSError("truncated strip")
            return dem_small[key]

    runner = TiledRunner(tile_rows=8, pipeline=True, device="cpu")
    _raises_without_hanging(
        lambda: runner._drive(FailingReader(), (2, 2), lambda w, m: [w], lambda m, r: None),
        OSError, "truncated strip")


def test_locked_reader_passes_through(dem_small):
    holes = dem_small.copy()
    holes[5, 2:7] = np.nan

    class Reader:
        shape = dem_small.shape
        grid = "grid"
        masks_decoded = 0

        def __getitem__(self, key):
            return holes[key]

        def read_rows(self, r0, r1):
            return holes[r0:r1]

        def nan_rows(self, r0, r1):
            self.masks_decoded += 1
            return np.isnan(holes[r0:r1])

    reader = Reader()
    locked = LockedReader.wrap(reader)
    assert LockedReader.wrap(locked) is locked
    assert locked.shape == dem_small.shape and locked.grid == "grid"
    np.testing.assert_array_equal(locked[3:9], holes[3:9])
    np.testing.assert_array_equal(locked.read_rows(3, 9), holes[3:9])
    # every output of a band asks for its mask: one decode serves them all
    for _ in range(3):
        mask = locked.nan_rows(4, 8)
        np.testing.assert_array_equal(mask, np.isnan(holes[4:8]))
        assert mask[1, 2:7].all() and not mask.flags.writeable
    assert reader.masks_decoded == 1
    assert not locked.nan_rows(0, 4).any() and reader.masks_decoded == 2


def test_runner_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is missing")
    with pytest.raises(RuntimeError, match="cuda"):
        TiledRunner(64)
    with pytest.raises(ValueError, match="tile_rows"):
        TiledRunner(0, device="cpu")


@pytest.mark.cuda
def test_tiled_on_the_card_pipelined_equals_serial_and_single(dem_small):
    """Pinned copies on the two streams: pipelined, serial and the single
    pass give the same bits for TPI and Sx on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned-copy streams run only there")
    offsets, distances, border = kernels.sx_offsets(0.0, 500.0, 30.0, 30.0)
    piped = TiledRunner(tile_rows=8, pipeline=True)
    serial = TiledRunner(tile_rows=8, pipeline=False)
    for run in (lambda r: r.tpi(dem_small, 11),
                lambda r: r.sx(dem_small, offsets, distances, border)):
        a, b = run(piped), run(serial)
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    single = ops.sx(dem_small, offsets, distances, border).cpu().numpy()
    np.testing.assert_array_equal(piped.sx(dem_small, offsets, distances, border), single)
