"""The port's ShardedOps on CPU meshes: the cases of tests/test_sharded.py.

Each case runs on a (2, 4) mesh of eight CPU blocks in one process
(``make_mesh((2, 4), ["cpu"] * 8)``) and on an (8, 1) one, whose 8-row
blocks make every halo above 8 rows multi-hop. Each output is held against
the JAX package's ShardedOps on a mesh of the same shape over the eight
virtual CPU devices of tests/conftest.py, and against the port's
single-pass op, with the tolerances of tests/test_sharded.py; Sx and the
sweep equal the port's single pass bit for bit. Ragged grids are padded
with ``pad_to_mesh`` and cropped, as the drivers do.

Two comparisons with the JAX package take the port's cross-package
tolerances instead, where the two packages' float32 arithmetic differs:
slope and aspect take rtol 1e-3 (tests/test_torch_gradient.py; aspect
modulo 360). STD with a pre-smooth is held against the JAX package with
``int32_parity=False`` on both sides, and with the reference's int32
truncation against the port's single pass only: where the two packages'
smoothed values lie 1 ulp apart across an integer, the truncation moves
the variance by ~2c/k (5 m of STD at 7 px). The unsmoothed cases hold the
truncation against JAX as well. Against the port's single pass every
tolerance is test_sharded.py's.
"""

import importlib

import jax
import numpy as np
import pytest
import torch
from scipy import ndimage

from topo_descriptors_tpu.parallel.mesh import make_mesh as jmake_mesh
from topo_descriptors_tpu.parallel.mesh import pad_to_mesh as jpad_to_mesh
from topo_descriptors_tpu.parallel.sharded import ShardedOps as JShardedOps
from topo_descriptors_tpu_torch import ops
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.host import sx_offsets, sx_sweep_offsets
from topo_descriptors_tpu_torch.parallel import ShardedOps, make_mesh, pad_to_mesh

tvr = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Many small torch ops per block: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", params=[(2, 4), (8, 1)], ids=["2x4", "8x1"])
def both(request):
    """(the port's ShardedOps, the JAX package's) on meshes of one shape."""
    assert len(jax.devices()) >= 8, "tests need 8 virtual devices"
    shape = request.param
    return (ShardedOps(make_mesh(shape, ["cpu"] * 8)),
            JShardedOps(jmake_mesh(shape=shape, devices=jax.devices()[:8])))


@pytest.fixture(scope="module")
def dem64():
    noise = np.random.default_rng(44).standard_normal((64, 96))
    smooth = ndimage.gaussian_filter(noise, 5.0)
    return (1400.0 + 800.0 * smooth / np.abs(smooth).max()).astype(np.float32)


def _ragged(seed, shape):
    rng = np.random.default_rng(seed)
    return (1200 + 300 * rng.standard_normal(shape)).astype(np.float32)


def _hold(port, ref, single, rtol, atol, hw=None, jax_rtol=None, angle=False):
    """The port's sharded output against the JAX package's sharded output
    (unless ``ref`` is None; at ``jax_rtol`` where given; modulo 360 for an
    ``angle``) and against the port's single pass (cropped to ``hw`` on a
    ragged grid)."""
    crop = (Ellipsis,) if hw is None else (Ellipsis, slice(0, hw[0]), slice(0, hw[1]))
    port = np.asarray(port)[crop]
    pairs = [(np.asarray(single), rtol)]
    if ref is not None:
        pairs.append((np.asarray(ref)[crop], rtol if jax_rtol is None else jax_rtol))
    for other, r in pairs:
        if angle:  # aspect: 359.99 and 0.01 are 0.02 degrees apart
            diff = np.abs((port - other + 180.0) % 360.0 - 180.0)
            assert np.all(diff <= atol + r * np.abs(other)), diff.max()
        else:
            np.testing.assert_allclose(port, other, rtol=r, atol=atol)


def _hold_gradient(port, ref, single, rtol, atol, hw=None):
    for i, (p, r, s) in enumerate(zip(port, ref, single)):
        _hold(p, r, s, rtol=rtol, atol=atol, hw=hw, jax_rtol=1e-3 if i >= 2 else None,
              angle=i == 3)


def _same_bits(port, single, hw=None):
    port = np.asarray(port)
    if hw is not None:
        port = port[..., : hw[0], : hw[1]]
    np.testing.assert_array_equal(port.view(np.int32), np.asarray(single).view(np.int32))


def _put_both(sops, jsops, dem, fill=None):
    """The DEM on both meshes; padded with ``fill`` when given."""
    if fill is None:
        return sops.put(dem), jsops.put(dem), None
    padded, hw = pad_to_mesh(dem, sops.mesh, fill=fill)
    jpadded, _ = jpad_to_mesh(dem, jsops.mesh, fill=fill)
    return sops.put(padded), jsops.put(jpadded), hw


@pytest.mark.parametrize("sigma", [2.5, 6.0], ids=["sigma2.5", "sigma6-halo-near-block"])
def test_sharded_gaussian(both, dem64, sigma):
    # sigma 6: tap radius 24 against 32-row blocks (2x4) and 8-row ones
    # (8x1, a three-hop reflect through _reflect_oob)
    sops, jsops = both
    x, jx, _ = _put_both(sops, jsops, dem64)
    _hold(sops.gaussian(x, sigma), jsops.gaussian(jx, sigma),
          ops.gaussian_filter(torch.from_numpy(dem64), sigma), rtol=1e-6, atol=1e-3)


def test_sharded_gaussian_reflect_too_wide_raises(both, dem64):
    # tap radius 80 >= the 64-row domain: impossible on any mesh
    sops, jsops = both
    with pytest.raises(ValueError, match="reflect halo"):
        sops.gaussian(sops.put(dem64), 20.0)
    with pytest.raises(Exception, match="reflect halo"):
        np.asarray(jsops.gaussian(jsops.put(dem64), 20.0))


@pytest.mark.parametrize("size,sigma", [(7, None), (15, 1.75)])
def test_sharded_tpi(both, dem64, size, sigma):
    sops, jsops = both
    x, jx, _ = _put_both(sops, jsops, dem64)
    _hold(sops.tpi(x, size, sigma), jsops.tpi(jx, size, sigma),
          ops.tpi(dem64, size, sigma, device="cpu"), rtol=1e-5, atol=2e-2)


@pytest.mark.parametrize("size", [7, 15])
def test_sharded_std(both, dem64, size):
    sops, jsops = both
    x, jx, _ = _put_both(sops, jsops, dem64)
    _hold(sops.std(x, size), jsops.std(jx, size), ops.std(dem64, size, device="cpu"),
          rtol=1e-3, atol=5e-2)


RES64 = {"x": np.full(96, 30.0, np.float32), "y": np.full(64, -30.0, np.float32)}


@pytest.mark.parametrize("sigma,ratio", [(0.5, 1.0), (2.25, 1.0), (2.0, 1.5)])
def test_sharded_gradient(both, dem64, sigma, ratio):
    sops, jsops = both
    x, jx, _ = _put_both(sops, jsops, dem64)
    port = sops.gradient(x, sigma, RES64, ratio)
    ref = jsops.gradient(jx, sigma, RES64, ratio)
    _hold_gradient(port, ref, ops.gradient(dem64, sigma, RES64, ratio, device="cpu"),
                   rtol=1e-3, atol=2e-2)


def _hold_valley(port, ref, single, hw=None, directions=True):
    _hold(port[0], ref[0], single[0], rtol=1e-4, atol=2e-3, hw=hw)
    if directions:  # ties can flip at float round-off: near-total agreement
        direction = np.asarray(port[1])
        if hw is not None:
            direction = direction[: hw[0], : hw[1]]
        assert (direction != single[1].numpy()).mean() < 0.02
        assert (direction != np.asarray(ref[1])[: direction.shape[0], : direction.shape[1]]
                ).mean() < 0.02


def test_sharded_valley_ridge(both, dem64):
    sops, jsops = both
    x, jx, _ = _put_both(sops, jsops, dem64)
    _hold_valley(sops.valley_ridge(x, 7, "valley", (0, 0.2)),
                 jsops.valley_ridge(jx, 7, "valley", (0, 0.2)),
                 ops.valley_ridge(dem64, 7, "valley", [0, 0.2], device="cpu"))


def test_sharded_valley_ridge_rotates_its_bank_on_the_device(both, dem64, monkeypatch):
    """The mesh convolves the single-device op's own bank, rotated on each
    block's device: no scipy rotation, one bank per device."""
    from topo_descriptors_tpu_torch.kernels import valley as tvalley

    def refuse(*args, **kwargs):
        raise AssertionError("the mesh rotated kernels with scipy")

    monkeypatch.setattr(tvalley, "rotate_kernels", refuse)
    sops = ShardedOps(both[0].mesh)  # an empty bank cache
    x = sops.put(dem64)
    port = sops.valley_ridge(x, 9, "ridge", (0, 0.15, 0.3))
    single = ops.valley_ridge(dem64, 9, "ridge", [0, 0.15, 0.3], device="cpu")
    _hold(port[0], None, single[0], rtol=1e-4, atol=2e-3)
    assert (np.asarray(port[1]) != single[1].numpy()).mean() < 0.02
    assert sops._cache.builds == 1  # blocks on one device share it


@pytest.mark.parametrize("entry", ["valley_ridge_streamed", "valley_ridge"],
                         ids=["streamed", "routed-past-the-budget"])
def test_sharded_valley_ridge_streamed(both, dem64, entry, monkeypatch):
    # size 15's rotated extent (21) exceeds the 8-row blocks: multi-hop. With
    # the budget just below the bank, valley_ridge routes itself to the
    # streamed method, as ops.valley_ridge does
    sops, jsops = both
    if entry == "valley_ridge":
        monkeypatch.setattr(CFG, "valley_bank_max_bytes", tvr.bank_nbytes(15, 2) - 1)
    x, jx, _ = _put_both(sops, jsops, dem64)
    port = getattr(sops, entry)(x, 15, "valley", (0, 0.2))
    _hold_valley(port, jsops.valley_ridge_streamed(jx, 15, "valley", (0, 0.2)),
                 ops.valley_ridge_streamed(dem64, 15, "valley", [0, 0.2], device="cpu"))
    if entry == "valley_ridge":
        for routed, streamed in zip(port, sops.valley_ridge_streamed(x, 15, "valley", (0, 0.2))):
            _same_bits(routed, streamed.numpy())


def test_sharded_valley_ridge_streamed_ragged_smoothed(both):
    sops, jsops = both
    rng = np.random.default_rng(5)
    dem = (1200.0 + 500.0 * ndimage.gaussian_filter(rng.standard_normal((62, 93)), 4.0)
           ).astype(np.float32)
    x, jx, hw = _put_both(sops, jsops, dem, fill=0.0)
    _hold_valley(
        sops.valley_ridge_streamed(x, 9, "ridge", (0, 0.2), sigma=1.5, valid_shape=hw),
        jsops.valley_ridge_streamed(jx, 9, "ridge", (0, 0.2), sigma=1.5, valid_shape=hw),
        ops.valley_ridge_streamed(dem, 9, "ridge", [0, 0.2], sigma=1.5, device="cpu"),
        hw=hw, directions=False)


@pytest.mark.parametrize("azimuth,radius", [(30.0, 600.0), (120.0, 200.0)],
                         ids=["wide-halo", "small-radius"])
def test_sharded_sx(both, dem64, azimuth, radius):
    # 600 m: border 20 px, one hop on 32x24 blocks, three on 8-row blocks
    sops, jsops = both
    offsets, distances, border = sx_offsets(azimuth, radius, 30.0, 30.0)
    x, jx, _ = _put_both(sops, jsops, dem64)
    port = sops.sx(x, offsets, distances, border)
    single = ops.sx(dem64, offsets, distances, border, device="cpu")
    _hold(port, jsops.sx(jx, offsets, distances, border), single, rtol=1e-4, atol=1e-3)
    _same_bits(port, single)


def test_sharded_sx_ragged_grid(both):
    # NaN pads are skipped like the beyond-edge fill; the zero border sits
    # at the original frame
    sops, jsops = both
    dem = _ragged(8, (61, 95))
    offsets, distances, border = sx_offsets(45.0, 300.0, 30.0, 30.0)
    x, jx, hw = _put_both(sops, jsops, dem, fill=np.nan)
    port = sops.sx(x, offsets, distances, border, valid_shape=hw)
    single = ops.sx(dem, offsets, distances, border, device="cpu")
    _hold(port, jsops.sx(jx, offsets, distances, border, valid_shape=hw), single,
          rtol=1e-4, atol=1e-3, hw=hw)
    _same_bits(port, single, hw)


@pytest.mark.parametrize("azimuths,radius", [([0.0, 90.0, 225.0], 300.0), ([30.0, 210.0], 600.0)],
                         ids=["3az-r300", "2az-r600-multihop"])
def test_sharded_sx_sweep(both, dem64, azimuths, radius):
    # the ray halo is exchanged once for the fan; r600 pads its tables
    # (NaN rows) and is multi-hop on 8-row blocks
    sops, jsops = both
    o, d, b = sx_sweep_offsets(azimuths, radius, 30.0, 30.0)
    x, jx, _ = _put_both(sops, jsops, dem64)
    port = sops.sx_sweep(x, o, d, b)
    single = ops.sx_sweep(dem64, o, d, b, device="cpu")
    assert np.asarray(port).shape == (len(azimuths),) + dem64.shape
    _hold(port, jsops.sx_sweep(jx, o, d, b), single, rtol=1e-4, atol=1e-3)
    _same_bits(port, single)


@pytest.mark.parametrize("seed,size,sigma", [(7, 7, None), (12, 7, 1.75)],
                         ids=["plain", "smoothed"])
def test_sharded_tpi_ragged_grid(both, seed, size, sigma):
    # (63, 97): the pre-smooth reflects at the true edge, the centring
    # constant and the tap counts come from the true domain
    sops, jsops = both
    dem = _ragged(seed, (63, 97))
    x, jx, hw = _put_both(sops, jsops, dem, fill=0.0)
    _hold(sops.tpi(x, size, sigma, valid_shape=hw), jsops.tpi(jx, size, sigma, valid_shape=hw),
          ops.tpi(dem, size, sigma, device="cpu"), rtol=1e-5, atol=2e-2, hw=hw)


def test_sharded_std_ragged_with_smoothing(both):
    sops, jsops = both
    dem = _ragged(13, (63, 97))
    x, jx, hw = _put_both(sops, jsops, dem, fill=0.0)
    _hold(sops.std(x, 7, 1.75, valid_shape=hw), None, ops.std(dem, 7, 1.75, device="cpu"),
          rtol=1e-3, atol=5e-2, hw=hw)
    _hold(sops.std(x, 7, 1.75, int32_parity=False, valid_shape=hw),
          jsops.std(jx, 7, 1.75, int32_parity=False, valid_shape=hw),
          ops.std(dem, 7, 1.75, int32_parity=False, device="cpu"), rtol=1e-3, atol=5e-2, hw=hw)


@pytest.mark.parametrize("seed,sigma", [(14, 2.0), (15, 0.75)], ids=["gaussian", "sobel"])
def test_sharded_gradient_ragged(both, seed, sigma):
    sops, jsops = both
    dem = _ragged(seed, (63, 94))
    res = {"x": np.full(94, 30.0, np.float32), "y": np.full(63, -30.0, np.float32)}
    x, jx, hw = _put_both(sops, jsops, dem, fill=0.0)
    port = sops.gradient(x, sigma, res, 1.0, valid_shape=hw)
    ref = jsops.gradient(jx, sigma, res, 1.0, valid_shape=hw)
    _hold_gradient(port, ref, ops.gradient(dem, sigma, res, 1.0, device="cpu"), rtol=1e-4,
                   atol=1e-3, hw=hw)


@pytest.mark.parametrize("seed,sigma", [(9, None), (16, 1.5)], ids=["plain", "smoothed"])
def test_sharded_valley_ridge_ragged_grid(both, seed, sigma):
    # masked statistics, pad pixels zeroed after standardizing
    sops, jsops = both
    dem = _ragged(seed, (63, 94))
    x, jx, hw = _put_both(sops, jsops, dem, fill=0.0)
    _hold_valley(sops.valley_ridge(x, 7, "valley", (0, 0.2), sigma=sigma, valid_shape=hw),
                 jsops.valley_ridge(jx, 7, "valley", (0, 0.2), sigma=sigma, valid_shape=hw),
                 ops.valley_ridge(dem, 7, "valley", [0, 0.2], sigma, device="cpu"), hw=hw,
                 directions=sigma is None)


@pytest.mark.parametrize("sigma", [None, 1.75])
def test_sharded_disk_descriptors_fused(both, dem64, sigma):
    sops, jsops = both
    sizes = (7, 15, 23)
    x, jx, _ = _put_both(sops, jsops, dem64)
    batch = sops.disk_descriptors(x, sizes, sigma)
    jbatch = jsops.disk_descriptors(jx, sizes, sigma)
    single = ops.disk_descriptors(dem64, sizes, sigma, device="cpu")
    assert np.asarray(batch["tpi"]).shape == (3,) + dem64.shape
    if sigma:  # the truncation against JAX only where nothing was smoothed
        clean = dict(int32_parity=False, compute_tpi=False)
        cbatch, jcbatch = (s.disk_descriptors(a, sizes, sigma, **clean)
                           for s, a in ((sops, x), (jsops, jx)))
        csingle = ops.disk_descriptors(dem64, sizes, sigma, device="cpu", **clean)
    for j in range(len(sizes)):
        _hold(batch["tpi"][j], jbatch["tpi"][j], single["tpi"][j], rtol=1e-5, atol=2e-2)
        _hold(batch["std"][j], None if sigma else jbatch["std"][j], single["std"][j],
              rtol=1e-4, atol=5e-2)
        if sigma:
            _hold(cbatch["std"][j], jcbatch["std"][j], csingle["std"][j], rtol=1e-4, atol=5e-2)


def test_sharded_disk_descriptors_fused_ragged(both):
    sops, jsops = both
    dem = _ragged(17, (63, 97))
    x, jx, hw = _put_both(sops, jsops, dem, fill=0.0)
    batch = sops.disk_descriptors(x, (7, 15), 1.75, valid_shape=hw)
    jbatch = jsops.disk_descriptors(jx, (7, 15), 1.75, valid_shape=hw)
    for j, size in enumerate((7, 15)):
        _hold(batch["tpi"][j], jbatch["tpi"][j], ops.tpi(dem, size, 1.75, device="cpu"),
              rtol=1e-5, atol=2e-2, hw=hw)


def test_mesh_shape_validation(both):
    sops, _ = both
    with pytest.raises(ValueError, match="pad_to_mesh"):
        sops.put(np.zeros((63, 96), np.float32))
    with pytest.raises(TypeError, match="ShardedArray"):
        sops.tpi(np.zeros((64, 96), np.float32), 7)


@pytest.mark.parametrize("method,k", [("fft", 33), ("direct", 5), ("auto", 9), ("auto", 35)])
def test_conv2d_valid_bank_matches_jax(dem64, method, k):
    from topo_descriptors_tpu.ops import conv as jconv
    from topo_descriptors_tpu_torch.ops import conv as tconv

    bank = np.random.default_rng(3).standard_normal((4, k, k - 2)).astype(np.float32)
    out = tconv.conv2d_valid_bank(torch.from_numpy(dem64 - 1400.0), bank, method).numpy()
    ref = np.asarray(jconv.conv2d_valid_bank(jax.numpy.asarray(dem64 - 1400.0), bank, method))
    assert out.shape == (4, 64 - k + 1, 96 - k + 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-2)
    # each plane is the VALID part of the library convolution of that kernel
    direct = torch.nn.functional.conv2d(torch.from_numpy(dem64 - 1400.0)[None, None],
                                        torch.from_numpy(bank[:, ::-1, ::-1].copy())[:, None])
    np.testing.assert_allclose(out, direct[0].numpy(), rtol=1e-4, atol=2e-2)
