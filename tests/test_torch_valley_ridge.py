"""The port's valley/ridge index and its engines (partial-DFT matmuls,
on-device spline rotation) against the JAX package and the scipy recipe,
on the CPU.

Tolerances:
* DFT conv: relative to the largest output, 1e-4 against scipy in float64
  and against the JAX op (both float32 matmul chains over ~1e2-long sums);
* spline rotation: those of tests/test_spline_rotate.py (prefilter 1e-5 of
  the largest value, rotated canvas atol 1e-4);
* valley/ridge: norm rtol 1e-3, atol 2e-3; direction may differ only where
  the norm is near-tied between angles, on under 2% of the pixels (the
  rule of tests/test_ops.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage, signal

from oracles import _valley_ridge_oracle
from topo_descriptors_tpu_torch.config import CFG  # the port reads its own CFG
from topo_descriptors_tpu.kernels.valley import rotate_kernels, rotated_extent, valley_kernels
from topo_descriptors_tpu.ops import dft_conv as jdft
from topo_descriptors_tpu.ops import spline_rotate as jrot
from topo_descriptors_tpu_torch.ops import conv as tconv
from topo_descriptors_tpu_torch.ops import dft_conv as tdft
from topo_descriptors_tpu_torch.ops import spline_rotate as trot

# the packages' ops namespaces export the function under the module's name
jvr = importlib.import_module("topo_descriptors_tpu.ops.valley_ridge")
tvr = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")

NORM_TOL = dict(rtol=1e-3, atol=2e-3)
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _assert_valley_close(outs, refs):
    norm, direction = (np.asarray(o) for o in outs)
    np.testing.assert_allclose(norm, np.asarray(refs[0]), **NORM_TOL)
    assert (direction != np.asarray(refs[1])).mean() < 0.02


_ORACLE_RUNS: dict = {}


def _oracle(dem_tiny, size, mode, flats, sigma):
    """The scipy recipe on ``dem_tiny``, once per case."""
    key = (size, mode, flats, sigma)
    if key not in _ORACLE_RUNS:
        _ORACLE_RUNS[key] = _valley_ridge_oracle(dem_tiny, size, mode, list(flats), sigma)
    return _ORACLE_RUNS[key]


# --- the partial-DFT matmul engine ------------------------------------------------


@pytest.mark.parametrize(
    "shape,kk,mode",
    [((50, 73), 9, "same"), ((50, 73), 24, "same"), ((41, 37), 15, "valid"), ((30, 44), 29, "same")],
)
def test_conv_bank_matches_jax_and_scipy(shape, kk, mode):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    ker = rng.standard_normal((3, kk, kk)).astype(np.float32)
    plan = tdft.get_plan(*shape, kk, kk, mode, device="cpu")
    out = tdft.conv_bank(_t(ker), *tdft.field_spectrum(_t(x), plan), plan).numpy()
    ref = np.stack([signal.convolve(x.astype(np.float64), k.astype(np.float64), mode) for k in ker])
    jplan = jdft.get_plan(*shape, kk, kk, mode)
    jout = np.asarray(jdft.conv_bank(jnp.asarray(ker), *jdft.field_spectrum(jnp.asarray(x), jplan), jplan))
    assert out.shape == ref.shape == jout.shape
    assert (plan.fh, plan.fw, plan.nb, plan.oshape) == (jplan.fh, jplan.fw, jplan.nb, jplan.oshape)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-4 * scale)


def test_field_spectrum_matches_fft():
    x = np.random.default_rng(12).standard_normal((40, 56)).astype(np.float32)
    plan = tdft.get_plan(40, 56, 13, 13, "same", device="cpu")
    fdr, fdi = tdft.field_spectrum(_t(x), plan)
    ref = np.fft.rfft2(x.astype(np.float64), s=(plan.fh, plan.fw))
    np.testing.assert_allclose(fdr.numpy(), ref.real, atol=2e-3)
    np.testing.assert_allclose(fdi.numpy(), ref.imag, atol=2e-3)


def test_plan_cache_is_keyed_on_the_device():
    a = tdft.get_plan(64, 64, 9, 9, "same", device="cpu")
    assert tdft.get_plan(64, 64, 9, 9, "same", device=CPU) is a
    assert a.device == CPU and all(m.device == CPU for m in a.mats + a.field_mats)
    assert a.macs_per_kernel() == jdft.DftConvPlan(64, 64, 9, 9).macs_per_kernel()
    with pytest.raises(ValueError, match="mode"):
        tdft.DftConvPlan(64, 64, 9, 9, "full", device="cpu")


@pytest.mark.parametrize("shape,kk", [((900, 1440), 95), ((900, 1440), 943), ((900, 1440), 4717),
                                      ((40, 48), 13), ((64, 64), 33)])
def test_prefer_dft_matmul_routes_as_jax(shape, kk):
    assert tdft.prefer_dft_matmul(*shape, kk, kk) == jdft.prefer_dft_matmul(*shape, kk, kk)


def test_full_float32_pins_and_restores_the_flags():
    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        before = (mm.allow_tf32, cd.allow_tf32, mm.fp32_precision, cd.conv.fp32_precision)
        assert before[0]
        with tconv.full_float32():
            assert not mm.allow_tf32 and not cd.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
            assert mm.fp32_precision == cd.conv.fp32_precision == "ieee"
        assert (mm.allow_tf32, cd.allow_tf32, mm.fp32_precision, cd.conv.fp32_precision) == before
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("method", ["direct", "fft"])
@pytest.mark.parametrize("kshape", [(5, 5), (6, 8), (35, 33)])
def test_conv2d_same_batch_matches_jax_and_scipy(dem_small, kshape, method):
    from topo_descriptors_tpu.ops import conv as jconv

    x = dem_small - 1500.0
    bank = np.random.default_rng(5).standard_normal((3,) + kshape).astype(np.float32)
    out = tconv.conv2d_same_batch(_t(x), bank, method).numpy()
    ref = np.stack([signal.convolve(x.astype(np.float64), k.astype(np.float64), "same") for k in bank])
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * scale)
    jout = np.asarray(jconv.conv2d_same_batch(jnp.asarray(x), bank, method))
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("kshape", [(7, 7), (12, 10)])
def test_conv2d_bank_rowchan_matches_jax_and_scipy(dem_small, kshape, padding):
    from topo_descriptors_tpu.ops import conv as jconv

    x = dem_small - 1500.0
    bank = np.random.default_rng(6).standard_normal((4,) + kshape).astype(np.float32)
    out = tconv.conv2d_bank_rowchan(_t(x), torch.from_numpy(bank), padding).numpy()
    ref = np.stack([signal.convolve(x.astype(np.float64), k.astype(np.float64), padding)
                    for k in bank])
    jout = np.asarray(jconv.conv2d_bank_rowchan(jnp.asarray(x), jnp.asarray(bank), padding))
    assert out.shape == ref.shape == jout.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-5 * scale)
    with pytest.raises(ValueError, match="padding"):
        tconv.conv2d_bank_rowchan(_t(x), bank, "full")


# --- the spline rotation ------------------------------------------------------------


def test_prefilter_matches_jax_and_scipy():
    x = np.random.default_rng(3).normal(size=(2, 41, 53)).astype(np.float32)
    ref = np.stack([ndimage.spline_filter(p.astype(np.float64), order=2, mode="constant") for p in x])
    mine = trot.prefilter2d_o2(_t(x)).numpy()
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(mine, np.asarray(jrot.prefilter2d_o2(jnp.asarray(x))),
                               rtol=0, atol=1e-5 * np.abs(ref).max())


def test_host_helpers_equal_jax():
    assert trot.exact_deg_trig(450.0) == jrot.exact_deg_trig(450.0) == (0.0, 1.0)
    for size, angle in ((9, 13.0), (31, 137.0), (667, 45.0)):
        kmax = max(rotated_extent(size))
        np.testing.assert_array_equal(trot.rotation_params(size, angle, kmax, kmax),
                                      jrot.rotation_params(size, angle, kmax, kmax))
    for n_angles in (180, 37):
        for mine, ref in zip(trot.quadrant_schedule(n_angles), jrot.quadrant_schedule(n_angles)):
            np.testing.assert_array_equal(mine, ref)
    with pytest.raises(ValueError):
        trot.quadrant_schedule(181)


@pytest.mark.parametrize("size", [9, 31])
def test_rotation_matches_jax_and_scipy(size):
    base = valley_kernels(size, (0, 0.15, 0.3))
    ky_max, kx_max = rotated_extent(size)
    filt = trot.prefilter2d_o2(_t(base))
    table = trot.build_rotation_table(filt)
    jfilt = jrot.prefilter2d_o2(jnp.asarray(base))
    np.testing.assert_allclose(table.numpy(), np.asarray(jrot.build_rotation_table(jfilt)),
                               rtol=0, atol=1e-6)
    for angle in (0.0, 13.0, 45.0, 90.0, 137.0, 179.0):
        params = trot.rotation_params(size, angle, ky_max, kx_max)
        host = rotate_kernels(base, angle)
        _, ky, kx = host.shape
        lo_y = (ky_max - 1) // 2 - (ky - 1) // 2
        lo_x = (kx_max - 1) // 2 - (kx - 1) // 2
        canvas = np.zeros((3, ky_max, kx_max), np.float32)
        canvas[:, lo_y : lo_y + ky, lo_x : lo_x + kx] = host
        gathered = trot.rotate_std_canvas(filt, params, (ky_max, kx_max)).numpy()
        tabled = trot.rotate_std_canvas_table(table, size, params, (ky_max, kx_max)).numpy()
        jax_canvas = np.asarray(jrot.rotate_std_canvas(jfilt, jnp.asarray(params), (ky_max, kx_max)))
        for out in (gathered, tabled):
            np.testing.assert_allclose(out, canvas, rtol=0, atol=1e-4)
            np.testing.assert_allclose(out, jax_canvas, rtol=0, atol=1e-4)


@pytest.mark.parametrize("size", [9, 15])
def test_canvas_variants_equal_jax(size):
    kmax = max(rotated_extent(size))
    rng = np.random.default_rng(size)
    canvas = rng.standard_normal((2, kmax, kmax)).astype(np.float32)
    for q in (0.0, 17.0, 44.0):
        params = trot.rotation_params(size, q, kmax, kmax)
        mine = trot.canvas_variants(_t(canvas), params)
        ref = jrot.canvas_variants(jnp.asarray(canvas), jnp.asarray(params))
        for m, r in zip(mine, ref):
            np.testing.assert_array_equal(m.numpy(), np.asarray(r))


# --- valley / ridge -------------------------------------------------------------------


CASES = {  # (size, mode, flats, sigma)
    "valley7": (7, "valley", (0, 0.2), None),
    "ridge9_smoothed": (9, "ridge", (0, 0.2), 1.5),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("method", list(tvr.METHODS))
def test_valley_ridge_matches_jax_and_oracle(dem_tiny, method, case):
    size, mode, flats, sigma = CASES[case]
    outs = tvr.valley_ridge(dem_tiny, size, mode, list(flats), sigma, method=method, device="cpu")
    assert all(o.dtype == torch.float32 and o.shape == dem_tiny.shape for o in outs)
    outs = [o.numpy() for o in outs]
    ref = jvr.valley_ridge(jnp.asarray(dem_tiny), size, mode, list(flats), sigma, method=method)
    _assert_valley_close(outs, ref)
    _assert_valley_close(outs, _oracle(dem_tiny, size, mode, flats, sigma))
    assert outs[1].min() >= 0 and outs[1].max() <= 179 and (outs[0] >= 0).all()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("conv_method", ["mm", "fft"])
def test_valley_ridge_streamed_matches_jax_and_oracle(dem_tiny, conv_method, case):
    size, mode, flats, sigma = CASES[case]
    outs = tvr.valley_ridge_streamed(dem_tiny, size, mode, list(flats), sigma,
                                     conv_method=conv_method, device="cpu")
    outs = [o.numpy() for o in outs]
    ref = jvr.valley_ridge_streamed(jnp.asarray(dem_tiny), size, mode, list(flats), sigma,
                                    conv_method=conv_method)
    _assert_valley_close(outs, ref)
    _assert_valley_close(outs, _oracle(dem_tiny, size, mode, flats, sigma))


def test_streamed_inline_rotation_equals_cached(dem_tiny, monkeypatch):
    cached = tvr.valley_ridge_streamed(dem_tiny, 9, "valley", [0, 0.2], q_batch=3, device="cpu")
    monkeypatch.setattr(CFG, "valley_canvas_cache_bytes", 0)
    inline = tvr.valley_ridge_streamed(dem_tiny, 9, "valley", [0, 0.2], q_batch=3, device="cpu")
    for a, b in zip(cached, inline):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bank_carries_over_from_jax(dem_tiny):
    bank = jvr.prepare_valley_bank(9, "valley", [0, 0.15, 0.3])
    np.testing.assert_array_equal(tvr.prepare_valley_bank(9, "valley", [0, 0.15, 0.3]), bank)
    np.testing.assert_array_equal(tvr._fold_flats_np(bank), jvr._fold_flats_np(bank))
    for method in ("dftmm", "direct", "fft"):
        outs = tvr.valley_ridge(dem_tiny, 9, "valley", [0, 0.15, 0.3], bank=bank, method=method,
                                device="cpu")
        ref = jvr.valley_ridge(jnp.asarray(dem_tiny), 9, "valley", [0, 0.15, 0.3], bank=bank,
                               method=method)
        _assert_valley_close([o.numpy() for o in outs], ref)


def test_auto_routes_large_banks_to_streamed(dem_tiny, monkeypatch):
    assert tvr.bank_nbytes(15, 2) == jvr.bank_nbytes(15, 2) > 100
    monkeypatch.setattr(CFG, "valley_bank_max_bytes", 100)
    routed = tvr.valley_ridge(dem_tiny, 15, "valley", [0, 0.2], device="cpu")
    explicit = tvr.valley_ridge_streamed(dem_tiny, 15, "valley", [0, 0.2], device="cpu")
    for a, b in zip(routed, explicit):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_device_caches_are_bounded_and_keyed_on_the_device(dem_tiny):
    tvr._BANK_DEV_CACHE.clear()
    tvr._CANVAS_DEV_CACHE.clear()
    for size in (5, 7, 9):
        tvr.valley_ridge(dem_tiny, size, "valley", [0, 0.2], device="cpu")
        tvr.valley_ridge_streamed(dem_tiny, size, "ridge", [0, 0.2], device="cpu")
    for cache in (tvr._BANK_DEV_CACHE, tvr._CANVAS_DEV_CACHE):
        assert len(cache) == 2
        assert all(CPU in key and key[0] in (7, 9) for key in cache)
    hit = tvr.valley_ridge(dem_tiny, 9, "valley", [0, 0.2], device="cpu")
    miss = tvr.valley_ridge(dem_tiny, 9, "valley", [0, 0.2], bank=jvr.prepare_valley_bank(
        9, "valley", [0, 0.2]), device="cpu")
    for a, b in zip(hit, miss):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_valley_ridge_rejects_bad_arguments(dem_tiny):
    with pytest.raises(ValueError, match="mode"):
        tvr.valley_ridge(dem_tiny, 7, "mountain", device="cpu")
    with pytest.raises(ValueError, match="method"):
        tvr.valley_ridge(dem_tiny, 7, "valley", method="pallas", device="cpu")
    with pytest.raises(ValueError, match="conv_method"):
        tvr.valley_ridge_streamed(dem_tiny, 7, "valley", conv_method="direct", device="cpu")


@pytest.mark.cuda
def test_valley_ridge_ignores_the_global_tf32_setting():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from topo_descriptors_tpu.io.synthetic import synthetic_dem

    dem = torch.from_numpy(synthetic_dem(180, 288, seed=4)).cuda()
    prev = torch.get_float32_matmul_precision()
    results = {}
    try:
        for precision in ("highest", "high"):
            torch.set_float32_matmul_precision(precision)
            for method in ("dftmm", "direct", "stream"):
                tvr._BANK_DEV_CACHE.clear()
                tvr._CANVAS_DEV_CACHE.clear()
                results[precision, method] = tvr.valley_ridge(
                    dem, 15, "valley", [0, 0.15, 0.3], method=method, device="cuda")
    finally:
        torch.set_float32_matmul_precision(prev)
    for method in ("dftmm", "direct", "stream"):
        for a, b in zip(results["highest", method], results["high", method]):
            assert torch.equal(a, b), method
