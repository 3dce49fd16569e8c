"""The port's profiling utilities against the JAX package's, on the CPU.

``throughput_report`` and every ``Roofline`` method must give the JAX
results on the same inputs (relative 1e-12) once the JAX ceilings are
passed in, the valley ``fft`` floor with the JAX model's power-of-two
transform lengths swapped for the 5-smooth ones the port pads to; the
port's own defaults are the H100's. ``device_trace`` runs
here with the CPU activity only, and ``device_busy_s`` is checked on
hand-made intervals.
"""

import json
import math

import numpy as np
import pytest
import torch

from topo_descriptors_tpu.kernels.valley import rotated_extent
from topo_descriptors_tpu.ops import dft_conv as jdft
from topo_descriptors_tpu.utils.profiling import Roofline as JaxRoofline
from topo_descriptors_tpu.utils.profiling import throughput_report as jax_throughput_report
from topo_descriptors_tpu.utils.timing import Timings as JaxTimings
from topo_descriptors_tpu_torch.ops import dft_conv as tdft
from topo_descriptors_tpu_torch.ops.conv import _fft_shape
from topo_descriptors_tpu_torch.utils import (
    Roofline,
    Timings,
    device_busy_s,
    device_trace,
    throughput_report,
    timer,
)

V5E = JaxRoofline()
# the JAX ceilings under the port's field names (Roofline's docstring maps them)
JAX_CEILINGS = dict(hbm_gbps=V5E.hbm_gbps, fp32_tflops=V5E.vpu_tflops,
                    conv_tflops=V5E.mxu_tflops_f32, fft_tflops=V5E.fft_tflops,
                    mm_tmacs=V5E.mm_tmacs, gather_rows_gps=V5E.gather_rows_gps)
VALLEY_METHODS = ["mm_bank", "mm_stream", "mm_cached", "direct", "fft"]
# 2, 20 and 100 km at 30 m (scale_to_pixel), the example batch's scales
VALLEY_SIZES = [67, 667, 3333]


@pytest.fixture
def clean_timings():
    Timings.clear()
    JaxTimings.clear()
    yield
    Timings.clear()
    JaxTimings.clear()


def test_throughput_report_matches_jax(clean_timings):
    samples = {"tpi scale 2000m": [0.5, 0.25, 0.75], "sx az 0 r 500m": [0.125],
               "instant": [0.0]}
    for name, values in samples.items():
        for v in values:
            Timings.record(name, v)
            JaxTimings.record(name, v)
    report = throughput_report(pixels=1_296_000)
    assert report == jax_throughput_report(pixels=1_296_000)
    assert report["tpi scale 2000m"] == pytest.approx(1.296 / 0.25, rel=1e-12)
    assert report["instant"] == float("inf")


def test_throughput_report_as_the_jax_test(clean_timings):
    # tests/test_pipeline_io.py::test_throughput_report, on the port
    with timer("demo op"):
        pass
    report = throughput_report(pixels=1_000_000)
    assert "demo op" in report and report["demo op"] > 0
    rl = Roofline(**JAX_CEILINGS)
    assert rl.sx_light_speed_ms(1_300_000, 240) > 0
    assert rl.hbm_light_speed_ms(10**9) > 1.0
    # on the card's ceilings a GB moves in under a third of a millisecond
    assert Roofline().hbm_light_speed_ms(10**9) == pytest.approx(1e9 / 3350e9 * 1e3, rel=1e-12)


@pytest.mark.parametrize("n_groups", [None, 17])
def test_sx_floor_matches_jax(n_groups):
    ours = Roofline(**JAX_CEILINGS).sx_light_speed_ms(1_296_000, 240, n_groups)
    assert ours == pytest.approx(V5E.sx_light_speed_ms(1_296_000, 240, n_groups), rel=1e-12)


@pytest.mark.parametrize("size", VALLEY_SIZES)
@pytest.mark.parametrize("method", VALLEY_METHODS)
def test_valley_floor_matches_jax(method, size):
    ours = Roofline(**JAX_CEILINGS).valley_ridge_light_speed_ms(900, 1440, size, method=method)
    ref = V5E.valley_ridge_light_speed_ms(900, 1440, size, method=method)
    if method == "fft":  # 5 N log2 N at the 5-smooth shape, not the power-of-two one
        ky, kx = rotated_extent(size)
        n5 = _fft_shape(900 + ky - 1) * _fft_shape(1440 + kx - 1)
        n2 = (1 << math.ceil(math.log2(900 + ky - 1))) * (1 << math.ceil(math.log2(1440 + kx - 1)))
        ref *= n5 * math.log2(n5) / (n2 * math.log2(n2))
    assert ours == pytest.approx(ref, rel=1e-12)


def test_fft_and_hbm_floors_match_jax():
    rl = Roofline(**JAX_CEILINGS)
    assert rl.fft_conv_light_speed_ms(1875 * 2400, 1152) == pytest.approx(
        V5E.fft_conv_light_speed_ms(1875 * 2400, 1152), rel=1e-12)
    assert rl.hbm_light_speed_ms(3 * 10**9) == pytest.approx(V5E.hbm_light_speed_ms(3 * 10**9),
                                                            rel=1e-12)


def test_fft_floor_counts_the_ports_5_smooth_lengths():
    """The FFT floor counts the 5-smooth lengths the streamed route
    transforms (1875 x 2400 at 20 km on 900 x 1440), not the JAX model's
    power-of-two ones (2048 x 4096): (2F + 0.5) transforms per angle."""
    rl = Roofline()
    n = 1875 * 2400
    per_angle = 6.5 * 5.0 * n * math.log2(n)
    assert rl.valley_ridge_light_speed_ms(900, 1440, 667, method="fft") == pytest.approx(
        180 * per_angle / (rl.fft_tflops * 1e12) * 1e3, rel=1e-12)


def test_defaults_are_the_cards():
    rl = Roofline()
    # published peaks of one H100 SXM at 700 W; chip_smoke.py's bounds use them
    assert (rl.hbm_gbps, rl.fp32_tflops, rl.conv_tflops) == (3350.0, 67.0, 67.0)
    # the routing cost model and the roofline carry the same measured rate
    assert rl.mm_tmacs * 1e12 == pytest.approx(tdft._MM_MACS_PER_SEC, rel=1e-12)
    ours = [rl.hbm_gbps, rl.fp32_tflops, rl.conv_tflops, rl.fft_tflops, rl.mm_tmacs,
            rl.gather_rows_gps]
    v5e = [V5E.hbm_gbps, V5E.vpu_tflops, V5E.mxu_tflops_f32, V5E.fft_tflops, V5E.mm_tmacs,
           V5E.gather_rows_gps]
    assert all(a != b for a, b in zip(ours, v5e)), list(zip(ours, v5e))
    assert tdft._MM_MACS_PER_SEC != jdft._MM_MACS_PER_SEC
    assert tdft._FFT_SEC_PER_PT != jdft._FFT_SEC_PER_PT


def test_device_trace_on_the_cpu(tmp_path):
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with device_trace(tmp_path / "trace", device="cpu") as trace:
        (a @ b).sum()
    assert trace.path == tmp_path / "trace" / "trace.json" and trace.path.exists()
    names = {e.get("name") for e in json.loads(trace.path.read_text())["traceEvents"]}
    assert "aten::mm" in names
    assert trace.busy_s is None and trace.wall_s > 0


def test_device_trace_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device_trace('cuda') traces it")
    with pytest.raises(RuntimeError, match="is_available"):
        with device_trace(tmp_path, device="cuda"):
            pass
    assert not (tmp_path / "trace.json").exists()


@pytest.mark.parametrize("spans,busy", [
    ([], None),
    ([(0, 1_000)], 1e-6),
    # a gap: both intervals count
    ([(0, 1_000), (3_000, 4_500)], 2.5e-6),
    # overlapping and nested, unsorted: their union
    ([(2_000, 5_000), (0, 3_000), (2_500, 2_600)], 5e-6),
    # touching intervals merge
    ([(0, 1_000), (1_000, 2_000), (10_000, 10_500)], 2.5e-6),
])
def test_device_busy_s(spans, busy):
    got = device_busy_s(spans)
    if busy is None:
        assert got is None
    else:
        assert got == pytest.approx(busy, rel=1e-12)
        assert np.isfinite(got)
