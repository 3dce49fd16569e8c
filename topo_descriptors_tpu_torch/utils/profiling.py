"""Profiling and roofline observability on ``torch.profiler``.

Counterpart of ``topo_descriptors_tpu/utils/profiling.py``: a device trace
(a Chrome trace of ``torch.profiler`` instead of an xprof one), Mpixel/s
per timer label, and a roofline model that says how far an op sits from
the card's ceilings. All host-side: nothing here touches the compute path.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from topo_descriptors_tpu_torch.utils.timing import Timings

logger = logging.getLogger(__name__)


def device_spans(prof) -> List[Tuple[int, int]]:
    """``(start_ns, end_ns)`` of every device event (kernel, copy, memset)
    of a finished ``torch.profiler.profile``. The device-side copies of
    ``record_function`` ranges (user annotations, which cover the work
    launched inside a range and the gaps between it) are not device work
    and are left out."""
    return [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def device_busy_s(spans: Iterable[Tuple[int, int]]) -> Optional[float]:
    """Seconds in which the device ran something: the length of the union
    of the ``(start_ns, end_ns)`` intervals; None when there are none."""
    spans = sorted(spans)
    if not spans:
        return None
    busy, (lo, hi) = 0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    return (busy + hi - lo) / 1e9


@dataclass
class DeviceTrace:
    """What :func:`device_trace` yields. After the block: the Chrome trace's
    path, the block's wall seconds (host clock) and the device's busy
    seconds in it (None when the trace holds no device event)."""

    path: Path
    wall_s: Optional[float] = None
    busy_s: Optional[float] = None


@contextlib.contextmanager
def device_trace(logdir, device="cuda"):
    """Trace the block with ``torch.profiler`` and write ``trace.json``
    under ``logdir`` (open it in chrome://tracing or Perfetto).

    Usage::

        with device_trace("/tmp/trace") as trace:
            result = op(dem)
            torch.cuda.synchronize()
        print(trace.busy_s / trace.wall_s)

    On a CUDA device it records the CPU and CUDA activities; the CPU alone
    only when the caller asks for ``device="cpu"``. Asking for CUDA where
    there is none raises.
    """
    from torch.profiler import ProfilerActivity, profile

    from topo_descriptors_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace = DeviceTrace(path=Path(logdir) / "trace.json")
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        yield trace
        trace.wall_s = time.perf_counter() - start
    trace.path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace.path))
    trace.busy_s = device_busy_s(device_spans(prof))
    logger.info(f"device trace written to {trace.path}")


def throughput_report(pixels: int) -> Dict[str, float]:
    """Mpixel/s per recorded timer label (utils.timing.Timings registry),
    from each label's fastest sample."""
    report = {}
    for name, samples in Timings.samples.items():
        best = min(samples)
        report[name] = pixels / 1e6 / best if best > 0 else float("inf")
    return report


# --- roofline model ----------------------------------------------------------


@dataclass
class Roofline:
    """Ceilings of one NVIDIA H100 SXM (the card of the port).

    Fields and the JAX ``Roofline`` field each one takes the place of:

    * ``hbm_gbps`` (``hbm_gbps``): HBM3 rate, published peak;
    * ``fp32_tflops`` (``vpu_tflops``): float32 outside the tensor cores,
      published peak; the Sx kernels run there;
    * ``conv_tflops`` (``mxu_tflops_f32``): the rate of the ``direct``
      row-channel convolution; cuDNN in full float32 (no TF32) runs on the
      same float32 units, so the same peak;
    * ``fft_tflops`` (``fft_tflops``): cuFFT's sustained rate on the
      streamed ``fft`` route's kernel convolution (rfft2, spectral product,
      irfft2), 5 N log2 N flops per transform, at the 5-smooth shapes of
      the 20 km and 100 km scales on 900 x 1440;
    * ``mm_tmacs`` (``mm_tmacs``): sustained MAC rate of the partial-DFT
      matmul convolution (``ops/dft_conv.py::conv_bank``, cuBLAS SGEMM in
      full float32) on the valley mix: the 2 km bank and the 20 km
      streamed kernels at 900 x 1440;
    * ``gather_rows_gps`` (``gather_rows_gps``): rows per second (1e9) of
      the rotation-table gather (``spline_rotate.rotate_std_canvas_table``,
      27-float rows) at 20 km.

    The published peaks assume the 700 W limit. The measured rates come
    from ``chip_smoke.py`` phase 9 on an NVIDIA H100 80GB HBM3,
    "NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi prints name and power
    limit.
    """

    hbm_gbps: float = 3350.0  # H100 SXM data sheet, 700 W
    fp32_tflops: float = 67.0  # H100 SXM data sheet, 700 W
    conv_tflops: float = 67.0  # H100 SXM data sheet, 700 W (float32, no TF32)
    fft_tflops: float = 6.0521  # measured: H100 80GB HBM3, 700.00 W (chip_smoke.py phase 9)
    mm_tmacs: float = 20.4643  # measured: H100 80GB HBM3, 700.00 W (chip_smoke.py phase 9)
    gather_rows_gps: float = 6.6553  # measured: H100 80GB HBM3, 700.00 W (chip_smoke.py phase 9)

    def sx_light_speed_ms(
        self, pixels: int, n_offsets: int, n_groups: Optional[int] = None
    ) -> float:
        """Sx lower bound, bound by the float32 instruction rate.

        The naive shifted-max loop costs 3 ops per (pixel, ray): subtract,
        multiply, fmax. The distance-grouped kernels (``csrc/sx_rays.cuh``)
        hoist subtract/multiply out of each equal-distance group, leaving
        one fmax per ray (``K - G`` tree-fmax ops) plus 3 ops per group —
        ``K + 2G`` ops per pixel. Pass ``n_groups`` (``len(dist_table)``)
        for the grouped ceiling; omit it for the ungrouped 3K model (the
        plain twin)."""
        if n_groups is None:
            flops = pixels * n_offsets * 3.0
        else:
            flops = pixels * (n_offsets + 2.0 * n_groups)
        return flops / (self.fp32_tflops * 1e12) * 1e3

    def valley_ridge_light_speed_ms(
        self,
        h: int,
        w: int,
        size: int,
        n_flats: int = 3,
        n_angles: int = 180,
        method: str = "direct",
    ) -> float:
        """Valley/ridge lower bound for one scale, with the JAX model's
        formulas. The methods and the routes of the port they model:

        * ``mm_bank`` — ``ops.valley_ridge(method='dftmm')``: the
          precomputed bank through the partial-DFT matmuls
          (``ops/dft_conv.py``), the conv MACs per kernel at the aliased
          transform lengths charged at ``mm_tmacs``;
        * ``mm_stream`` — ``valley_ridge_streamed(conv_method='mm')`` with
          the rotation on the device: the same MACs plus the
          rotation-table gather floor (one 27-float row per canvas pixel,
          46 quadrant rotations per 180 angles) at ``gather_rows_gps``;
        * ``mm_cached`` — the same with a warm device canvas cache
          (``ops.valley_ridge._CANVAS_DEV_CACHE``): rotation amortized away;
        * ``direct`` — ``method='direct'``, the row-channel cuDNN
          convolution: KY*KX taps per output pixel of each (angle, flat)
          plane, 2 flops each, at ``conv_tflops``;
        * ``fft`` — ``valley_ridge_streamed(conv_method='fft')``: per
          angle, F kernel rfft2s, the product and the inverse transforms,
          (2F + 0.5) transforms at the linear-conv shape (the field
          transform is hoisted and amortizes to ~0), at ``fft_tflops``.
          The lengths are the route's 5-smooth ones (``ops.conv._fft_shape``)
          where the JAX model counts powers of two, which at 900 x 1440
          hold up to ~1.9x more points (2048 x 4096 against 1875 x 2400 at
          20 km).
        """
        from topo_descriptors_tpu_torch.kernels.valley import rotated_extent
        from topo_descriptors_tpu_torch.ops.conv import _fft_shape

        ky, kx = rotated_extent(size, np.arange(n_angles))
        if method in ("mm_bank", "mm_stream", "mm_cached"):
            sy, sx = (ky - 1) // 2, (kx - 1) // 2
            fh = max(h + ky - 1 - sy, sy + h)
            fw = max(w + kx - 1 - sx, sx + w)
            nb = fw // 2 + 1
            macs = (
                ky * kx * nb * 2
                + fh * ky * nb * 4
                + h * fh * nb * 4
                + h * nb * w * 2
            )
            ms = n_angles * n_flats * macs / (self.mm_tmacs * 1e12) * 1e3
            if method == "mm_stream":
                q = min(n_angles, 46)  # quadrant rotations (46 per 180)
                rows = q * float(max(ky, kx)) ** 2
                ms += rows / (self.gather_rows_gps * 1e9) * 1e3
            return ms
        if method == "direct":
            flops = 2.0 * h * w * ky * kx * n_flats * n_angles
            return flops / (self.conv_tflops * 1e12) * 1e3
        fh, fw = _fft_shape(h + ky - 1), _fft_shape(w + kx - 1)
        n = fh * fw
        per_angle = (2 * n_flats + 0.5) * 5.0 * n * np.log2(max(n, 2))
        return n_angles * per_angle / (self.fft_tflops * 1e12) * 1e3

    def fft_conv_light_speed_ms(self, fft_pixels: int, n_transforms: int) -> float:
        """FFT-conv lower bound: 5 N log2 N real flops per transform."""
        flops = n_transforms * 5.0 * fft_pixels * np.log2(max(fft_pixels, 2))
        return flops / (self.fft_tflops * 1e12) * 1e3

    def hbm_light_speed_ms(self, bytes_moved: int) -> float:
        return bytes_moved / (self.hbm_gbps * 1e9) * 1e3
