"""Cross-cutting utilities: timing, profiling and the roofline model."""

from topo_descriptors_tpu_torch.utils.profiling import (
    DeviceTrace,
    Roofline,
    device_busy_s,
    device_spans,
    device_trace,
    throughput_report,
)
from topo_descriptors_tpu_torch.utils.timing import Timings, timer

__all__ = [
    "timer",
    "Timings",
    "device_trace",
    "DeviceTrace",
    "device_spans",
    "device_busy_s",
    "throughput_report",
    "Roofline",
]
