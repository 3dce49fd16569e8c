"""Timing and throughput observability.

The port's own copy of ``topo_descriptors_tpu/utils/timing.py``:
the port imports nothing of the JAX package.

The reference logs per-op wall time through an ``@timer`` decorator
(helpers.py:157-168). Here the timer is a context manager *and* decorator,
logs HH:mm:ss like the reference, and additionally records structured
(name, seconds) samples in a process-global registry so the benchmark
harness can report Mpixel/s without re-instrumenting ops.

:func:`span` names the program's host work inside the drivers and ops for
a profiler: it opens a range only while one records, so that a trace can
put each idle gap of the device down to the work the host had open.
"""

from __future__ import annotations

import contextlib
import datetime as dt
import functools
import logging
import time
from collections import defaultdict
from typing import Dict, List

import torch

logger = logging.getLogger(__name__)


class Timings:
    """Process-global registry of timed samples."""

    samples: Dict[str, List[float]] = defaultdict(list)

    @classmethod
    def record(cls, name: str, seconds: float) -> None:
        cls.samples[name].append(seconds)

    @classmethod
    def clear(cls) -> None:
        cls.samples.clear()


@contextlib.contextmanager
def _timing(name: str):
    t_start = time.monotonic()
    try:
        yield
    finally:
        elapsed = time.monotonic() - t_start
        Timings.record(name, elapsed)
        pretty = str(dt.timedelta(seconds=elapsed)).split(".", 2)[0]
        logger.info(f"Computed in {pretty} (HH:mm:ss)")


def timer(func_or_name):
    """``@timer`` decorator (reference helpers.py:157) or
    ``with timer("name"):`` context manager."""
    if callable(func_or_name):
        func = func_or_name

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with _timing(func.__name__):
                return func(*args, **kwargs)

        return wrapper
    return _timing(func_or_name)


# Every name the program opens a span under; a name carries no scale or
# size, so that a trace sums each one over the scales.
SPANS = (
    "upload",  # pipeline: dtype cast, host staging, host-to-device copy
    "d2h",  # pipeline: device-to-host copy into a host array
    "nan_pass",  # pipeline: full-plane host copy and NaN scatter
    "resolution",  # grid: UTM reprojection of a geographic grid, np.gradient
    "prep.kernel",  # kernels.disk: the disk mask
    "prep.runs",  # ops.conv: a {0,1} kernel's run decomposition
    "prep.count_plane",  # ops.conv: the boundary count plane's factors and upload
    "prep.table",  # device.TableCache: lookup, and on a miss build and upload
    "prep.rays",  # kernels.sx_geometry: Sx ray offsets and distances
    "smooth",  # ops.conv: Gaussian taps and the separable passes' launches
    "valley.field",  # ops.valley_ridge: the field's float64 pre-smooth and standardisation
    "valley.bank",  # ops.valley_ridge: a bank's device rotations and flat fold
    "valley.canvas",  # ops.valley_ridge: the streamed route's canvas rotations
    "valley.scan",  # ops.valley_ridge: the angle-chunk or quadrant loop's launches
)
PREFIX = "topo:"
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(name):`` a profiler range ``"topo:" + name`` while a
    profiler records (``torch.profiler``, ``utils.profiling.device_trace``),
    else nothing: there is no switch, and off it costs one check.

    The range is a function-scope record (the kind the profiler keeps for
    operators), not a ``record_function`` user annotation, so it leaves no
    copy on the device's timeline: a trace's device events stay the
    device's work alone."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    if name not in SPANS:
        raise ValueError(f"unknown span {name!r}; the names are utils.timing.SPANS")
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)
