"""Timing and throughput observability.

The port's own copy of ``topo_descriptors_tpu/utils/timing.py``:
the port imports nothing of the JAX package.

The reference logs per-op wall time through an ``@timer`` decorator
(helpers.py:157-168). Here the timer is a context manager *and* decorator,
logs HH:mm:ss like the reference, and additionally records structured
(name, seconds) samples in a process-global registry so the benchmark
harness can report Mpixel/s without re-instrumenting ops.
"""

from __future__ import annotations

import contextlib
import datetime as dt
import functools
import logging
import time
from collections import defaultdict
from typing import Dict, List

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
