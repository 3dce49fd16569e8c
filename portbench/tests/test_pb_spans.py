"""The program's spans leave every reading of a trace as it was, and
``copy_gbps`` reads the program's copy counter over the copies' device
time; on hand-made traces, and on a tiny cell on the CPU."""

from __future__ import annotations

import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import run as runner
from portbench import trace

CELL = "alps_tile_8192_30m.tpi_sx"
MS = 1_000_000  # ns
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
H2D, D2H = "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pageable)"


def _event(name, start, end, kind):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
                           device_type=lambda: kind)


def _events(program: bool) -> list:
    """Two calls of the cell (TPI, then Sx) in a 100 ms window: the
    harness's spans and their device-side copies, copies and kernels, and,
    where ``program``, the spans the program opens inside each call (host
    records only: they leave nothing on the device's timeline)."""
    ev = [_event(trace.WINDOW, 0, 100 * MS, CPU), _event(trace.WINDOW, 1 * MS, 99 * MS, CUDA),
          _event("pb:compute_tpi #0", 1 * MS, 50 * MS, CPU),
          _event("pb:tpi scale 2000m", 3 * MS, 30 * MS, CPU),
          _event("pb:compute_sx #1", 50 * MS, 99 * MS, CPU),
          _event(H2D, 2 * MS, 8 * MS, CUDA), _event("disk_sat_tile", 10 * MS, 12 * MS, CUDA),
          _event("vectorized_elementwise_kernel", 12 * MS, 13 * MS, CUDA),
          _event(D2H, 14 * MS, 28 * MS, CUDA),
          _event(H2D, 52 * MS, 58 * MS, CUDA), _event("sx_block_tile", 60 * MS, 61 * MS, CUDA),
          _event(D2H, 62 * MS, 76 * MS, CUDA), _event("Memset (Device)", 77 * MS, 78 * MS, CUDA)]
    if program:
        ev += [_event("topo:upload", 1 * MS, 9 * MS, CPU),
               _event("topo:resolution", 9 * MS, 9 * MS + 1000, CPU),
               _event("topo:prep.kernel", 3 * MS + 10, 3 * MS + 50, CPU),
               _event("topo:prep.count_plane", 4 * MS, 9 * MS, CPU),
               _event("topo:prep.runs", 4 * MS, 5 * MS, CPU),  # nested in the count plane
               _event("topo:d2h", 13 * MS, 29 * MS, CPU),
               _event("topo:nan_pass", 30 * MS, 45 * MS, CPU),
               _event("topo:upload", 51 * MS, 59 * MS, CPU),
               _event("topo:prep.rays", 59 * MS, 59 * MS + 500, CPU),
               _event("topo:prep.table", 59 * MS + 600, 60 * MS, CPU),
               _event("topo:d2h", 61 * MS, 77 * MS, CPU)]
    return ev


def _traced_run(program: bool, counters=None):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: _events(program))))
    config = runner.load("configs", "alps_tile_8192_30m")
    h, w = 64, 96
    calls = [SimpleNamespace(call="compute_tpi", args={"scales": [2000]}, error="",
                             driver=True, seconds=0.049),
             SimpleNamespace(call="compute_sx", args={"azimuth": 0, "radius": 500}, error="",
                             driver=True, seconds=0.049)]
    return SimpleNamespace(trace=trace.read(prof), shape=(h, w), config=config,
                           x=6.8e5 + 30.0 * np.arange(w), y=5.1e6 - 30.0 * np.arange(h),
                           calls=calls, jobs=1.0, window_s=0.1, steps_per_job=2,
                           counters=counters or {})


def _readings(run) -> dict:
    bench = json.loads(runner.BENCHMARK.read_text())
    return {m["name"]: runner.metric_module(m["name"]).read(run) for m in bench["per_layer"]}


def test_program_spans_leave_every_reading_as_it_was():
    bytes_moved = {"copy_gbps": {"h2d": 10**6, "d2h": 10**6}}
    without, with_spans = _traced_run(False, bytes_moved), _traced_run(True, bytes_moved)
    assert with_spans.trace.device == without.trace.device
    assert with_spans.trace.busy_s == without.trace.busy_s
    assert with_spans.trace.breakdown() == without.trace.breakdown()
    before, after = _readings(without), _readings(with_spans)
    assert after == before
    for name in ("device_idle_share", "copy_share", "disk_sat_roofline", "sx_block_roofline",
                 "tpi_calls_roofline", "copy_gbps"):
        assert before[name] is not None, name


def test_copy_rate_is_the_counted_bytes_over_the_copies_device_time():
    copy_gbps = runner.metric_module("copy_gbps")
    run = _traced_run(True, {"copy_gbps": {"h2d": 3 * 10**9, "d2h": 37 * 10**9}})
    # copies: 6 + 14 + 6 + 14 ms; the memset is not a copy
    assert copy_gbps.read(run) == pytest.approx(40e9 / 40e-3 / 1e9)


@pytest.mark.parametrize("counters", [{}, {"copy_gbps": {}}, {"copy_gbps": {"h2d": 0, "d2h": 0}}])
def test_copy_rate_is_silent_without_counted_bytes(counters):
    # {}: the reader had no counter to take (a program without COPIED_BYTES)
    assert runner.metric_module("copy_gbps").read(_traced_run(True, counters)) is None


def test_copy_rate_is_silent_without_a_trace_or_copies():
    copy_gbps = runner.metric_module("copy_gbps")
    run = _traced_run(True, {"copy_gbps": {"h2d": 10, "d2h": 10}})
    run.trace.device = [e for e in run.trace.device if e.kind != "copy"]
    assert copy_gbps.read(run) is None
    run.trace = None
    assert copy_gbps.read(run) is None


def test_copy_counter_is_the_programs(monkeypatch):
    from topo_descriptors_tpu_torch import device

    monkeypatch.setitem(device.COPIED_BYTES, "h2d", 7)
    monkeypatch.setitem(device.COPIED_BYTES, "d2h", 11)
    assert runner.metric_module("copy_gbps").counters() == {"h2d": 7, "d2h": 11}
    monkeypatch.delattr(device, "COPIED_BYTES")
    assert runner.metric_module("copy_gbps").counters() == {}


def test_traced_cpu_cell_leaves_the_copy_rate_silent(tiny):
    result = runner.run(CELL, 2**31 + 91, 0.2, True, "cpu", log=io.StringIO())
    assert result["correct"]
    assert "copy_gbps" not in result["metrics"]
    assert "copy_gbps" in {m["name"] for m in runner.cell_metrics(CELL, True)}
