"""What a traced run reads from ``torch.profiler``: device activity, copies,
kernels by name and the harness's own spans, all in the profiler's clock.

The union arithmetic (``union``, ``busy_seconds``) is that of the
program's ``topo_descriptors_tpu_torch/utils/profiling.py::device_busy_s``
(a test holds them equal), and the event selection that of its
``device_spans``. Everything is computed from the
events in memory; no trace file is written.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

SPAN = "pb:"  # prefix of the harness's record_function spans
WINDOW = SPAN + "window"


def union(spans) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_seconds(spans) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    return sum(e - s for s, e in union(spans)) / 1e9


@dataclass
class DeviceEvent:
    name: str
    start: int  # ns
    end: int

    @property
    def kind(self) -> str:
        if self.name.startswith("Memcpy"):
            return "copy"
        if self.name.startswith("Memset"):
            return "memset"
        return "kernel"


@dataclass
class Trace:
    window: tuple  # (start_ns, end_ns) of the measured window
    device: list  # DeviceEvent inside the window, clipped to it
    spans: list = field(default_factory=list)  # (start_ns, end_ns, name) of "pb:" spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return busy_seconds((e.start, e.end) for e in self.device)

    def kernels(self, within=None) -> list:
        """Kernel events; only those inside a span whose name satisfies the
        predicate ``within``, where given (the spans it picks are disjoint)."""
        events = [e for e in self.device if e.kind == "kernel"]
        if within is None:
            return events
        spans = sorted((s, e) for s, e, n in self.spans if within(n))
        starts = [s for s, _ in spans]
        out = []
        for k in events:
            i = bisect.bisect_right(starts, k.start) - 1
            if i >= 0 and k.end <= spans[i][1]:
                out.append(k)
        return out

    def labels_at(self, times) -> list:
        """For each of the sorted ``times``, the innermost harness span open
        then (without its prefix), or "between calls". The spans nest: they
        come from context managers on one thread."""
        marks = sorted([(s, 1, n) for s, _, n in self.spans if n != WINDOW]
                       + [(e, 0, n) for _, e, n in self.spans if n != WINDOW])
        out, stack, i = [], [], 0
        for t in times:
            while i < len(marks) and marks[i][0] <= t:
                _, opens, name = marks[i]
                if opens:
                    stack.append(name)
                elif name in stack:
                    stack.remove(name)
                i += 1
            out.append(stack[-1][len(SPAN):] if stack else "between calls")
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time of
        the device summed by what the host had open."""
        by_op = {}
        for e in self.device:
            by_op[e.name] = by_op.get(e.name, 0.0) + (e.end - e.start) / 1e9
        busy = union((e.start, e.end) for e in self.device)
        edges = [self.window[0]] + [t for iv in busy for t in iv] + [self.window[1]]
        gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        idle = {}
        for (s, e), label in zip(gaps, self.labels_at([(s + e) // 2 for s, e in gaps])):
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
        rank = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:top]
        return {"device_ops": rank(by_op), "idle_gaps": rank(idle)}


@contextlib.contextmanager
def profiled(enabled: bool):
    """A ``torch.profiler`` over the block (CPU and CUDA activities) when
    ``enabled``; yields a list that holds the ``Trace`` once the block ends."""
    out = []
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield out
    out.append(read(prof))


def read(prof) -> Trace:
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(SPAN):  # the harness's spans (their GPU-side copies too)
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(DeviceEvent(e.name(), e.start_ns(), e.end_ns()))
    windows = [(s, e) for s, e, n in spans if n == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not 1")
    lo, hi = windows[0]
    inside = [DeviceEvent(d.name, max(d.start, lo), min(d.end, hi)) for d in device
              if d.end > lo and d.start < hi]
    return Trace((lo, hi), inside, spans)
