"""The port's profiler spans and copy counters, on the CPU.

``utils.timing.span`` opens a range named ``"topo:" + name`` while a
profiler records and nothing otherwise; the drivers and ops open one
around each piece of host work (``SPANS``), and ``device.COPIED_BYTES``
counts the bytes the drivers move between host and a CUDA device. Here
the drivers run under ``torch.profiler`` with the CPU activity on a tiny
geographic grid with voids; the ``cuda``-marked tests skip off the card.
"""

import contextlib
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from topo_descriptors_tpu_torch import device, pipeline
from topo_descriptors_tpu_torch.grid import fill_na
from topo_descriptors_tpu_torch.host import basodino_like_dem
from topo_descriptors_tpu_torch.utils import device_busy_s, device_spans
from topo_descriptors_tpu_torch.utils.timing import PREFIX, SPANS, span

CALL = "test:call"
TIMER = "test:timer"
# (driver, arguments, spans it must open); every call also opens "upload",
# "resolution" (a geographic grid) and "d2h"
DRIVERS = {
    "tpi_single": ("compute_tpi", dict(scales=[300], smth_factors=1),
                   {"smooth", "prep.kernel", "prep.runs", "prep.count_plane", "nan_pass"}),
    "tpi_fused": ("compute_tpi", dict(scales=[100, 300]),
                  {"prep.kernel", "prep.runs", "prep.count_plane", "nan_pass"}),
    "std": ("compute_std", dict(scales=[300]),
            {"prep.kernel", "prep.runs", "prep.count_plane", "nan_pass"}),
    "sx": ("compute_sx", dict(azimuth=0, radius=300), {"prep.rays"}),
    "valley": ("compute_valley_ridge", dict(scales=[300], mode="valley", flat_list=[0, 0.2, 0.4],
                                            smth_factors=0.5),
               {"smooth", "valley.scan", "nan_pass"}),
}


def _with_voids(ny, nx):
    dem = basodino_like_dem(ny, nx, projected=False)
    data = dem.data.copy()
    data[5:8, 10:14] = np.nan
    ind_nans, filled = fill_na(dem.with_data(data))
    return filled, ind_nans


@pytest.fixture(scope="module")
def raster():
    return _with_voids(40, 60)


@pytest.fixture(scope="module")
def card_raster():
    """Large enough that a plane outweighs every table of a call."""
    return _with_voids(200, 300)


@pytest.fixture
def in_memory(monkeypatch):
    """The drivers' NetCDF writer replaced by one that keeps the planes."""
    planes = []

    def to_netcdf(array, dem, name, crop=None, outdir=".", units=None):
        planes.append(np.asarray(array))
        return name

    monkeypatch.setattr(pipeline, "to_netcdf", to_netcdf)
    return planes


def _call(raster, case):
    driver, args, _ = DRIVERS[case]
    dem, ind_nans = raster
    kwargs = dict(args, device="cpu")
    if driver != "compute_sx":
        kwargs["ind_nans"] = ind_nans
    return getattr(pipeline, driver)(dem, **kwargs)


def _ranges(prof, prefix):
    return [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
            if e.name().startswith(prefix) and e.device_type() == torch.autograd.DeviceType.CPU]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALL):
            fn()
    return prof


@pytest.mark.parametrize("case", list(DRIVERS))
def test_driver_opens_its_spans_inside_the_call(raster, in_memory, case):
    prof = _traced(lambda: _call(raster, case))
    (call,) = _ranges(prof, CALL)
    spans = _ranges(prof, PREFIX)
    names = {n[len(PREFIX):] for _, _, n in spans}
    assert names <= set(SPANS)
    assert DRIVERS[case][2] | {"upload", "resolution", "d2h"} <= names
    assert all(call[0] <= s and e <= call[1] for s, e, _ in spans)


@pytest.mark.parametrize("case", ["tpi_single", "tpi_fused", "std"])
def test_every_download_is_inside_its_scales_timer(raster, in_memory, monkeypatch, case):
    saved = pipeline.timer

    @contextlib.contextmanager
    def timer(name):
        with record_function(TIMER), saved(name):
            yield

    monkeypatch.setattr(pipeline, "timer", timer)
    prof = _traced(lambda: _call(raster, case))
    timers = _ranges(prof, TIMER)
    downloads = _ranges(prof, PREFIX + "d2h")
    assert timers and len(downloads) >= len(timers)
    for s, e, _ in downloads:
        assert any(ts <= s and e <= te for ts, te, _ in timers)


@pytest.mark.parametrize("case", list(DRIVERS))
def test_no_profiler_opens_no_range(raster, in_memory, monkeypatch, case):
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    assert _call(raster, case)


def test_span_names_are_fixed():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="unknown span"):
            span("tpi scale 2000m")
    assert len(set(SPANS)) == len(SPANS)
    assert all(re.fullmatch(r"[a-z][a-z0-9_.]*", name) for name in SPANS)


def test_table_lookup_opens_a_span_on_hit_and_miss():
    cache = device.TableCache(size=2)
    built = []

    def build():
        built.append(1)
        return "table"

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert cache.get("k", build) == "table"  # miss
        assert cache.get("k", build) == "table"  # hit
    assert len(built) == 1 and cache.builds == 1
    assert len(_ranges(prof, PREFIX + "prep.table")) == 2


@pytest.mark.parametrize("case", list(DRIVERS))
def test_cpu_runs_copy_nothing(raster, in_memory, case):
    before = dict(device.COPIED_BYTES)
    _call(raster, case)
    device.upload(np.zeros(5, dtype=np.float32), "cpu")
    device.as_field(np.zeros((3, 4)), "cpu")
    device.to_host(torch.zeros(3))
    assert device.COPIED_BYTES == before


def _event(name, start, end, on_device, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if on_device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
                           device_type=lambda: kind, is_user_annotation=lambda: annotation)


def test_device_spans_leave_out_user_annotations():
    kernels = [("disk_sat_tile", 100, 200), ("Memcpy DtoH (Device -> Pageable)", 400, 500)]
    events = [_event(n, s, e, True) for n, s, e in kernels]
    events += [_event("pb:window", 0, 1000, False, True),
               _event("pb:window", 100, 500, True, True),  # the range's device-side copy
               _event("topo:d2h", 390, 510, False),
               _event("aten::copy_", 395, 505, False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert device_spans(prof) == [(s, e) for _, s, e in kernels]
    assert device_busy_s(device_spans(prof)) == pytest.approx(200e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DRIVERS))
def test_cuda_driver_counts_each_plane_up_and_down(card_raster, in_memory, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the drivers' copies are the card's")
    dem, ind_nans = card_raster
    driver, args, _ = DRIVERS[case]
    plane = dem.data.astype(np.float32).nbytes
    before = dict(device.COPIED_BYTES)
    kwargs = dict(args, device="cuda")
    if driver != "compute_sx":
        kwargs["ind_nans"] = ind_nans
    files = getattr(pipeline, driver)(dem, **kwargs)
    up = device.COPIED_BYTES["h2d"] - before["h2d"]
    down = device.COPIED_BYTES["d2h"] - before["d2h"]
    assert down == len(files) * plane == len(in_memory) * plane
    assert plane <= up < 2 * plane  # the DEM, then small tables


@pytest.mark.cuda
def test_cuda_spans_leave_no_device_side_copy(card_raster, in_memory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dem, ind_nans = card_raster
    pipeline.compute_tpi(dem, [300], ind_nans=ind_nans, device="cuda")  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("test:annotated"):
            pipeline.compute_tpi(dem, [300], ind_nans=ind_nans, device="cuda")
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert any(e.name().startswith(PREFIX) for e in events)
    assert not any(e.name().startswith(PREFIX) for e in on_device)
    annotations = [(e.start_ns(), e.end_ns()) for e in on_device if e.is_user_annotation()]
    assert annotations and not set(annotations) & set(device_spans(prof))
