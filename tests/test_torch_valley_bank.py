"""The benchmark cell ``basodino_30m.valley_bank`` on the CPU: its plain
valley/ridge reference, the port against that reference, the check that
decides the cell's ``correct``, its loop, and the valley engine's counters
and spans.

* ``portbench/reference/valley_ridge.py`` against a literal recipe of
  MeteoSwiss/topo-descriptors' topo.py (``scipy.ndimage.gaussian_filter``,
  ``ndimage.rotate``, a ``numpy.ma`` re-standardisation and the 3-D
  ``scipy.signal.convolve(..., mode="same")``), every angle's response
  kept, on a tiny grid;
* the port's ``compute_valley_ridge`` against the reference, both modes
  with the reference script's flats, smoothed and not, on the bank and the
  streamed routes, by the cell's own numbers (``portbench.outputs``);
* three faults planted in the port that the cell's check must refuse;
* the cell's loop at a tiny grid and 1-2 km scales, untraced and traced,
  through a loader local to this file;
* ``ops.valley_ridge.VALLEY_COUNTS`` and the ``valley.*`` spans.

Tolerances:
* reference against the recipe: both float64, the one through FFTs and
  the other through scipy's own convolution: norms within 1e-9 of the
  largest, leads within 1e-9 of the largest lead, and the same angle
  wherever the lead exceeds that;
* port against reference: the cell's numbers (largest gap over the
  kind's largest reference value, RMS gap over its largest RMS; directions
  weighted by the lead) within the cell's own limits, which lie between
  the card's float32 readings and those of the reference computed in TF32
  (the workload file gives each with its reason). On the CPU the port
  reads ~1e-6 and below.
"""

import copy
import importlib
import io

import numpy as np
import pytest
import torch
from scipy import ndimage, signal
from torch.profiler import ProfilerActivity, profile

from portbench import outputs, terrain
from portbench import run as runner
from portbench.reference import valley_ridge as ref_vr
from portbench.reference.descriptors import Reference
from topo_descriptors_tpu_torch import ops, pipeline
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.grid import Raster, RasterGrid, fill_na
from topo_descriptors_tpu_torch.utils.timing import PREFIX, SPANS

tvr = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The reference's 3-D inverse FFTs on the CPU corrupt the heap when
    torch runs them on several intra-op threads (torch 2.13 CPU build: a
    loop of ``irfftn`` over the reference's shapes aborts with "corrupted
    size vs. prev_size" on 8 threads and runs clean on one), so this file
    runs torch on one intra-op thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

FULL_LOAD = runner.load
CELL = "basodino_30m.valley_bank"
FLATS = {"valley": (0, 0.2, 0.4), "ridge": (0, 0.15, 0.3)}  # the reference script's
RECIPE_TOL = 1e-9
LIMITS = FULL_LOAD("workloads", CELL)["limits"]
# a 60 x 80 projected grid of 100 m pixels: 1 km is a 9 px kernel, 2 km 21 px
GRID = {"ny": 60, "nx": 80, "res_m": 100.0, "x0_m": 600000.0, "y0_m": 5100000.0,
        "crs": "epsg:32632"}
SCALES = [1000, 2000]


def _config(grid):
    config = copy.deepcopy(FULL_LOAD("configs", FULL_LOAD("workloads", CELL)["config"]))
    config["grid"] = dict(grid)
    config["voids"]["radii_px"] = [2, 3, 4, 2]
    return config


def _dem(seed, grid=GRID):
    """``(raw DEM with NaN voids, x, y)`` from the seed."""
    return terrain.make_dem(_config(grid), seed, "cpu")


# --- the reference against topo.py's recipe ------------------------------------


def _recipe(z, size, mode, flat_list, sigma):
    """topo.py's valley_ridge as written there, in float64, with every
    angle's flat-maximum response kept: ``(norm, direction, lead)``."""
    if sigma:
        z = ndimage.gaussian_filter(z, sigma)
    z = (z - z.mean()) / z.std()
    dem = np.broadcast_to(z, (len(flat_list), *z.shape))
    kernels = ref_vr.valley_kernels(size, flat_list) * (-1 if mode == "ridge" else 1)
    responses = []
    for angle in range(180):  # float64 angles: float32 ones round scipy's rotation matrix
        rot = ndimage.rotate(kernels, float(angle), axes=(1, 2), reshape=True, order=2,
                             mode="constant", cval=-9999)
        rot = np.ma.masked_array(rot, mask=rot == -9999)
        rot = (rot - np.mean(rot, axis=(1, 2), keepdims=True)) / np.std(rot, axis=(1, 2),
                                                                         keepdims=True)
        responses.append(np.max(signal.convolve(dem, rot.filled(0), mode="same"), axis=0))
    responses = np.stack(responses)
    direction = np.argmax(responses, axis=0)  # the first maximum: strictly greater wins
    top2 = np.sort(responses, axis=0)[-2:]
    return np.clip(top2[1], 0, None), direction.astype(np.float64), top2[1] - top2[0]


def test_recipe_kernels_are_the_ramp_with_flat_bands():
    k = ref_vr.valley_kernels(9, (0, 0.4))
    assert k.shape == (2, 9, 9)
    np.testing.assert_allclose(k.mean(axis=(1, 2)), 0, atol=1e-12)
    np.testing.assert_allclose(k.std(axis=(1, 2)), 1, rtol=1e-12)
    assert np.all(k[0] == k[0][:, :1])  # constant along x
    # flat 0.4 of 9 rows: halfwidth int(floor(1.8) + 0.5) = 1, the middle 3 rows level
    assert len(np.unique(k[1][3:6, 0])) == 1 and len(np.unique(k[1][:, 0])) == 4
    assert len(np.unique(k[0][:, 0])) == 5


@pytest.mark.parametrize("mode, sigma", [("valley", None), ("ridge", 1.5)])
def test_reference_follows_topo_py_recipe(mode, sigma):
    raw, x, y = _dem(2**31 + 21, dict(GRID, ny=24, nx=30))
    r = Reference(raw, x, y, GRID["crs"], "cpu")
    got = ref_vr.compute(r, 7, mode, FLATS[mode], sigma)
    norm, direction, lead = _recipe(r.z.numpy(), 7, mode, FLATS[mode], sigma)
    voids = np.isnan(raw)
    assert voids.any()
    for plane in got.values():
        assert torch.equal(torch.isnan(plane), torch.from_numpy(voids))
    keep = ~voids
    np.testing.assert_allclose(got["norm"].numpy()[keep], norm[keep], rtol=0,
                               atol=RECIPE_TOL * np.abs(norm).max())
    np.testing.assert_allclose(got["lead"].numpy()[keep], lead[keep], rtol=0,
                               atol=RECIPE_TOL * lead.max())
    clear = keep & (lead > RECIPE_TOL * lead.max())
    assert clear[keep].mean() > 0.9
    np.testing.assert_array_equal(got["direction"].numpy()[clear], direction[clear])


def test_reference_caches_per_reference_and_signature():
    raw, x, y = _dem(5, dict(GRID, ny=24, nx=30))
    r = Reference(raw, x, y, GRID["crs"], "cpu")
    a = ref_vr.index(r, 700, "valley", FLATS["valley"], 0.5)
    assert ref_vr.index(r, 700, "valley", [0.0, 0.2, 0.4], 0.5) is a
    assert ref_vr.index(r, 700, "valley", FLATS["valley"], None) is not a
    other = Reference(raw, x, y, GRID["crs"], "cpu", precision="tf32")
    b = ref_vr.index(other, 700, "valley", FLATS["valley"], 0.5)
    assert b is not a and b["norm"].dtype == torch.float64
    assert torch.allclose(b["norm"], b["norm"].float().double(), rtol=0, atol=0, equal_nan=True)


# --- the port against the reference -------------------------------------------


@pytest.fixture(scope="module")
def filled():
    raw, x, y = _dem(2**31 + 45)
    raster = Raster(data=raw, grid=RasterGrid(y=y, x=x, crs=GRID["crs"]), name="DEM", units="m")
    ind_nans, dem = fill_na(raster)
    return raw, x, y, ind_nans, dem


@pytest.fixture
def in_memory(monkeypatch):
    """The drivers' NetCDF writer replaced by one that keeps the planes."""
    planes = []

    def to_netcdf(array, dem, name, crop=None, outdir=".", units=None):
        planes.append((0, str.upper(name), np.asarray(array)))
        return name

    monkeypatch.setattr(pipeline, "to_netcdf", to_netcdf)
    return planes


def _judged(filled, planes, args):
    raw, x, y, _, _ = filled
    by_name = {p.name: p for p in outputs.expected("compute_valley_ridge", args)}
    assert [name for _, name, _ in planes] == list(by_name)
    reference = Reference(raw, x, y, GRID["crs"], "cpu")
    return outputs.judge(by_name, planes, reference, "cpu")[0]


@pytest.mark.parametrize("route", ["bank", "streamed"])
@pytest.mark.parametrize("smth", [0.5, None])
@pytest.mark.parametrize("mode", ["valley", "ridge"])
def test_port_matches_the_reference(filled, in_memory, monkeypatch, mode, smth, route):
    if route == "streamed":  # a budget no bank fits: every scale streams
        monkeypatch.setattr(CFG, "valley_bank_max_bytes", 0)
    before = dict(tvr.VALLEY_COUNTS)
    args = dict(scales=SCALES, mode=mode, flat_list=list(FLATS[mode]), smth_factors=smth)
    pipeline.compute_valley_ridge(filled[4], ind_nans=filled[3], device="cpu", **args)
    assert tvr.VALLEY_COUNTS[f"calls.{route}"] - before[f"calls.{route}"] == len(SCALES)
    numbers = _judged(filled, in_memory, args)
    assert set(numbers) == set(LIMITS)
    assert all(v <= LIMITS[n] for n, v in numbers.items()), numbers


# --- the cell: its loop, and faults its check must refuse -----------------------

TINY = {"ny": 60, "nx": 80, "step_arcsec": 5.0}  # ~107 x 154 m pixels: 1 km 7 px, 2 km 15 px


def _tiny_load(kind, name):
    d = copy.deepcopy(FULL_LOAD(kind, name))
    if kind == "configs":
        d["grid"].update(TINY)
        d["voids"]["radii_px"] = [2, 3, 4, 2]
    elif kind == "workloads":
        for step in d["job"]:
            step.get("args", {}).update(scales=SCALES)
    return d


@pytest.fixture
def tiny(monkeypatch):
    """The harness loads the cell at a tiny grid and 1-2 km."""
    monkeypatch.setattr(runner, "load", _tiny_load)


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu(tiny, traced):
    log = io.StringIO()
    result = runner.run(CELL, 2**31 + 77, 0.2, traced, "cpu", log=log)
    assert result["correct"], log.getvalue()
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["checks"]) == set(runner.load("workloads", CELL)["limits"])
    wanted = {m["name"] for m in runner.cell_metrics(CELL, traced)}
    if traced:  # the CPU trace holds no device events: device metrics stay silent
        assert set(result["metrics"]) == wanted - {"device_idle_share"}
        # valley then ridge at two bank scales against the bank cache's 2 slots
        assert result["metrics"]["valley_builds_per_job"]["value"] == 4.0
        assert result["metrics"]["valley_bank_build_s"]["value"] > 0
    else:
        assert set(result["metrics"]) == wanted


def _turned(valley_ridge, *args, **kwargs):
    norm, direction = valley_ridge(*args, **kwargs)
    return [norm, torch.remainder(direction + 90.0, 180.0)]


def _unsmoothed(valley_ridge, dem, size, mode, flat_list, sigma=None, **kwargs):
    return valley_ridge(dem, size, mode, flat_list, None, **kwargs)


def _flat_dropped(valley_ridge, dem, size, mode, flat_list, *args, **kwargs):
    return valley_ridge(dem, size, mode, flat_list[:-1], *args, **kwargs)


@pytest.mark.parametrize("fault, number", [(_turned, "vr_dir_max"),
                                           (_unsmoothed, "vr_norm_max"),
                                           (_flat_dropped, "vr_norm_max")],
                         ids=["dir_turned_90", "no_pre_smooth", "flat_dropped"])
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, fault, number):
    original = ops.valley_ridge
    monkeypatch.setattr(ops, "valley_ridge", lambda *a, **k: fault(original, *a, **k))
    result = runner.run(CELL, 2**31 + 11, 0.2, False, "cpu", log=io.StringIO())
    assert not result["correct"] and result["failed"] > 0
    check = result["checks"][number]
    assert check["value"] > check["limit"], result["checks"]


# --- the valley engine's counters and spans --------------------------------------


def _ranges(prof):
    return [e.name()[len(PREFIX):] for e in prof.profiler.kineto_results.events()
            if e.name().startswith(PREFIX) and e.device_type() == torch.autograd.DeviceType.CPU]


def test_a_job_counts_its_builds_and_opens_its_spans(filled, in_memory, monkeypatch):
    """Valley then ridge at three bank scales and one streamed scale: the
    2-slot bank cache misses on every bank call (6 builds a job); the two
    canvas stacks are built once, then found."""
    monkeypatch.setattr(tvr, "_BANK_DEV_CACHE", {})
    monkeypatch.setattr(tvr, "_CANVAS_DEV_CACHE", {})
    monkeypatch.setattr(CFG, "valley_bank_max_bytes", tvr.bank_nbytes(9, 3))
    dem, ind_nans = filled[4], filled[3]

    def job():
        for mode in ("valley", "ridge"):  # 5, 7 and 9 px on the bank route, 11 px streamed
            pipeline.compute_valley_ridge(dem, [500, 700, 900, 1100], mode, FLATS[mode],
                                          smth_factors=0.5, ind_nans=ind_nans, device="cpu")

    counts = []
    for _ in range(2):
        before = dict(tvr.VALLEY_COUNTS)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            job()
        counts.append(({k: v - before[k] for k, v in tvr.VALLEY_COUNTS.items()}, _ranges(prof)))
    (cold, cold_spans), (warm, warm_spans) = counts
    assert cold["builds.bank"] == warm["builds.bank"] == 6
    assert (cold["builds.canvas"], warm["builds.canvas"]) == (2, 0)
    assert warm["calls.bank"] == 6 and warm["calls.streamed"] == 2
    assert warm["bank_build_s"] > 0
    assert cold_spans.count("valley.canvas") == 2 and "valley.canvas" not in warm_spans
    assert warm_spans.count("valley.bank") == 6 and warm_spans.count("valley.scan") == 8
    assert {"valley.bank", "valley.canvas", "valley.scan"} <= set(SPANS)

    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch._C._autograd._profiler_enabled()
    job()
