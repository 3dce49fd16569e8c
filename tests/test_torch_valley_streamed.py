"""The benchmark cell ``basodino_30m.valley_streamed`` on the CPU: the
port's streamed valley/ridge route against the plain float64 reference
(``portbench/reference/valley_ridge.py``) by the cell's own limits, the two
stages that the float64 judge found wrong at 60-100 km, the cell's loop,
its work model and metrics, and a fault its check refuses.

* the streamed route, both modes, on a coarse geographic grid where the
  larger kernel is wider than 2H - 1 and 2W - 1 (as the 60 and 100 km
  kernels are on the 900 x 1440 grid), smoothed at ``smth_factors`` 0.5;
* the field's pre-smooth and standardisation against scipy's float64
  recipe at the 100 km scale's ratio of sigma to the grid (~0.53 of the
  rows): the smoothed field spreads by tens of metres about ~1800 m, where
  float32 left ~1e-5 of the largest standardised value;
* the streamed route's rotation at 153 px (C10's odd size) at 34, 56, 124
  and 146 degrees, against ``scipy.ndimage.rotate``: the support equal,
  values within float32 rounding (the port) or within 1e-12 (the
  reference);
* the cell's loop at a tiny grid, untraced and traced, with the valley
  engine's counters' exact values over the run;
* one planted fault that the cell's check refuses.

Tolerances: the cell's numbers (``portbench.outputs``) within the cell's
own limits, which lie between the card's readings and those of the
reference computed in TF32 (the workload file gives each with its reason);
the standardised field within 1e-6 of its largest value (float32 output
rounds at ~2.4e-7 of it); rotated values within 2e-6 of the kernel's
largest (float32 spline arithmetic), as ``test_torch_valley_ridge.py``
holds the device bank.
"""

import copy
import importlib
import io

import numpy as np
import pytest
import torch
from scipy import ndimage

from portbench import outputs, terrain, valley_work, work
from portbench import run as runner
from portbench import trace as pb_trace
from portbench.reference import valley_ridge as ref_vr
from portbench.reference.descriptors import Reference
from topo_descriptors_tpu_torch import pipeline
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.grid import Raster, RasterGrid, fill_na
from topo_descriptors_tpu_torch.kernels.valley import rotated_extent, valley_kernels

tvr = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")
trot = importlib.import_module("topo_descriptors_tpu_torch.ops.spline_rotate")

FULL_LOAD = runner.load
CELL = "basodino_30m.valley_streamed"
LIMITS = FULL_LOAD("workloads", CELL)["limits"]
FLATS = {"valley": (0, 0.2, 0.4), "ridge": (0, 0.15, 0.3)}  # the reference script's
# ~107 x 154 m pixels: 10 km is a 77 px kernel, 25 km 193 px, wider than
# 2H - 1 = 119 and 2W - 1 = 159
TINY = {"ny": 60, "nx": 80, "step_arcsec": 5.0}
SCALES = [10000, 25000]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The float64 reference's inverse FFTs on the CPU, as in
    ``test_torch_valley_bank.py`` (C11): one intra-op thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


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
def streamed(monkeypatch):
    """Every scale of the tiny grid on the streamed route (no bank fits),
    both canvas caches empty."""
    monkeypatch.setattr(CFG, "valley_bank_max_bytes", 0)
    monkeypatch.setattr(tvr, "_CANVAS_DEV_CACHE", {})


# --- the streamed route against the reference -----------------------------------


@pytest.fixture(scope="module")
def filled():
    config = _tiny_load("configs", FULL_LOAD("workloads", CELL)["config"])
    raw, x, y = terrain.make_dem(config, 2**31 + 245, "cpu")
    crs = config["grid"]["crs"]
    ind_nans, dem = fill_na(Raster(data=raw, grid=RasterGrid(y=y, x=x, crs=crs), name="DEM",
                                   units="m"))
    return raw, x, y, crs, ind_nans, dem


@pytest.mark.parametrize("mode", ["valley", "ridge"])
def test_streamed_route_matches_the_reference(filled, streamed, monkeypatch, mode):
    raw, x, y, crs, ind_nans, dem = filled
    planes = []

    def to_netcdf(array, dem, name, crop=None, outdir=".", units=None):
        planes.append((0, str.upper(name), np.asarray(array)))
        return name

    monkeypatch.setattr(pipeline, "to_netcdf", to_netcdf)
    before = dict(tvr.VALLEY_COUNTS)
    args = dict(scales=SCALES, mode=mode, flat_list=list(FLATS[mode]), smth_factors=0.5)
    pipeline.compute_valley_ridge(dem, ind_nans=ind_nans, device="cpu", **args)
    assert tvr.VALLEY_COUNTS["calls.streamed"] - before["calls.streamed"] == len(SCALES)
    sizes = [int(s) for s in Reference(raw, x, y, crs).pixels(SCALES)]
    assert sizes[-1] > 2 * TINY["nx"] - 1, sizes  # the crop case of the reference
    by_name = {p.name: p for p in outputs.expected("compute_valley_ridge", args)}
    assert [name for _, name, _ in planes] == list(by_name)
    numbers = outputs.judge(by_name, planes, Reference(raw, x, y, crs, "cpu"), "cpu")[0]
    assert set(numbers) == set(LIMITS)
    assert all(v <= LIMITS[n] for n, v in numbers.items()), numbers


# --- the two stages the float64 judge found wrong ---------------------------------


def test_the_field_is_standardized_in_float64():
    """At the 100 km scale's ratio of sigma to the grid the float32 pre-smooth
    and standardisation left ~1.2e-5 of the largest value here (~6.6e-5 on
    the 900 x 1440 grid); the float64 pass leaves float32's output rounding."""
    config = FULL_LOAD("configs", "basodino_30m_valley_10_100km")
    config["grid"].update(ny=90, nx=144, step_arcsec=10.0)
    config["voids"]["radii_px"] = [2, 3, 4, 2]
    raw, _, _ = terrain.make_dem(config, 2**31 + 5, "cpu")
    dem = np.where(np.isnan(raw), 1800.0, raw).astype(np.float32)
    sigma = 0.53 * dem.shape[0]
    smooth = ndimage.gaussian_filter(dem.astype(np.float64), sigma)
    assert smooth.std() < 0.05 * smooth.mean()  # a spread of tens of metres on ~1800 m
    want = (smooth - smooth.mean()) / smooth.std()
    got = tvr._standardized(torch.from_numpy(dem), sigma, None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


ODD_ANGLES = (34, 56, 124, 146)  # quadrant angle 34 and its three variants


def _scipy_canvas(stack, angle, kmax):
    """``ndimage.rotate`` of the stack at ``angle``, as (mask, values) on the
    streamed route's square canvas at the 'same' anchor."""
    rot = ndimage.rotate(stack, float(angle), axes=(1, 2), reshape=True, order=2,
                         mode="constant", cval=ref_vr.CVAL)
    _, ky, kx = rot.shape
    lo_y, lo_x = (kmax - 1) // 2 - (ky - 1) // 2, (kmax - 1) // 2 - (kx - 1) // 2
    canvas = np.full((stack.shape[0], kmax, kmax), ref_vr.CVAL)
    canvas[:, lo_y:lo_y + ky, lo_x:lo_x + kx] = rot
    return canvas != ref_vr.CVAL, canvas


def test_streamed_rotation_at_153_px_has_scipys_support():
    """C10: with float32 coordinates the quadrant canvas of 34 degrees, and
    so its variants at 56, 124 and 146, put an edge pixel of the 153 px
    kernel on the other side of scipy's support test."""
    size, flats = 153, FLATS["ridge"]
    base = valley_kernels(size, flats).astype(np.float64)
    kmax, qparams = tvr.streamed_schedule(size)[:2]
    table = tvr._rotation_table(size, "valley", flats, "cpu")
    q = int(np.flatnonzero(trot.quadrant_schedule()[0] == 34)[0])
    canvas = trot.rotate_std_canvas_table(table, size, qparams[q:q + 1], (kmax, kmax))[0]
    variants = dict(zip((34, 124, 146, 56), trot.canvas_variants(canvas, qparams[q])))
    for angle in ODD_ANGLES:
        mask, want = _scipy_canvas(base, angle, kmax)
        got = variants[angle].double().numpy()
        np.testing.assert_array_equal(got != 0, mask, err_msg=f"angle {angle}")
        m = mask[0]
        std = np.stack([(w[m] - w[m].mean()) / w[m].std() for w in want])
        np.testing.assert_allclose(got[:, m], std, rtol=0, atol=2e-6 * np.abs(std).max(),
                                   err_msg=f"angle {angle}")


@pytest.mark.parametrize("mode", ["valley", "ridge"])
def test_reference_rotation_at_153_px_is_scipys(mode):
    """The float64 judge's own rotation at C10's angles (the tier-1 copy of
    ``portbench/tests/test_pb_valley_reference.py``'s 153 px case)."""
    stack = ref_vr.valley_kernels(153, FLATS[mode]) * {"valley": 1.0, "ridge": -1.0}[mode]
    coefficients = ref_vr.spline_coefficients(torch.from_numpy(stack))
    for angle in ODD_ANGLES:
        want = ndimage.rotate(stack, float(angle), axes=(1, 2), reshape=True, order=2,
                              mode="constant", cval=ref_vr.CVAL)
        got = ref_vr.rotated(coefficients, float(angle)).numpy()
        outside = want == ref_vr.CVAL
        np.testing.assert_array_equal(got == ref_vr.CVAL, outside, err_msg=f"angle {angle}")
        np.testing.assert_allclose(got[~outside], want[~outside], rtol=0,
                                   atol=1e-12 * np.abs(stack).max(), err_msg=f"angle {angle}")


# --- the work model ------------------------------------------------------------------


@pytest.mark.parametrize("size", [9, 153, 383, 3831])
def test_the_work_models_rotated_side_is_the_ports(size):
    for angle in (0, 1, 34, 45, 89, 90, 146):
        assert valley_work.rotated_side(size, angle) == rotated_extent(size, [angle])[0]


def test_the_100km_call_is_about_three_quarters_of_a_teraflop():
    """One 100 km plane pair on 900 x 1440: every angle's kernel covers the
    (2H - 1) x (2W - 1) taps, N = 2698 x 4318 points, three flats."""
    ops, nbytes = valley_work.call_work(900, 1440, 3831, 3)
    n = 2698 * 4318
    per = 2 * 2.5 * n * np.log2(n) + 3 * n
    assert ops == pytest.approx(180 * 3 * per + 2.5 * n * np.log2(n), rel=1e-12)
    assert 0.75e12 < ops < 0.77e12 and nbytes == 4 * 900 * 1440 * 3


# --- the cell: its loop, its metrics, and a fault its check refuses -------------------


@pytest.fixture
def tiny(monkeypatch, streamed):
    """The harness loads the cell at the tiny grid; the canvas budget keeps
    the 10 km stack cached and rotates the 25 km one inline."""
    monkeypatch.setattr(runner, "load", _tiny_load)
    budget = len(tvr.streamed_schedule(77)[1]) * 3 * max(rotated_extent(77)) ** 2 * 4
    monkeypatch.setattr(CFG, "valley_canvas_cache_bytes", budget)


def _counted(fn):
    before = dict(tvr.VALLEY_COUNTS)
    result = fn()
    return result, {k: v - before[k] for k, v in tvr.VALLEY_COUNTS.items()}


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu(tiny, traced):
    log = io.StringIO()
    result, counts = _counted(lambda: runner.run(CELL, 2**31 + 177, 0.2, traced, "cpu", log=log))
    assert result["correct"], log.getvalue()
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["checks"]) == set(LIMITS)
    jobs = result["attempted"] // 2 + 1  # the window's and the warm job
    per_call = len(tvr.streamed_schedule(193)[1])  # 46 quadrant angles padded to 48
    # each job: valley and ridge at 10 km (stacks cached after the warm job)
    # and at 25 km (rotated inline in every call)
    assert counts["calls.streamed"] == 4 * jobs and counts["calls.bank"] == 0
    assert counts["conv.mm"] + counts["conv.fft"] == 4 * jobs
    assert counts["builds.canvas"] == 2 + 2 * jobs
    assert counts["rotations.canvas"] == 2 * per_call + 2 * per_call * jobs
    wanted = {m["name"] for m in runner.cell_metrics(CELL, traced)}
    if traced:  # the CPU trace holds no device events: device metrics stay silent
        assert set(result["metrics"]) == wanted - {"device_idle_share", "valley_calls_roofline"}
        assert result["metrics"]["valley_rotations_per_job"]["value"] == 2 * per_call
    else:
        assert set(result["metrics"]) == wanted


def test_the_roofline_reads_the_valley_calls_kernels():
    """``valley_calls_roofline`` on a trace whose only kernels inside the
    valley calls' spans are known: the work model's least time over their
    union, in percent; a kernel outside those spans, and a copy, are not
    counted."""
    workload = _tiny_load("workloads", CELL)
    config = _tiny_load("configs", workload["config"])
    _, x, y = terrain.make_dem(config, 2**31 + 178, "cpu")
    run = runner.Run(workload, config, (TINY["ny"], TINY["nx"]), x, y, steps_per_job=2)
    run.calls = [runner.Call(i, s["call"], s["args"]) for i, s in enumerate(workload["job"])]
    least = valley_work.least_seconds(run)
    sizes = Reference(np.zeros((TINY["ny"], TINY["nx"]), np.float32), x, y,
                      config["grid"]["crs"]).pixels(SCALES)
    per_call = sum(work.least_seconds(*valley_work.call_work(
        TINY["ny"], TINY["nx"], int(px), 3)) for px in sizes)
    assert least == pytest.approx(2 * per_call, rel=1e-12) and least > 0
    reader = runner.metric_module("valley_calls_roofline")
    assert reader.read(run) is None  # no trace
    spans = [(0, 10**9, pb_trace.WINDOW),
             (100, 2 * 10**6, f"{pb_trace.SPAN}compute_valley_ridge #0"),
             (3 * 10**6, 5 * 10**6, f"{pb_trace.SPAN}compute_valley_ridge #1")]
    device = [pb_trace.DeviceEvent("fft", 1000, 10**6 + 1000),  # 1 ms
              pb_trace.DeviceEvent("gemm", 10**6, 1500 * 10**3 + 1000),  # 0.5 ms more
              pb_trace.DeviceEvent("fft", 3 * 10**6, 4 * 10**6),  # 1 ms
              pb_trace.DeviceEvent("outside", 6 * 10**6, 9 * 10**6),
              pb_trace.DeviceEvent("Memcpy HtoD", 3 * 10**6, 4500 * 10**3)]
    run.trace = pb_trace.Trace((0, 10**9), device, spans)
    assert reader.read(run) == pytest.approx(100 * least / 2.5e-3, rel=1e-9)


def test_a_canvas_left_unturned_is_not_correct(tiny, monkeypatch):
    """The three other quadrants take the base angle's canvas unflipped: the
    directions of most pixels and the norms go wrong."""
    monkeypatch.setattr(tvr, "canvas_variants", lambda canvas, params: (canvas,) * 4)
    result = runner.run(CELL, 2**31 + 11, 0.2, False, "cpu", log=io.StringIO())
    assert not result["correct"] and result["failed"] > 0
    for number in ("vr_norm_max", "vr_dir_max"):
        check = result["checks"][number]
        assert check["value"] > check["limit"], result["checks"]
