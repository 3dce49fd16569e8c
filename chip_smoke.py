#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines:
1. check the card (name, and power limit from nvidia-smi);
2. build the hand-written kernels from ``topo_descriptors_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch twin on the card, at the
   Basodino-sized grid (900 x 1440) and at 8192 x 8192; the Sx sweep and
   fan kernels also against per-azimuth ``sx_block``, bit for bit;
4. run the port's drivers on the card (TPI fused and smoothed, TPI+STD,
   Sx at 500 m and 2000 m, the 36-azimuth Sx sweep at 2000 m and 200 m)
   and ``ops.sx_sweep`` with the sweep kernel that ``auto`` does not pick,
   check that every kernel was launched, and compare every output with
   the same calls run on the plain twins;
5. time each kernel against its twin (CUDA events, median of 20; a twin
   that takes over a second per call, median of 3);
6. run the third slice on the 900 x 1440 grid with NaN holes, at the
   reference's scales: ``compute_dem``, ``compute_gradient`` (both checked
   against the same drivers on the CPU), ``compute_valley_ridge`` in valley
   mode at 2 km (the bank route) and 20 km (the streamed route) and in
   ridge mode at 2 km, and ``TerrainSuite.forward`` (which must launch the
   disk and Sx kernels; its Sx must equal ``pipeline.sx``); check the
   valley/ridge routes against each other on the card and, on a 90 x 144
   crop, against the scipy recipe and the CPU; time the new ops and
   drivers;
7. print the kernels' JSON line, then the result line.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before it imports the port. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)
SX_ATOL = 2e-5  # degrees: kernel and twin share the ratios; atan may differ by ~1 ulp of 90
TIMING_REPS = 20
SWEEP_AZIMUTHS = tuple(range(0, 360, 10))  # BASELINE.json configs[3]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to test",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    print(smi_line)
    return name, smi_line


def build():
    from topo_descriptors_tpu_torch.ops.cuda import _build

    start = time.perf_counter()
    _build.library()
    print(f"[build] {_build.library_path().name} ready in "
          f"{time.perf_counter() - start:.2f} s (nvcc: {_build.build_seconds} s)")


# --- phase 3: kernels against their twins ------------------------------------


def disk_cases(dem: torch.Tensor):
    """(name, fields, kernel, pads) as the main path feeds the kernel: the
    mean-centred DEM (TPI) and the STD moment stack (z-c, t-c, (t-c)^2)."""
    from topo_descriptors_tpu_torch.host import circular_kernel
    from topo_descriptors_tpu_torch.ops.conv import _same_pads

    z = dem - torch.round(dem.mean())
    t = torch.trunc(dem) - torch.round(dem.mean())
    moments = torch.stack([z, t, t * t]).contiguous()
    even = np.ones((4, 6), np.float32)
    even[1, 2] = 0.0

    def same(k):
        return (_same_pads(k.shape[0]), _same_pads(k.shape[1]))

    tpi67 = circular_kernel(67, exclude_center=True)
    disk17 = circular_kernel(17)
    return [
        ("tpi_disk67_b1", z[None].contiguous(), tpi67, same(tpi67)),
        ("disk17_b3", moments, disk17, same(disk17)),
        ("even4x6_b1", z[None].contiguous(), even, same(even)),
        ("disk17_b3_valid", moments, disk17, ((0, 0), (0, 0))),
    ]


def check_disk(name, xs, kernel, pads, grid):
    """Two checks. On integer fields whose row sums stay below 2^24 every
    prefix sum is exact in float32, so kernel and twin (which sum the rows
    in the same order) must agree bit for bit. On the real fields the two
    scan orders differ; a tree scan's error is at most log2(n) eps
    sum|x| per prefix value, and an output reads 2 x runs of them."""
    from topo_descriptors_tpu_torch.ops.conv import _binary_kernel_runs
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat

    runs = _binary_kernel_runs(kernel[::-1, ::-1])
    row_sums = xs.abs().sum(dim=-1).amax(dim=-1)  # per field
    pmax = float(row_sums.max())
    scale = torch.clamp(torch.ceil(row_sums / 2**23), min=1.0)[:, None, None]
    xi = torch.round(xs / scale).contiguous()
    out_i = disk_sat.disk_conv_sat(xi, kernel.shape, runs, pads)
    torch.cuda.synchronize()
    check(torch.equal(out_i, disk_sat.disk_conv_sat_plain(xi, kernel.shape, runs, pads)),
          f"disk_sat {name} {grid}: integer fields not bit-equal to the twin")

    out = disk_sat.disk_conv_sat(xs, kernel.shape, runs, pads)
    torch.cuda.synchronize()
    ref = disk_sat.disk_conv_sat_plain(xs, kernel.shape, runs, pads)
    err = float((out - ref).abs().max())
    wq = xs.shape[2] + pads[1][0] + pads[1][1] + 1
    tol = 2 * len(runs) * math.ceil(math.log2(wq)) * EPS32 * pmax
    print(f"[parity] disk_sat {name} {grid} B={xs.shape[0]}: integer fields bit-equal; "
          f"max|kernel-twin| {err:.6g} (|out| <= {float(ref.abs().max()):.6g}, tol {tol:.6g})")
    check(err <= tol, f"disk_sat {name} {grid}: {err} > {tol}")
    return err


def sx_cases():
    from topo_descriptors_tpu_torch.host import sx_dedupe, sx_offsets

    cases = [("r500_az0", 0.0, 500.0, 0.0), ("r2000_az0", 0.0, 2000.0, 0.0),
             ("r250_az225_distance0", 225.0, 250.0, 0.0),
             ("r500_az0_radius_min100", 0.0, 500.0, 100.0)]
    for name, az, radius, rmin in cases:
        o, d, b = sx_offsets(az, radius, 30.0, 30.0, radius_min=rmin)
        o, d = sx_dedupe(o, d)
        yield name, o, d, b


def check_sx(name, dem, o, d, b, grid):
    from topo_descriptors_tpu_torch.ops.cuda import sx_block

    out = sx_block.sx_block(dem, o, d, b, 10.0)
    torch.cuda.synchronize()
    ref = sx_block.sx_block_plain(dem, o, d, b, 10.0)
    check(torch.equal(torch.isnan(out), torch.isnan(ref)),
          f"sx_block {name} {grid}: NaN positions differ")
    err = float(torch.nan_to_num(out - ref).abs().max())
    print(f"[parity] sx_block {name} {grid} K={len(o)} border={b}: "
          f"max|kernel-twin| {err:.6g} deg (tol {SX_ATOL}), NaN positions equal")
    check(err <= SX_ATOL, f"sx_block {name} {grid}: {err} > {SX_ATOL}")
    return err


def sweep_cases(grid):
    """(name, offsets, distances, border) of the deduplicated fans checked
    on ``grid``: the 36-azimuth sweep at both radii of BASELINE.json
    configs[3], a ragged radius_min fan and the distance-0 fan at 900x1440;
    the 36-azimuth sweep at 500 m at 8192x8192."""
    from topo_descriptors_tpu_torch.host import sx_sweep_dedupe, sx_sweep_offsets

    if grid == "8192x8192":
        cases = [("36az_r500", SWEEP_AZIMUTHS, 500.0, 0.0)]
    else:
        cases = [("36az_r200", SWEEP_AZIMUTHS, 200.0, 0.0),
                 ("36az_r2000", SWEEP_AZIMUTHS, 2000.0, 0.0),
                 ("r300_radius_min100", (10, 200, 355), 300.0, 100.0),
                 ("r250_distance0", (225, 45), 250.0, 0.0)]
    for name, azimuths, radius, rmin in cases:
        o, d, b = sx_sweep_offsets(azimuths, radius, 30.0, 30.0, radius_min=rmin)
        o, d = sx_sweep_dedupe(o, d)
        yield name, o, d, b


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_sweep(name, dem, o, d, b, grid):
    """Both fan kernels against the twin, plane by plane (the (36, 8192,
    8192) stacks are 9.7 GB each), and bit for bit against sx_block on the
    azimuth's table: the three kernels share the per-pixel code and the
    1/distance groups."""
    from topo_descriptors_tpu_torch.ops.cuda import sx_block, sx_sweep

    outs = {"sx_sweep": sx_sweep.sx_sweep(dem, o, d, b, 10.0),
            "sx_fan": sx_sweep.sx_fan(dem, o, d, b, 10.0)}
    torch.cuda.synchronize()
    errs = dict.fromkeys(outs, 0.0)
    for a in range(len(o)):
        ref = sx_sweep.sx_sweep_plain(dem, o[a : a + 1], d[a : a + 1], b, 10.0)[0]
        one = sx_block.sx_block(dem, o[a], d[a], b, 10.0)  # pad rows: NaN, dropped
        for kernel, out in outs.items():
            check(torch.equal(torch.isnan(out[a]), torch.isnan(ref)),
                  f"{kernel} {name} {grid} azimuth {a}: NaN positions differ")
            errs[kernel] = max(errs[kernel], float(torch.nan_to_num(out[a] - ref).abs().max()))
            check(same_bits(out[a], one),
                  f"{kernel} {name} {grid} azimuth {a}: not bit-equal to sx_block")
    n_rays = int((~np.isnan(d)).sum())
    print(f"[parity] sx_sweep/sx_fan {name} {grid} A={len(o)} rays={n_rays} border={b}: "
          f"max|kernel-twin| {errs['sx_sweep']:.6g} / {errs['sx_fan']:.6g} deg "
          f"(tol {SX_ATOL}), NaN positions equal, every plane bit-equal to sx_block")
    for kernel, err in errs.items():
        check(err <= SX_ATOL, f"{kernel} {name} {grid}: {err} > {SX_ATOL}")
    return errs


# --- phase 4: the drivers ----------------------------------------------------


@contextlib.contextmanager
def plain_twins():
    """Route the ops through the kernels' plain twins, for the reference
    run only: the package itself never sends a CUDA tensor to a twin."""
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat, sx_block, sx_sweep

    saved = disk_sat.disk_conv_sat, sx_block.sx_block, sx_sweep.sx_sweep, sx_sweep.sx_fan
    disk_sat.disk_conv_sat = disk_sat.disk_conv_sat_plain
    sx_block.sx_block = sx_block.sx_block_plain
    sx_sweep.sx_sweep = sx_sweep.sx_fan = sx_sweep.sx_sweep_plain
    try:
        yield
    finally:
        disk_sat.disk_conv_sat, sx_block.sx_block, sx_sweep.sx_sweep, sx_sweep.sx_fan = saved


@contextlib.contextmanager
def memory_writer(store):
    """Keep the drivers' outputs in ``store`` instead of NetCDF files (the
    shared writer needs h5py); the descriptors still run on the card."""
    from topo_descriptors_tpu_torch import pipeline
    from topo_descriptors_tpu_torch.host import Raster

    def to_netcdf(array, dem, name, crop=None, outdir=".", units=None):
        name = str.upper(name)
        raster = Raster(data=np.asarray(array), grid=dem.grid, name=name,
                        units=units, attrs=dict(dem.attrs))
        store[f"{Path(outdir).name}/{name}"] = raster.crop(crop)
        return Path(outdir) / f"topo_{name}.nc"

    saved = pipeline.to_netcdf
    pipeline.to_netcdf = to_netcdf
    try:
        yield
    finally:
        pipeline.to_netcdf = saved


def main_path_calls(ind_nans):
    """The driver calls of phase 4 (TPI/STD and Sx on the disk and Sx
    kernels), as ``(driver name, kwargs)``."""
    return [
        ("compute_tpi", dict(scales=[500, 2000], ind_nans=ind_nans)),  # fused
        ("compute_tpi", dict(scales=[2000], smth_factors=0.5, ind_nans=ind_nans)),
        ("compute_tpi_std", dict(scales=[500, 2000], ind_nans=ind_nans)),
        ("compute_sx", dict(azimuth=0, radius=500)),
        ("compute_sx", dict(azimuth=0, radius=2000)),
        ("compute_sx_sweep", dict(azimuths=SWEEP_AZIMUTHS, radius=2000)),
        ("compute_sx_sweep", dict(azimuths=SWEEP_AZIMUTHS, radius=200)),
    ]


def run_drivers(dem, calls, use_h5py, device="cuda", prefix="call"):
    """All outputs of ``calls`` on ``device``, keyed ``"<prefix><i>/<variable>"``
    (each driver call writes to its own directory), and each call's wall
    time in seconds (the drivers return host arrays, so the clock reads a
    finished call)."""
    from topo_descriptors_tpu_torch import pipeline
    from topo_descriptors_tpu_torch.host import read_raster

    store, walls = {}, []
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        if not use_h5py:
            stack.enter_context(memory_writer(store))
        files = []
        for i, (driver, kwargs) in enumerate(calls):
            start = time.perf_counter()
            files += getattr(pipeline, driver)(dem, outdir=Path(tmp) / f"{prefix}{i}",
                                               device=device, **kwargs)
            walls.append(time.perf_counter() - start)
        if use_h5py:
            for f in files:
                r = read_raster(f)
                store[f"{f.parent.name}/{r.name}"] = r
    return store, walls


def compare_outputs(main, ref, shape):
    """TPI: 1e-2 m (prefix sums of 1440-column rows, ulp <= 0.25, 2 x 68
    reads, over the 3408-tap sum). STD, compared as variance: 25 m^2 (the
    three moment convolutions each carry such errors, and the centring
    constant c ~ 1800 m multiplies the two linear ones). Sx: 2e-5 deg.
    One line per (call, descriptor) with the largest error of its outputs."""
    n_out = 9 + 2 * len(SWEEP_AZIMUTHS)
    check(sorted(main) == sorted(ref) and len(main) == n_out, f"outputs {sorted(main)}")
    worst = {}
    for name in sorted(main):
        a, b = main[name].data, ref[name].data
        check(a.shape == shape and a.dtype == np.float32, f"{name}: {a.shape} {a.dtype}")
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{name}: NaN positions differ")
        call, var = name.split("/")
        kind = var.split("_")[0]
        if kind == "STD":
            a, b, tol, unit = a.astype(np.float64) ** 2, b.astype(np.float64) ** 2, 25.0, "m^2"
        else:
            tol, unit = (1e-2, "m") if kind == "TPI" else (SX_ATOL, "deg")
        err = float(np.nanmax(np.abs(a - b)))
        check(np.isfinite(np.nanmax(np.abs(a))), f"{name}: no finite values")
        check(err <= tol, f"{name}: {err} > {tol}")
        key = (call, var if kind != "SX" else "SX")
        n, e, _, _ = worst.get(key, (0, 0.0, tol, unit))
        worst[key] = (n + 1, max(e, err), tol, unit)
    for (call, var), (n, err, tol, unit) in sorted(worst.items()):
        print(f"[drivers] {call}/{var} ({n} output{'s' * (n > 1)}, {shape}): "
              f"max|cuda-twins| {err:.6g} {unit} (tol {tol})")


def other_sweep_call(dem_ds, dem):
    """``ops.sx_sweep`` on the 36-azimuth 200 m fan of ``dem_ds`` (``dem``
    on the card) with the fan kernel that ``auto`` does not pick, so the
    driven run reaches both. The geometry is the driver's: the grid's
    signed metric resolutions."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import sx_sweep_offsets
    from topo_descriptors_tpu_torch.ops.sx import _sweep_auto_method

    method = {"pallas_fan": "pallas_sweep", "pallas_sweep": "pallas_fan"}[_sweep_auto_method(dem)]
    res = dem_ds.grid.resolution_meters()
    o, d, b = sx_sweep_offsets(SWEEP_AZIMUTHS, 200.0, float(res["x"].mean()),
                               float(res["y"].mean()))
    return method, ops.sx_sweep(dem, o, d, b, method=method, device=dem.device)


def check_sweep_drivers(dem_ds, main_out, other_out):
    """Plane a of each driver sweep equals compute_sx's Sx at azimuth a on
    the card, and the other fan kernel's planes equal the driver's, bit for
    bit (the same per-pixel code and groups)."""
    from topo_descriptors_tpu_torch import pipeline

    for call, radius in (("call5", 2000), ("call6", 200)):
        for az in (0, 130, 270):
            plane = main_out[f"{call}/SX_RADIUS{radius}_AZIMUTH{az}"].data
            single = pipeline.sx(dem_ds, azimuth=az, radius=radius)
            check(np.array_equal(plane.view(np.int32), single.view(np.int32)),
                  f"compute_sx_sweep r={radius} azimuth {az} differs from compute_sx")
    other = other_out.cpu().numpy()
    for a, az in enumerate(SWEEP_AZIMUTHS):
        plane = main_out[f"call6/SX_RADIUS200_AZIMUTH{az}"].data
        check(np.array_equal(plane.view(np.int32), other[a].view(np.int32)),
              f"the two fan kernels differ at azimuth {az}")
    print("[drivers] compute_sx_sweep planes bit-equal to compute_sx at azimuths 0, 130, 270 "
          "(r = 2000 m and 200 m) and to the other fan kernel at all 36 azimuths (r = 200 m)")


def check_against_recipes(dem_np):
    """TPI and Sx on the card against the reference's recipes in float64 on
    a small crop: ``scipy.signal.convolve`` for TPI, the per-pixel ray loop
    with ``nanmax`` for Sx (the oracles of tests/oracles.py, with the
    tolerances of tests/test_ops.py)."""
    from scipy import signal

    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import circular_kernel, sx_offsets

    dem64 = dem_np.astype(np.float64)
    k = circular_kernel(17, exclude_center=True).astype(np.float64)
    tpi_ref = dem64 - signal.convolve(dem64, k, mode="same") / k.sum()
    tpi = ops.tpi(dem_np, 17).cpu().numpy()
    o, d, b = sx_offsets(0.0, 500.0, 30.0, 30.0)
    sx_ref = np.zeros_like(dem64)
    ny, nx = dem_np.shape
    for j in range(b, ny - b):
        for i in range(b, nx - b):
            z = dem64[j + o[:, 0], i + o[:, 1]] - (dem64[j, i] + 10.0)
            sx_ref[j, i] = np.rad2deg(np.nanmax(np.arctan(z / d)))
    sx = ops.sx(dem_np, o, d, b).cpu().numpy()
    for label, out, ref in (("TPI 17 px", tpi, tpi_ref), ("Sx 500 m", sx, sx_ref)):
        err = float(np.abs(out - ref).max())
        print(f"[recipes] {label} on {dem_np.shape}: max|cuda-scipy/numpy| {err:.6g}")
        check(np.allclose(out, ref, rtol=1e-4, atol=2e-2 if label.startswith("TPI") else 1e-3),
              f"{label}: the card disagrees with the reference recipe")


# --- phase 5: timing -----------------------------------------------------------


def median_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_kernels(grids, smi_line):
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import circular_kernel, sx_dedupe, sx_offsets
    from topo_descriptors_tpu_torch.ops.conv import _binary_kernel_runs, _same_pads
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat, sx_block

    tpi67 = circular_kernel(67, exclude_center=True)
    runs = _binary_kernel_runs(tpi67[::-1, ::-1])
    pads = (_same_pads(67), _same_pads(67))
    o, d, b = sx_offsets(0.0, 500.0, 30.0, 30.0)
    o, d = sx_dedupe(o, d)
    times = {}
    for grid, dem in grids.items():
        mpix = dem.numel() / 1e6
        z = (dem - torch.round(dem.mean()))[None].contiguous()
        rows = [
            ("disk_sat", "TPI-2000m conv", lambda: disk_sat.disk_conv_sat(z, (67, 67), runs, pads),
             lambda: disk_sat.disk_conv_sat_plain(z, (67, 67), runs, pads)),
            ("sx_block", "Sx-500m", lambda: sx_block.sx_block(dem, o, d, b, 10.0),
             lambda: sx_block.sx_block_plain(dem, o, d, b, 10.0)),
        ]
        for kernel, label, fast, plain in rows:
            t_plain, t_kernel = median_ms(plain), median_ms(fast)
            times[(kernel, grid)] = (t_kernel, t_plain)
            print(f"[time] {label} {grid}: kernel {t_kernel:.4f} ms "
                  f"({mpix / t_kernel * 1e3:.1f} Mpixel/s), twin {t_plain:.4f} ms "
                  f"({mpix / t_plain * 1e3:.1f} Mpixel/s) on {smi_line}")
        t_tpi = median_ms(lambda: ops.tpi(dem, 67, device=dem.device))
        t_sx = median_ms(lambda: ops.sx(dem, o, d, b, device=dem.device))
        print(f"[time] whole op {grid}: ops.tpi(67 px) {t_tpi:.4f} ms "
              f"({mpix / t_tpi * 1e3:.1f} Mpixel/s), ops.sx(500 m) {t_sx:.4f} ms "
              f"({mpix / t_sx * 1e3:.1f} Mpixel/s) on {smi_line}")
    return times


def slow_median_ms(fn):
    """(median ms, repetitions): :func:`median_ms`, but a function whose
    first call takes over a second gets 3 repetitions after it."""
    first = median_ms(fn, reps=1, warmup=0)
    if first > 1000.0:
        return median_ms(fn, reps=3, warmup=0), 3
    return median_ms(fn, warmup=2), TIMING_REPS


def time_sweeps(grids, smi_line):
    """The 36-azimuth fan at 900x1440 (r = 200 m and 2000 m) and 8192x8192
    (r = 500 m): both fan kernels, the per-azimuth sx_block loop (the
    'pallas' route) and the twin, on the same deduplicated tables."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import sx_sweep_dedupe, sx_sweep_offsets
    from topo_descriptors_tpu_torch.ops.cuda import sx_block, sx_sweep

    times = {}
    for grid, radius in (("900x1440", 200.0), ("900x1440", 2000.0), ("8192x8192", 500.0)):
        dem = grids[grid]
        o, d, b = sx_sweep_offsets(SWEEP_AZIMUTHS, radius, 30.0, 30.0)
        o, d = sx_sweep_dedupe(o, d)
        mpix_az = dem.numel() * len(o) / 1e6
        case = f"{grid} r{int(radius)}"
        rows = {
            "sx_sweep": lambda: sx_sweep.sx_sweep(dem, o, d, b, 10.0),
            "sx_fan": lambda: sx_sweep.sx_fan(dem, o, d, b, 10.0),
            "pallas loop": lambda: torch.stack(
                [sx_block.sx_block(dem, o[a], d[a], b, 10.0) for a in range(len(o))]),
            "twin": lambda: sx_sweep.sx_sweep_plain(dem, o, d, b, 10.0),
            "ops.sx_sweep auto": lambda: ops.sx_sweep(dem, o, d, b, device=dem.device),
        }
        for label, fn in rows.items():
            ms, reps = slow_median_ms(fn)
            times[(label, case)] = ms
            print(f"[time] Sx sweep 36 az {case} (rays {int((~np.isnan(d)).sum())}) {label}: "
                  f"{ms:.4f} ms ({mpix_az / ms * 1e3:.1f} Mpixel*azimuth/s, median of {reps}) "
                  f"on {smi_line}")
    return times


# --- phase 6: smoothed DEM, gradient, valley/ridge and the suite ------------------

# valley/ridge norm: rtol 1e-3 and atol 2e-3 as tests/test_ops.py; at the
# 67 and 667 px scales plus 1e-5 of the largest norm: a norm sums ~size^2
# kernel taps (4489 at 67 px), so float32 rounding grows with it (the tests
# use 7-15 px). Direction: < 2% of the pixels may differ, where angles are
# near-tied.
VALLEY_RTOL, VALLEY_ATOL, VALLEY_REL_MAX = 1e-3, 2e-3, 1e-5
DIR_MISMATCH = 0.02
# (rtol, atol). dx/dy: the 2 km Gaussian takes the FFT route, where cuFFT and
# the CPU FFT each land ~2e-5 from float64 (tests/test_torch_pipeline.py);
# such a derivative error e tilts the slope by up to rad2deg(sqrt(2) e)
GRAD_ATOL = 5e-5
FIELD_TOL = {"DEM": (1e-5, 1e-3), "WE": (1e-3, GRAD_ATOL), "SN": (1e-3, GRAD_ATOL),
             "SLOPE": (1e-3, float(np.rad2deg(np.sqrt(2.0) * GRAD_ATOL)))}
ASPECT_ATOL = 2e-2


BANK_M, STREAM_M = 2000, 20000  # valley/ridge scales: the bank and the streamed route
VALLEY_FLATS = [0, 0.2, 0.4]


def slice3_calls(ind_nans):
    """The reference's own scales (examples/compute_topo_descriptors.py)."""
    return [
        ("compute_dem", dict(scales=[100, 2000, 20000], ind_nans=ind_nans)),
        # 100 m is 3 px, sigma 0.75: the Sobel route
        ("compute_gradient", dict(scales=[100, 200, 2000], sig_ratios=1, ind_nans=ind_nans)),
        ("compute_gradient", dict(scales=[2000], sig_ratios=2, ind_nans=ind_nans)),
        # 2 km: 67 px, an 18.6 MiB bank, the dftmm route; 20 km: 667 px, a
        # 1.8 GiB bank above the 192 MiB budget, the streamed route
        ("compute_valley_ridge", dict(scales=[BANK_M, STREAM_M], mode="valley", smth_factors=0.5,
                                      flat_list=VALLEY_FLATS, ind_nans=ind_nans)),
        ("compute_valley_ridge", dict(scales=[BANK_M], mode="ridge", flat_list=[0, 0.15, 0.3],
                                      ind_nans=ind_nans)),
    ]


def valley_sizes(dem_ds):
    """{scale: (size px, sigma at smth_factors=0.5)} as the driver derives them."""
    from topo_descriptors_tpu_torch.host import get_sigmas, scale_to_pixel

    sizes, _ = scale_to_pixel([BANK_M, STREAM_M], dem_ds)
    sigmas = get_sigmas([0.5, 0.5], sizes)
    return {m: (int(n), s) for m, n, s in zip((BANK_M, STREAM_M), sizes, sigmas)}


def valley_agree(label, out, ref, rel_max=VALLEY_REL_MAX):
    """Norms within the tolerance above (``rel_max`` of the largest norm
    on top of the atol), directions mismatched on < 2% of the pixels;
    ``out``/``ref`` are (norm, direction) numpy pairs; a driver's NaN holes
    are skipped."""
    keep = ~(np.isnan(out[0]) | np.isnan(ref[0]))
    a, b = out[0][keep], ref[0][keep]
    n_err = float(np.abs(a - b).max())
    atol = VALLEY_ATOL + rel_max * float(b.max())
    mism = float((out[1][keep] != ref[1][keep]).mean())
    print(f"[slice3] {label}: max|norm diff| {n_err:.6g} (max norm {float(b.max()):.6g}, "
          f"rtol {VALLEY_RTOL}, atol {atol:.3g}), direction mismatch {mism:.4%}")
    check(np.allclose(a, b, rtol=VALLEY_RTOL, atol=atol), f"{label}: norms disagree")
    check(mism < DIR_MISMATCH, f"{label}: {mism:.4%} directions disagree")
    return n_err


def compare_fields(card, cpu):
    """DEM and gradient files of the card against the same drivers on the
    CPU. Aspect modulo 360, with the turn a derivative error causes on a
    gentle slope (e * sqrt(2) / |grad| radians) on top of ASPECT_ATOL."""
    check(sorted(card) == sorted(cpu) and len(cpu) == 3 + 4 * 4, f"outputs {sorted(card)}")
    for name in sorted(cpu):
        a, b = card[name].data, cpu[name].data
        check(a.shape == b.shape and a.dtype == np.float32, f"{name}: {a.shape} {a.dtype}")
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{name}: NaN positions differ")
        check(np.isfinite(np.nanmax(np.abs(a))), f"{name}: no finite values")
        kind = name.split("/")[1].split("_")[0]
        if kind == "ASPECT":
            slope = cpu[name.replace("ASPECT", "SLOPE")].data
            turn = np.rad2deg(np.sqrt(2.0) * GRAD_ATOL / np.tan(np.deg2rad(slope)))
            err = np.abs((a - b + 180.0) % 360.0 - 180.0)
            ok = np.nanmax(err - ASPECT_ATOL - turn) <= 0
            tol = f"{ASPECT_ATOL} + turn"
        else:
            rtol, atol = FIELD_TOL[kind]
            err = np.abs(a - b)
            ok = np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
            tol = f"rtol {rtol}, atol {atol:.3g}"
        print(f"[slice3] {name} {a.shape}: max|cuda-cpu| {float(np.nanmax(err)):.6g} ({tol})")
        check(ok, f"{name}: the card disagrees with the CPU run")


def valley_recipe(dem, size, mode, flats):
    """The reference's recipe in float64 (tests/oracles.py): ndimage.rotate
    per angle, a 3-D signal.convolve, the strictly-greater running max."""
    from scipy import signal

    from topo_descriptors_tpu_torch.host import ridge_kernels, rotate_kernels, valley_kernels

    dem = dem.astype(np.float64)
    dem = (dem - dem.mean()) / dem.std()
    dem_b = np.broadcast_to(dem, (len(flats),) + dem.shape)
    norm = np.full(dem.shape, -np.inf)
    direction = np.zeros(dem.shape)
    base = ridge_kernels(size, flats) if mode == "ridge" else valley_kernels(size, flats)
    for angle in range(180):
        conv = signal.convolve(dem_b, rotate_kernels(base, float(angle)).astype(np.float64),
                               mode="same").max(axis=0)
        greater = conv > norm
        norm[greater] = conv[greater]
        direction[greater] = angle
    return np.clip(norm, 0, None), direction


def host_pair(pair):
    return tuple(t.cpu().numpy() for t in pair)


def check_valley(dem_ds, dem, main_out, crop):
    """Routes against each other on the card, the drivers against their op,
    and a crop against the scipy recipe and the CPU run."""
    from topo_descriptors_tpu_torch import ops

    (n_bank, s_bank), (n_stream, s_stream) = valley_sizes(dem_ds).values()
    routes = {m: host_pair(ops.valley_ridge(dem, n_bank, "valley", VALLEY_FLATS, s_bank, method=m,
                                            device=dem.device))
              for m in ("dftmm", "fft", "direct", "stream")}
    grid = "x".join(map(str, dem.shape))
    for m in ("fft", "direct", "stream"):
        valley_agree(f"valley {BANK_M} m ({n_bank} px) {m} vs dftmm ({grid})", routes[m],
                     routes["dftmm"])

    def driver(scale):
        return tuple(main_out[f"s3call3/VALLEY_{k}_{scale}M_SMTHFACT0.5"].data
                     for k in ("NORM", "DIR"))

    valley_agree(f"compute_valley_ridge {BANK_M} m vs ops dftmm", driver(BANK_M), routes["dftmm"])
    streams = {c: host_pair(ops.valley_ridge_streamed(dem, n_stream, "valley", VALLEY_FLATS,
                                                      s_stream, conv_method=c, device=dem.device))
               for c in ("mm", "fft")}
    valley_agree(f"valley {STREAM_M} m ({n_stream} px) stream mm vs stream fft ({grid})",
                 streams["mm"], streams["fft"])
    valley_agree(f"compute_valley_ridge {STREAM_M} m vs ops stream mm", driver(STREAM_M),
                 streams["mm"])
    for size, mode in ((9, "valley"), (15, "ridge")):
        flats = [0, 0.15, 0.3]
        card = host_pair(ops.valley_ridge(crop, size, mode, flats, device="cuda"))
        valley_agree(f"{mode} {size} px crop {crop.shape}: card vs scipy recipe", card,
                     valley_recipe(crop, size, mode, flats), rel_max=0.0)
        valley_agree(f"{mode} {size} px crop {crop.shape}: card vs cpu", card,
                     host_pair(ops.valley_ridge(crop, size, mode, flats, device="cpu")),
                     rel_max=0.0)


def run_suite(dem_ds, dem):
    """TerrainSuite(default SuiteConfig).forward on the card, with the disk
    and Sx kernel counts set to 0 just before the call and read just after."""
    from topo_descriptors_tpu_torch import pipeline
    from topo_descriptors_tpu_torch.models import SuiteConfig, TerrainSuite
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat, sx_block

    suite = TerrainSuite(tuple(dem.shape), SuiteConfig(), device=dem.device)
    disk_sat.LAUNCHES = sx_block.LAUNCHES = 0
    start = time.perf_counter()
    out = suite(dem)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {"disk_sat": disk_sat.LAUNCHES, "sx_block": sx_block.LAUNCHES}
    print(f"[slice3] TerrainSuite.forward in {wall:.3f} s (first call), launches {launches}, "
          f"keys {sorted(out)}")
    check(all(n > 0 for n in launches.values()), f"the suite launched no kernel: {launches}")
    for key, value in out.items():
        ok = value.shape == dem.shape and value.device == dem.device
        check(ok and bool(torch.isfinite(value).all()),
              f"suite {key}: {tuple(value.shape)} {value.device}, or not finite")
    cfg = suite.config
    sx = pipeline.sx(dem_ds, azimuth=cfg.sx_azimuth, radius=cfg.sx_radius_m)
    check(np.array_equal(out["sx"].cpu().numpy(), sx), "suite sx differs from pipeline.sx")
    print("[slice3] suite sx equals pipeline.sx bit for bit (signed resolutions, dy = -30 m)")
    return suite, launches


def clear_valley_caches():
    from topo_descriptors_tpu_torch.ops import dft_conv

    vr = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")
    vr._BANK_DEV_CACHE.clear()
    vr._CANVAS_DEV_CACHE.clear()
    dft_conv._cached_plan.cache_clear()


def time_slice3(dem_ds, dem, suite, walls, smi_line):
    """CUDA-event times of the new ops (median of 20 after 3 warm-ups; the
    valley/ridge calls: a first call with every cache cleared, then the
    median of 5 or 3 warm ones) and each driver call's wall time."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import rotated_extent, scale_to_pixel
    from topo_descriptors_tpu_torch.ops.dft_conv import get_plan
    from topo_descriptors_tpu_torch.ops.spline_rotate import quadrant_schedule

    (n2, n20), res = scale_to_pixel([2000, 20000], dem_ds)
    s2, s20 = n2 / 4, n20 / 4  # compute_dem / compute_gradient: scale_pxl / scale_std
    rows = [
        (f"ops.dem 2 km (sigma {s2})", lambda: ops.dem(dem, s2, device=dem.device)),
        (f"ops.dem 20 km (sigma {s20})", lambda: ops.dem(dem, s20, device=dem.device)),
        ("ops.gradient 100 m (Sobel)", lambda: ops.gradient(dem, 0.75, res, device=dem.device)),
        ("ops.gradient 2 km", lambda: ops.gradient(dem, s2, res, device=dem.device)),
        ("ops.gradient 2 km sig_ratio 2", lambda: ops.gradient(dem, s2, res, 2, device=dem.device)),
        ("TerrainSuite.forward", lambda: suite(dem)),
    ]
    grid = "x".join(map(str, dem.shape))
    for label, fn in rows:
        print(f"[time] {label} {grid}: {median_ms(fn):.4f} ms on {smi_line}")
    (n_bank, s_bank), (n_stream, s_stream) = valley_sizes(dem_ds).values()
    n_flats = len(VALLEY_FLATS)
    n_steps = -(-len(quadrant_schedule()[0]) // 4)  # the streamed route's q_batch 4
    valley = [
        (f"ops.valley_ridge {BANK_M} m dftmm", max(rotated_extent(n_bank)), 180 * n_flats, 5,
         lambda: ops.valley_ridge(dem, n_bank, "valley", VALLEY_FLATS, s_bank, method="dftmm",
                                  device=dem.device)),
        (f"ops.valley_ridge {STREAM_M} m stream", max(rotated_extent(n_stream)),
         n_steps * 4 * 4 * n_flats, 3,
         lambda: ops.valley_ridge(dem, n_stream, "valley", VALLEY_FLATS, s_stream, method="stream",
                                  device=dem.device)),
    ]
    for label, kmax, n_kernels, reps, fn in valley:
        clear_valley_caches()
        first = median_ms(fn, reps=1, warmup=0)
        warm = median_ms(fn, reps=reps, warmup=1)
        macs = get_plan(*dem.shape, kmax, kmax, "same", dem.device).macs_per_kernel() * n_kernels
        print(f"[time] {label} {grid} ({n_kernels} kernels of {kmax}^2, {macs:.4g} MACs): "
              f"first call {first:.4f} ms, warm {warm:.4f} ms (median of {reps}, "
              f"{macs / warm / 1e9:.3f} TMAC/s) on {smi_line}")
    for (driver, kwargs), wall in zip(slice3_calls(None), walls):
        shown = {k: v for k, v in kwargs.items() if k != "ind_nans"}
        print(f"[time] {driver}({shown}) {grid} wall {wall:.3f} s on {smi_line}")


def run_slice3(dem_ds, ind_nans, use_h5py, dem, crop, smi_line):
    """Phase 6: the third slice's drivers and suite on the card, checked
    against the CPU, each other and the scipy recipe, then timed."""
    start = time.perf_counter()
    main_out, walls = run_drivers(dem_ds, slice3_calls(ind_nans), use_h5py, prefix="s3call")
    print(f"[slice3] 5 driver calls on the card in {time.perf_counter() - start:.3f} s")
    check(np.isnan(main_out["s3call0/DEM_100M"].data[ind_nans]).all(), "NaN holes not reassigned")
    cpu_out, _ = run_drivers(dem_ds, slice3_calls(ind_nans)[:3], use_h5py, device="cpu",
                             prefix="s3call")
    compare_fields({k: v for k, v in main_out.items() if k in cpu_out}, cpu_out)
    check_valley(dem_ds, dem, main_out, crop)
    suite, launches = run_suite(dem_ds, dem)
    time_slice3(dem_ds, dem, suite, walls, smi_line)
    return launches


def main() -> int:
    name, smi_line = card()
    from topo_descriptors_tpu_torch.host import basodino_like_dem, fill_na, synthetic_dem
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat, sx_block, sx_sweep
    from topo_descriptors_tpu_torch.ops.sx import _sweep_auto_method

    build()

    t0 = start = time.perf_counter()
    baso = basodino_like_dem(projected=True)
    grids = {
        "900x1440": torch.from_numpy(baso.data).cuda(),
        "8192x8192": torch.from_numpy(synthetic_dem(8192, 8192)).cuda(),
    }
    print(f"[data] grids made in {time.perf_counter() - start:.2f} s")
    errs = {"disk_sat": 0.0, "sx_block": 0.0, "sx_sweep": 0.0, "sx_fan": 0.0}
    for grid, dem in grids.items():
        for case in disk_cases(dem):
            errs["disk_sat"] = max(errs["disk_sat"], check_disk(*case, grid))
        for case in sx_cases():
            errs["sx_block"] = max(errs["sx_block"], check_sx(case[0], dem, *case[1:], grid))
        for case in sweep_cases(grid):
            for kernel, err in check_sweep(case[0], dem, *case[1:], grid).items():
                errs[kernel] = max(errs[kernel], err)
    print(f"[parity] done at {time.perf_counter() - t0:.1f} s")

    data = np.array(baso.data)
    data[100:104, 200:230] = np.nan  # holes: filled for compute, NaN again in the outputs
    ind_nans, dem_ds = fill_na(baso.with_data(data))
    use_h5py = importlib.util.find_spec("h5py") is not None
    print(f"[drivers] writing {'NetCDF through h5py, read back' if use_h5py else 'to memory (no h5py here)'}")
    dem_filled = torch.from_numpy(np.ascontiguousarray(dem_ds.data, np.float32)).cuda()
    auto_kernel = {"pallas_fan": "sx_fan", "pallas_sweep": "sx_sweep"}[
        _sweep_auto_method(dem_filled)]
    disk_sat.LAUNCHES = 0
    sx_block.LAUNCHES = 0
    sx_sweep.LAUNCHES.update(sx_sweep=0, sx_fan=0)
    start = time.perf_counter()
    main_out, _ = run_drivers(dem_ds, main_path_calls(ind_nans), use_h5py)
    other_method, other_out = other_sweep_call(dem_ds, dem_filled)
    torch.cuda.synchronize()
    launches = {"disk_sat": disk_sat.LAUNCHES, "sx_block": sx_block.LAUNCHES, **sx_sweep.LAUNCHES}
    print(f"[drivers] 7 driver calls and ops.sx_sweep(method={other_method!r}) in "
          f"{time.perf_counter() - start:.3f} s, launches {launches}; auto routes the "
          f"sweep to {auto_kernel}")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(launches[auto_kernel] >= 2, f"compute_sx_sweep did not launch {auto_kernel}")
    with plain_twins():
        ref_out, _ = run_drivers(dem_ds, main_path_calls(ind_nans), use_h5py)
        _, other_ref = other_sweep_call(dem_ds, dem_filled)
    compare_outputs(main_out, ref_out, baso.data.shape)
    check(torch.equal(torch.isnan(other_out), torch.isnan(other_ref))
          and float(torch.nan_to_num(other_out - other_ref).abs().max()) <= SX_ATOL,
          f"ops.sx_sweep(method={other_method!r}) disagrees with the twin")
    check_sweep_drivers(dem_ds, main_out, other_out)
    check(np.isnan(main_out["call0/TPI_500M"].data[ind_nans]).all(), "NaN holes not reassigned")
    check_against_recipes(baso.data[:90, :144])
    print(f"[drivers] done at {time.perf_counter() - t0:.1f} s")

    times = time_kernels(grids, smi_line)
    sweep_times = time_sweeps(grids, smi_line)
    print(f"[time] done at {time.perf_counter() - t0:.1f} s")
    del grids
    slice3_launches = run_slice3(dem_ds, ind_nans, use_h5py, dem_filled,
                                    np.ascontiguousarray(baso.data[:90, :144]), smi_line)
    print(f"[slice3] done at {time.perf_counter() - t0:.1f} s")
    sources = {
        "disk_sat": ("topo_descriptors_tpu_torch/csrc/disk_sat.cu",
                     "topo_descriptors_tpu/ops/pallas/disk_sat.py:58"),
        "sx_block": ("topo_descriptors_tpu_torch/csrc/sx_block.cu",
                     "topo_descriptors_tpu/ops/pallas/sx_block.py:67"),
        "sx_sweep": ("topo_descriptors_tpu_torch/csrc/sx_sweep.cu",
                     "topo_descriptors_tpu/ops/pallas/sx_block.py:139"),
        "sx_fan": ("topo_descriptors_tpu_torch/csrc/sx_sweep.cu",
                   "topo_descriptors_tpu/ops/pallas/sx_block.py:241"),
    }
    kernels = []
    for kernel, (source, replaces) in sources.items():
        entry = {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[kernel], "max_abs_err": errs[kernel]}
        if kernel in slice3_launches:  # TerrainSuite.forward, phase 6
            entry["launches_suite"] = slice3_launches[kernel]
        if kernel in sx_sweep.LAUNCHES:  # 36 azimuths; ms at 900x1440 r = 200 m
            for suffix, case in (("", "900x1440 r200"), ("_r2000", "900x1440 r2000"),
                                 ("_8192", "8192x8192 r500")):
                entry[f"ms{suffix}"] = sweep_times[(kernel, case)]
                entry[f"plain_ms{suffix}"] = sweep_times[("twin", case)]
        else:
            entry["ms"], entry["plain_ms"] = times[(kernel, "900x1440")]
            entry["ms_8192"], entry["plain_ms_8192"] = times[(kernel, "8192x8192")]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
