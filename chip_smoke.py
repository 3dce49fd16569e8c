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
6. print the kernels' JSON line, then the result line.

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


def run_drivers(dem, ind_nans, use_h5py):
    """All outputs of the slice's drivers on the card, keyed
    ``"<call>/<variable>"`` (each driver call writes to its own directory)."""
    from topo_descriptors_tpu_torch import pipeline
    from topo_descriptors_tpu_torch.host import read_raster

    calls = [
        (pipeline.compute_tpi, dict(scales=[500, 2000], ind_nans=ind_nans)),  # fused
        (pipeline.compute_tpi, dict(scales=[2000], smth_factors=0.5, ind_nans=ind_nans)),
        (pipeline.compute_tpi_std, dict(scales=[500, 2000], ind_nans=ind_nans)),
        (pipeline.compute_sx, dict(azimuth=0, radius=500)),
        (pipeline.compute_sx, dict(azimuth=0, radius=2000)),
        (pipeline.compute_sx_sweep, dict(azimuths=SWEEP_AZIMUTHS, radius=2000)),
        (pipeline.compute_sx_sweep, dict(azimuths=SWEEP_AZIMUTHS, radius=200)),
    ]
    store = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        if not use_h5py:
            stack.enter_context(memory_writer(store))
        files = []
        for i, (driver, kwargs) in enumerate(calls):
            files += driver(dem, outdir=Path(tmp) / f"call{i}", **kwargs)
        torch.cuda.synchronize()
        if use_h5py:
            for f in files:
                r = read_raster(f)
                store[f"{f.parent.name}/{r.name}"] = r
    return store


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
    main_out = run_drivers(dem_ds, ind_nans, use_h5py)
    other_method, other_out = other_sweep_call(dem_ds, dem_filled)
    torch.cuda.synchronize()
    launches = {"disk_sat": disk_sat.LAUNCHES, "sx_block": sx_block.LAUNCHES, **sx_sweep.LAUNCHES}
    print(f"[drivers] 7 driver calls and ops.sx_sweep(method={other_method!r}) in "
          f"{time.perf_counter() - start:.3f} s, launches {launches}; auto routes the "
          f"sweep to {auto_kernel}")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(launches[auto_kernel] >= 2, f"compute_sx_sweep did not launch {auto_kernel}")
    with plain_twins():
        ref_out = run_drivers(dem_ds, ind_nans, use_h5py)
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
