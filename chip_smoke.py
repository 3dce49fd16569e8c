#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines:
1. check the card (name, and power limit from nvidia-smi);
2. build the hand-written kernels from ``topo_descriptors_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch twin on the card, at the
   Basodino-sized grid (900 x 1440), at 8192 x 8192 and on a 1000 x 1337
   grid that is no multiple of either kernel's tile: the disk kernel with
   the main path's disks and the wide route's 6, 20 and 100 km disks (201,
   667 and 3333 px; 'same' and 'valid', one field and the STD stack; 201
   px also on a 50 x 61 crop),
   the Sx kernel at 500 m and 2000 m (every side of the one-sided halo)
   and on its chunked route (halos above one staged box: 10 km at 45
   degrees on every grid; 10 km at 30 degrees and north-up and 20 km on
   all but 8192 x 8192), also on a 50 x 61 grid smaller than the 2000 m
   halo, a one-chunk plan against the tile route and a plan of short
   chunks against the model's plan, bit for bit; the Sx sweep and fan
   kernels on all four grids (36-azimuth fans, north-up and without the
   zero border on the 1000 x 1337 grid, the radius_min and distance-0
   fans, and fans of both kernels' chunked routes at 900 x 1440: at 10 km
   azimuths 0 and 45 with and without the zero border, azimuth 45 alone
   and 36 azimuths, at 20 km azimuths 0 and 45 without it), also against
   per-azimuth ``sx_block``, bit for bit, and on the sweep's chunked route
   its split plans of one work item per azimuth and of one per group
   start against the model's plan (whose S each line prints), bit for bit;
   every route of every kernel must have run;
4. run the port's drivers on the card (TPI fused and smoothed, TPI+STD,
   Sx at 500 m and 2000 m, the 36-azimuth Sx sweep at 2000 m and 200 m)
   and ``ops.sx_sweep`` with the sweep kernel that ``auto`` does not pick,
   check that every kernel was launched (all four on their shared-memory
   routes), count the launches of ``compute_tpi(scales=
   [2000])`` and ``compute_sx(radius=500)`` alone, and compare every
   output with the same calls run on the plain twins; then ``compute_sx``
   at 45 degrees and the 36-azimuth ``compute_sx_sweep`` at 10 km, which
   must launch the chunked routes of ``sx_block`` and ``sx_fan`` once each
   and nothing else, against the same calls on the twins;
5. time each kernel against its twin (CUDA events, median of 20; a twin
   that takes over a second per call, median of 3) beside its bound (the
   larger of its operations over the float32 peak and its bytes over the
   HBM rate) and, for the disk kernel, the one PyTorch call that computes
   the same function (``F.conv2d`` in full float32); the 36-azimuth fans
   through both sweep kernels, each with its route, bound and share,
   beside the per-azimuth ``sx_block`` loop and the twin; the disk
   kernel's wide route at the example batch's 6, 20 and 100 km disks
   (201, 667, 3333 px) on 900 x 1440, 667 px on the STD moment stack, and
   667 and 201 px at 8192 x 8192, each first held against its twin as in
   phase 3, then timed with its twin (a call over 200 ms: median of 3),
   bound (kernel rows inside the field only), launches and the library
   call (one call for 667 px at 8192 x 8192, ~12 s); the whole ``ops.tpi`` at 3333 px
   with its host parts; and the Sx kernels' chunked routes at 10 km on
   900 x 1440 and 8192 x 8192 (``sx_sweep`` with the S of its split plan),
   the 8192 x 8192 fans' twins on a crop;
6. run the third slice on the 900 x 1440 grid with NaN holes, at the
   reference's scales: ``compute_dem``, ``compute_gradient`` (both checked
   against the same drivers on the CPU), ``compute_valley_ridge`` in valley
   mode at 2 km (the bank route) and 20 km (the streamed route) and in
   ridge mode at 2 km, and ``TerrainSuite.forward`` (which must launch the
   disk and Sx kernels; its Sx must equal ``pipeline.sx``); check the
   valley/ridge routes against each other on the card and, on a 90 x 144
   crop, against the scipy recipe and the CPU; time the new ops and
   drivers;
7. out of core on the card: write the 900 x 1440 grid and an 8192 x 8192
   one, both with holes, as deflate strip GeoTIFFs; stream every family
   from them through ``streaming`` in 4 bands (``TiledRunner``) and hold
   each output against the single-pass driver on the same filled grid
   (Sx bit for bit); check that each band launched its kernel (the fan's
   on its shared-memory route), that no
   read exceeded one band and its halos, that the streamed 8192 x 8192
   TPI+STD peaks below 60% of the single pass's device memory, that
   pipelined and serial band loops give the same bits, that a failed
   writer leaves every writer of its call aborted, and that the tiled
   pipeline backend and the CLI's ``--stream`` give the same outputs;
   time the 8192 x 8192 families (wall, Mpixel/s, the card's idle share);
8. the mesh on the card (``parallel.ShardedOps``): a 1x1 mesh under a
   one-rank NCCL group through ``compute_tpi``, ``compute_sx`` and the
   36-azimuth ``compute_sx_sweep``; a 2x2 mesh of four blocks on
   ``cuda:0`` through every ShardedOps method on the 900 x 1440 grid and
   the ragged 1000 x 1337 one; a 2 km Sx on a (4, 1) mesh whose blocks are
   shorter than the ray border (multi-hop); TPI-2000m and Sx-500m at
   8192 x 8192 and 900 x 1440 on 2x2, timed against the single pass, with
   the halo exchange timed apart; two processes in a gloo group, two blocks
   each on ``cuda:0``; and ``cli.main(... --sharded --mesh 1 1)``. Every
   output is held against the single pass (Sx and the sweep bit for bit)
   and every sharded call must launch ``disk_sat``, ``sx_block`` or
   ``sx_fan`` once per block and convolution;
9. profiling and the reference's batch: calibrate the card's rates for
   the valley routing cost model and the roofline (``conv_bank`` on the
   2 km bank and the 20 km streamed kernels, the streamed FFT route's
   convolution at 20 km and 100 km, the rotation-table gather) and print
   them beside the constants in the code and the route each streamed
   scale takes; hold ``Roofline`` floors against the Sx-500m kernel, the
   2 km dftmm valley and the 20 km streamed valley (no floor may exceed
   its time by more than 5%); trace ``compute_tpi(scales=[2000])`` with
   ``utils.profiling.device_trace`` (the Chrome trace must hold a
   ``disk_sat`` kernel); run ``examples.compute_topo_descriptors`` (every
   family over the reference's 12 scales, 100 m to 100 km, valley/ridge
   from 1 km) on the demo grid with phase 4's holes: the output names,
   NaN holes and finite values elsewhere, ``disk_sat`` on both routes and
   ``sx_block`` launched, TPI, STD and the valley index at 2 km against
   phases 4 and 6; time it per family and scale (``Timings``,
   ``throughput_report``) with the floors of the 30, 60 and 100 km
   valley/ridge scales, and hold its 100 km valley index against the
   streamed route the cost model did not pick; run ``examples.walkthrough``
   where h5py is here;
10. print the kernels' JSON line, then the result line.

Any failure raises and exits non-zero; without a CUDA device the script
exits non-zero before it imports the port. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import subprocess
import sys
import tempfile
import threading
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
    kernel = None  # ptxas reports each kernel's entry, then its spills and registers
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("row_scanILi1E", "row_scanILi128E", "disk_sat_wide",
                                       "disk_sat_tile", "sx_block_tile", "sx_block_chunked",
                                       "sx_sweep_chunkedILb0E", "sx_sweep_chunkedILb1E",
                                       "sx_sweep_combine", "sx_sweep_tile",
                                       "sx_fan_tile")
                           if k in line), line.split("'")[1][:40])
        elif kernel and ("registers" in line or "spill" in line):
            print(f"[build] {kernel}: {line.split(':', 1)[-1].strip()}")


# --- phase 3: kernels against their twins ------------------------------------


def disk_cases(dem: torch.Tensor, grid: str):
    """(name, fields, kernel, pads) as the main path feeds the kernel: the
    mean-centred DEM (TPI) and the STD moment stack (z-c, t-c, (t-c)^2),
    with the main path's disks; and the disks of the example batch whose
    tile does not fit in shared memory, the wide route: at 900x1440 the 6,
    20 and 100 km disks (201, 667 and 3333 px), 667 px on the moment stack
    and 201 px on it with 'valid' pads; 667 px at 1000x1337; on the 50x61
    crop only the 201-px disk, taller and wider than the grid."""
    from topo_descriptors_tpu_torch.host import circular_kernel
    from topo_descriptors_tpu_torch.ops.conv import _same_pads

    z = dem - torch.round(dem.mean())
    t = torch.trunc(dem) - torch.round(dem.mean())
    moments = torch.stack([z, t, t * t]).contiguous()
    z = z[None].contiguous()
    even = np.ones((4, 6), np.float32)
    even[1, 2] = 0.0

    def same(k):
        return (_same_pads(k.shape[0]), _same_pads(k.shape[1]))

    tpi67 = circular_kernel(67, exclude_center=True)
    disk17 = circular_kernel(17)
    disk201, disk667 = circular_kernel(201), circular_kernel(667)
    if grid == "50x61":
        return [("disk201_b1_wide", z, disk201, same(disk201))]
    cases = [
        ("tpi_disk67_b1", z, tpi67, same(tpi67)),
        ("disk17_b3", moments, disk17, same(disk17)),
        ("even4x6_b1", z, even, same(even)),
        ("disk17_b3_valid", moments, disk17, ((0, 0), (0, 0))),
    ]
    if grid == "900x1440":
        disk3333 = circular_kernel(3333)
        cases += [("disk201_b1_wide", z, disk201, same(disk201)),
                  ("disk667_b1_wide", z, disk667, same(disk667)),
                  ("disk3333_b1_wide", z, disk3333, same(disk3333)),
                  ("disk667_b3_wide", moments, disk667, same(disk667)),
                  ("disk201_b3_valid_wide", moments, disk201, ((0, 0), (0, 0)))]
    elif grid == "1000x1337":
        cases.append(("disk667_b1_wide", z, disk667, same(disk667)))
    return cases


def check_disk(name, xs, kernel, pads, grid):
    """Two checks. On integer fields whose row sums stay below 2^24 every
    prefix sum is exact in float32, so kernel and twin (which sum the rows
    in the same order) must agree bit for bit. On the real fields the two
    scan orders differ; a tree scan's error is at most log2(n) eps
    sum|x| per prefix value, and an output reads 2 x runs of them."""
    from topo_descriptors_tpu_torch.ops.conv import _binary_kernel_runs
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat

    runs = _binary_kernel_runs(kernel[::-1, ::-1])
    route = disk_sat.route(kernel.shape, len(disk_sat.run_table(runs)[0]))
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
    print(f"[parity] disk_sat {name} {grid} B={xs.shape[0]} ({route} route): integer fields bit-equal; "
          f"max|kernel-twin| {err:.6g} (|out| <= {float(ref.abs().max()):.6g}, tol {tol:.6g})")
    check(err <= tol, f"disk_sat {name} {grid}: {err} > {tol}")
    return err


def sx_cases(grid):
    """(name, offsets, distances, border) of the deduplicated rays checked
    on ``grid``: the main path's 500 m and 2000 m, the distance-0 and
    radius_min fans, every side of the one-sided halo at 2000 m (azimuths
    90, 180, 270), and the halos that do not fit in shared memory, the
    chunked route: 10 km at 45 degrees on every grid, and on every grid but
    8192x8192 10 km at 30 degrees, 10 km north-up (dy < 0) and 20 km at
    45."""
    from topo_descriptors_tpu_torch.host import sx_dedupe, sx_offsets

    # (name, azimuth, radius, radius_min, dy)
    cases = [("r500_az0", 0.0, 500.0, 0.0, 30.0), ("r2000_az0", 0.0, 2000.0, 0.0, 30.0),
             ("r250_az225_distance0", 225.0, 250.0, 0.0, 30.0),
             ("r500_az0_radius_min100", 0.0, 500.0, 100.0, 30.0),
             ("r2000_az90", 90.0, 2000.0, 0.0, 30.0), ("r2000_az180", 180.0, 2000.0, 0.0, 30.0),
             ("r2000_az270", 270.0, 2000.0, 0.0, 30.0),
             ("r10000_az45", 45.0, 10_000.0, 0.0, 30.0)]
    if grid != "8192x8192":  # the twin at 10 km on 8192^2 takes seconds a call
        cases += [("r10000_az30", 30.0, 10_000.0, 0.0, 30.0),
                  ("r10000_az45_northup", 45.0, 10_000.0, 0.0, -30.0),
                  ("r20000_az45", 45.0, 20_000.0, 0.0, 30.0)]
    for name, az, radius, rmin, dy in cases:
        o, d, b = sx_offsets(az, radius, 30.0, dy, radius_min=rmin)
        o, d = sx_dedupe(o, d)
        yield name, o, d, b


def check_sx(name, dem, o, d, b, grid):
    from topo_descriptors_tpu_torch.ops.cuda import sx_block

    offs, _, inv = sx_block.ray_groups(o, d)
    route = sx_block.route(sx_block.halo_box(offs), len(offs), len(inv))
    out = sx_block.sx_block(dem, o, d, b, 10.0)
    torch.cuda.synchronize()
    ref = sx_block.sx_block_plain(dem, o, d, b, 10.0)
    check(torch.equal(torch.isnan(out), torch.isnan(ref)),
          f"sx_block {name} {grid}: NaN positions differ")
    err = float(torch.nan_to_num(out - ref).abs().max())
    print(f"[parity] sx_block {name} {grid} K={len(o)} border={b} ({route} route): "
          f"max|kernel-twin| {err:.6g} deg (tol {SX_ATOL}), NaN positions equal")
    check(err <= SX_ATOL, f"sx_block {name} {grid}: {err} > {SX_ATOL}")
    return err


# a chunked-route stage so short that chunks end inside distance groups
SHORT_STAGE = 20 * 1024


def check_chunked(dem, grid):
    """The chunked route of ``sx_block`` against the other plans and the
    tile route, bit for bit: a plan of one chunk (2000 m at azimuth 90, whose
    box fits one stage) against the tile route, and at 10 km (45 degrees)
    a plan of short stages, whose chunks end inside groups, against the
    plan the cost model picks for the grid."""
    from topo_descriptors_tpu_torch.host import sx_dedupe, sx_offsets
    from topo_descriptors_tpu_torch.ops.cuda import sx_block

    o, d, b = sx_offsets(90.0, 2000.0, 30.0, 30.0)
    o, d = sx_dedupe(o, d)
    _, n_one, _ = sx_block.device_plan(o, d, b, dem.device)
    check(n_one == 1, f"2000 m: {n_one} chunks, not one")
    one, tile = sx_block.sx_block_chunked(dem, o, d, b), sx_block.sx_block(dem, o, d, b)
    o, d, b = sx_offsets(45.0, 10_000.0, 30.0, 30.0)
    o, d = sx_dedupe(o, d)
    plan, n_short, _ = sx_block.device_plan(o, d, b, dem.device, SHORT_STAGE)
    splits = int(((plan.cpu().numpy()[4 : 4 + 8 * n_short].reshape(-1, 8)[:, 3]
                   & sx_block.CARRY_OUT) > 0).sum())
    n_sms = torch.cuda.get_device_properties(dem.device).multi_processor_count
    busy = sx_block.busy_blocks_per_sm(dem.shape, b, True, n_sms)
    _, n_default, _ = sx_block.device_plan(o, d, b, dem.device, None, busy)
    short = sx_block.sx_block_chunked(dem, o, d, b, stage_bytes=SHORT_STAGE)
    default = sx_block.sx_block(dem, o, d, b)
    torch.cuda.synchronize()
    check(same_bits(one, tile), f"sx_block {grid}: the one-chunk plan differs from the tile route")
    check(splits > 0 and same_bits(short, default),
          f"sx_block {grid}: {n_short} short chunks ({splits} ending inside a group) differ "
          f"from the model's {n_default}")
    print(f"[parity] sx_block chunked {grid}: one-chunk plan (2000 m, az 90) bit-equal to the tile "
          f"route; at 10 km az 45 {n_short} chunks of {SHORT_STAGE} B ({splits} ending inside a "
          f"group) bit-equal to the model's {n_default}")


def sweep_cases(grid):
    """(name, offsets, distances, border, zero_border) of the deduplicated
    fans checked on ``grid``: the 36-azimuth sweep at both radii of
    BASELINE.json configs[3], a ragged radius_min fan, the distance-0 fan
    and, at 900x1440, fans whose boxes do not fit in shared memory (both
    kernels' chunked routes): at 10 km azimuths 0 and 45 with and without
    the zero border, azimuth 45 alone (the grid leaves SMs idle: the
    sweep's plan splits) and the 36-azimuth sweep, and azimuths 0 and 45 at
    20 km without the zero border (with it, the 667-px border covers the
    grid); the 36-azimuth sweep at 500 m at 8192x8192; at 1000x1337 (no
    tile multiple) the 2000 m sweep north-up (dy < 0) and without the zero
    border, and the 500 m one; at 50x61 (smaller than the 2000 m halo) the
    2000 m sweep and the 10 km fan."""
    from topo_descriptors_tpu_torch.host import sx_sweep_dedupe, sx_sweep_offsets

    # (name, azimuths, radius, radius_min, dy, zero_border)
    cases = {
        "900x1440": [("36az_r200", SWEEP_AZIMUTHS, 200.0, 0.0, 30.0, True),
                     ("36az_r2000", SWEEP_AZIMUTHS, 2000.0, 0.0, 30.0, True),
                     ("r300_radius_min100", (10, 200, 355), 300.0, 100.0, 30.0, True),
                     ("r250_distance0", (225, 45), 250.0, 0.0, 30.0, True),
                     ("r10000", (0, 45), 10_000.0, 0.0, 30.0, True),
                     ("r10000_az45", (45,), 10_000.0, 0.0, 30.0, True),
                     ("r10000_nozero", (0, 45), 10_000.0, 0.0, 30.0, False),
                     ("r20000_nozero", (0, 45), 20_000.0, 0.0, 30.0, False),
                     ("36az_r10000", SWEEP_AZIMUTHS, 10_000.0, 0.0, 30.0, True)],
        "8192x8192": [("36az_r500", SWEEP_AZIMUTHS, 500.0, 0.0, 30.0, True)],
        "1000x1337": [("36az_r2000_northup_nozero", SWEEP_AZIMUTHS, 2000.0, 0.0, -30.0, False),
                      ("36az_r500", SWEEP_AZIMUTHS, 500.0, 0.0, 30.0, True)],
        "50x61": [("36az_r2000", SWEEP_AZIMUTHS, 2000.0, 0.0, 30.0, True),
                  ("r10000", (0, 45), 10_000.0, 0.0, 30.0, True)],
    }[grid]
    for name, azimuths, radius, rmin, dy, zero_border in cases:
        o, d, b = sx_sweep_offsets(azimuths, radius, 30.0, dy, radius_min=rmin)
        o, d = sx_sweep_dedupe(o, d)
        yield name, o, d, b, zero_border


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def sweep_routes(o, d, b, device):
    """The route each fan kernel takes for this fan, from its bytes."""
    from topo_descriptors_tpu_torch.ops.cuda import sx_sweep

    t = sx_sweep.device_tables(o, d, b, device)
    return {"sx_sweep": sx_sweep.route(t.sweep_smem), "sx_fan": sx_sweep.route(t.fan_smem)}


def sweep_splits(o, d, b, dem, zero_border=True):
    """The work items per azimuth of the sweep's split plan for this fan
    and grid (:func:`sx_sweep.device_sweep_plan`), or None where the sweep
    takes its tile route or its package has no split plan."""
    from topo_descriptors_tpu_torch.ops.cuda import sx_sweep

    plan = getattr(sx_sweep, "device_sweep_plan", None)  # None before the split route
    if plan is None:
        return None
    if sx_sweep.route(sx_sweep.device_tables(o, d, b, dem.device).sweep_smem) == "tile":
        return None
    n_sms = torch.cuda.get_device_properties(dem.device).multi_processor_count
    return plan(o, d, b, dem.device, dem.shape, zero_border, n_sms).splits.tolist()


def forced_split(dem, o, d, b, zero_border, splits):
    """The sweep's chunked route with S forced: the model's chunk plan for
    this grid cut into ``splits`` work items per azimuth where its group
    starts allow (``sx_block.split_plan``). Returns (the planes, S per
    azimuth); counts no launch."""
    from topo_descriptors_tpu_torch.ops.cuda import sx_block, sx_sweep

    n_sms = torch.cuda.get_device_properties(dem.device).multi_processor_count
    p = sx_sweep.device_sweep_plan(o, d, b, dem.device, dem.shape, zero_border, n_sms)
    plan = p.plan.cpu().numpy()
    items, per_az, _ = sx_block.split_plan(plan, len(o), 0, n_sms, 3, splits)
    forced = sx_sweep.upload_plan(plan, p.stage_floats, items, per_az, dem.device)
    return sx_sweep.launch_sweep_chunked(dem, forced, b, 10.0, zero_border), per_az.tolist()


def brief(splits):
    """Work items per azimuth, or their most for a long fan."""
    return splits if len(splits) <= 4 else f"at most {max(splits)}"


def check_sweep(name, dem, o, d, b, zero_border, grid):
    """Both fan kernels against the twin, plane by plane (the (36, 8192,
    8192) stacks are 9.7 GB each), and bit for bit against sx_block on the
    azimuth's table: the three kernels share the per-pixel code and the
    1/distance groups. On the sweep's chunked route also its split plans of
    one work item per azimuth and of one per group start, bit for bit
    against the model's. Returns the errors and the twin's time over the
    planes (CUDA events around each plane's call, summed)."""
    from topo_descriptors_tpu_torch.ops.cuda import sx_block, sx_sweep

    routes = sweep_routes(o, d, b, dem.device)
    outs = {"sx_sweep": sx_sweep.sx_sweep(dem, o, d, b, 10.0, zero_border),
            "sx_fan": sx_sweep.sx_fan(dem, o, d, b, 10.0, zero_border)}
    split_text = ""
    if routes["sx_sweep"] == "chunked":
        for forced in (1, 10**6):
            again, most = forced_split(dem, o, d, b, zero_border, forced)
            check(same_bits(again, outs["sx_sweep"]),
                  f"sx_sweep {name} {grid}: the plan of {forced} items per azimuth differs")
            del again
        split_text = (f"; sweep plan S = {brief(sweep_splits(o, d, b, dem, zero_border))}, "
                      f"bit-equal to S = 1 and to one item per group start, S = {brief(most)}")
    torch.cuda.synchronize()
    errs = dict.fromkeys(outs, 0.0)
    twin_ms = 0.0
    for a in range(len(o)):
        ref, ms = timed(lambda: sx_sweep.sx_sweep_plain(
            dem, o[a : a + 1], d[a : a + 1], b, 10.0, zero_border)[0])
        twin_ms += ms
        one = sx_block.sx_block(dem, o[a], d[a], b, 10.0, zero_border)  # pad rows: NaN, dropped
        for kernel, out in outs.items():
            check(torch.equal(torch.isnan(out[a]), torch.isnan(ref)),
                  f"{kernel} {name} {grid} azimuth {a}: NaN positions differ")
            errs[kernel] = max(errs[kernel], float(torch.nan_to_num(out[a] - ref).abs().max()))
            check(same_bits(out[a], one),
                  f"{kernel} {name} {grid} azimuth {a}: not bit-equal to sx_block")
    n_rays = int((~np.isnan(d)).sum())
    print(f"[parity] sx_sweep/sx_fan {name} {grid} A={len(o)} rays={n_rays} border={b} "
          f"zero_border={zero_border} ({routes['sx_sweep']}/{routes['sx_fan']} route): "
          f"max|kernel-twin| {errs['sx_sweep']:.6g} / {errs['sx_fan']:.6g} deg "
          f"(tol {SX_ATOL}), NaN positions equal, every plane bit-equal to sx_block{split_text}")
    for kernel, err in errs.items():
        check(err <= SX_ATOL, f"{kernel} {name} {grid}: {err} > {SX_ATOL}")
    return errs, twin_ms


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


def reset_launches():
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat, sx_block, sx_sweep

    disk_sat.LAUNCHES = sx_block.LAUNCHES = 0
    sx_sweep.LAUNCHES.update(sx_sweep=0, sx_fan=0)
    for routes in (disk_sat.ROUTE_LAUNCHES, sx_block.ROUTE_LAUNCHES,
                   *sx_sweep.ROUTE_LAUNCHES.values()):
        routes.update(dict.fromkeys(routes, 0))


def read_launches():
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat, sx_block, sx_sweep

    return {"disk_sat": disk_sat.LAUNCHES, "sx_block": sx_block.LAUNCHES, **sx_sweep.LAUNCHES}


def read_route_launches():
    """Launches per route of each kernel."""
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat, sx_block, sx_sweep

    return {"disk_sat": dict(disk_sat.ROUTE_LAUNCHES), "sx_block": dict(sx_block.ROUTE_LAUNCHES),
            **{k: dict(v) for k, v in sx_sweep.ROUTE_LAUNCHES.items()}}


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


def disk_sx_error(kind, a, b):
    """(max error, tolerance, unit) of a TPI, STD or Sx plane against
    another. TPI: 1e-2 m (prefix sums of 1440-column rows, ulp <= 0.25,
    2 x 68 reads, over the 3408-tap sum). STD, compared as variance:
    25 m^2 (the three moment convolutions each carry such errors, and the
    centring constant c ~ 1800 m multiplies the two linear ones). Sx:
    2e-5 deg."""
    if kind == "STD":
        a, b, tol, unit = a.astype(np.float64) ** 2, b.astype(np.float64) ** 2, 25.0, "m^2"
    else:
        tol, unit = (1e-2, "m") if kind == "TPI" else (SX_ATOL, "deg")
    return float(np.nanmax(np.abs(a - b))), tol, unit


def compare_outputs(main, ref, shape):
    """Every output at the tolerances of :func:`disk_sx_error`; one line per
    (call, descriptor) with the largest error of its outputs."""
    n_out = 9 + 2 * len(SWEEP_AZIMUTHS)
    check(sorted(main) == sorted(ref) and len(main) == n_out, f"outputs {sorted(main)}")
    worst = {}
    for name in sorted(main):
        a, b = main[name].data, ref[name].data
        check(a.shape == shape and a.dtype == np.float32, f"{name}: {a.shape} {a.dtype}")
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{name}: NaN positions differ")
        call, var = name.split("/")
        kind = var.split("_")[0]
        err, tol, unit = disk_sx_error(kind, a, b)
        check(np.isfinite(np.nanmax(np.abs(a))), f"{name}: no finite values")
        check(err <= tol, f"{name}: {err} > {tol}")
        key = (call, var if kind != "SX" else "SX")
        n, e, _, _ = worst.get(key, (0, 0.0, tol, unit))
        worst[key] = (n + 1, max(e, err), tol, unit)
    for (call, var), (n, err, tol, unit) in sorted(worst.items()):
        print(f"[drivers] {call}/{var} ({n} output{'s' * (n > 1)}, {shape}): "
              f"max|cuda-twins| {err:.6g} {unit} (tol {tol})")


def driver_fan(dem_ds, radius):
    """The deduplicated 36-azimuth fan at ``radius`` on ``dem_ds``'s
    geometry, as the driver builds it: the grid's signed metric
    resolutions."""
    from topo_descriptors_tpu_torch.host import sx_sweep_dedupe, sx_sweep_offsets

    res = dem_ds.grid.resolution_meters()
    o, d, b = sx_sweep_offsets(SWEEP_AZIMUTHS, float(radius), float(res["x"].mean()),
                               float(res["y"].mean()))
    return (*sx_sweep_dedupe(o, d), b)


def auto_kernel_of(dem, o, d, b):
    """The fan kernel ``auto`` gives a deduplicated fan on ``dem``."""
    from topo_descriptors_tpu_torch.ops.sx import _sweep_auto_method

    return {"pallas_fan": "sx_fan", "pallas_sweep": "sx_sweep"}[_sweep_auto_method(dem, o, d, b)]


def other_sweep_call(dem_ds, dem):
    """``ops.sx_sweep`` on the 36-azimuth 200 m fan of ``dem_ds`` (``dem``
    on the card) with the fan kernel that ``auto`` does not pick, so the
    driven run reaches both."""
    from topo_descriptors_tpu_torch import ops

    o, d, b = driver_fan(dem_ds, 200)
    method = {"sx_fan": "pallas_sweep", "sx_sweep": "pallas_fan"}[auto_kernel_of(dem, o, d, b)]
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


# the 10 km driver calls: a halo too large for one staged box, so the
# chunked routes: sx_block's, sx_fan's (auto, 36 azimuths) and sx_sweep's
# (auto, two azimuths: its split plan fills the SMs that 104 busy tiles
# leave idle)
TEN_KM_CALLS = [("compute_sx", dict(azimuth=45, radius=10_000)),
                ("compute_sx_sweep", dict(azimuths=SWEEP_AZIMUTHS, radius=10_000)),
                ("compute_sx_sweep", dict(azimuths=(0, 45), radius=10_000))]


def run_10km_drivers(dem_ds, use_h5py):
    """``compute_sx`` at azimuth 45 and ``compute_sx_sweep`` over 36
    azimuths and over azimuths 0 and 45 at 10 km on the card: they must
    launch the chunked routes of ``sx_block``, ``sx_fan`` and ``sx_sweep``
    once each and no other route; their outputs against the same calls on
    the twins, the 36-azimuth sweep's azimuth-130 plane against
    ``pipeline.sx``'s, and the two-azimuth sweep's planes against the
    36-azimuth sweep's at azimuth 0 and ``compute_sx``'s at 45, bit for
    bit. Returns the launches by kernel and by route."""
    reset_launches()
    start = time.perf_counter()
    out, walls = run_drivers(dem_ds, TEN_KM_CALLS, use_h5py, prefix="km10_")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, routes = read_launches(), read_route_launches()
    check(all(routes[k] == {"tile": 0, "chunked": 1} for k in ("sx_block", "sx_fan", "sx_sweep")),
          f"the 10 km drivers did not take the chunked routes alone: {routes}")
    with plain_twins():
        ref, ref_walls = run_drivers(dem_ds, TEN_KM_CALLS, use_h5py, prefix="km10_")
    check(sorted(out) == sorted(ref) and len(out) == 3 + len(SWEEP_AZIMUTHS),
          f"10 km outputs {sorted(out)}")
    worst = 0.0
    for name in sorted(out):
        a, b = out[name].data, ref[name].data
        check(a.shape == dem_ds.data.shape and np.isfinite(np.nanmax(np.abs(a))),
              f"{name}: {a.shape}, no finite values")
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{name}: NaN positions differ")
        worst = max(worst, float(np.nanmax(np.abs(a - b))))
    check(worst <= SX_ATOL, f"10 km drivers: {worst} deg against the twins")
    from topo_descriptors_tpu_torch import pipeline

    single = pipeline.sx(dem_ds, azimuth=130, radius=10_000)  # sx_block's chunked route
    check(np.array_equal(out["km10_1/SX_RADIUS10000_AZIMUTH130"].data.view(np.int32),
                         single.view(np.int32)),
          "the 10 km sweep's azimuth 130 differs from pipeline.sx")
    pairs = [("km10_2/SX_RADIUS10000_AZIMUTH0", "km10_1/SX_RADIUS10000_AZIMUTH0"),
             ("km10_2/SX_RADIUS10000_AZIMUTH45", "km10_0/SX_RADIUS10000_AZIMUTH45")]
    for a, b in pairs:
        check(np.array_equal(out[a].data.view(np.int32), out[b].data.view(np.int32)),
              f"10 km: {a} differs from {b}")
    print(f"[drivers] 10 km: compute_sx(azimuth=45) {walls[0]:.3f} s, compute_sx_sweep(36 "
          f"azimuths) {walls[1]:.3f} s, compute_sx_sweep(azimuths 0, 45) {walls[2]:.3f} s on the "
          f"card ({ref_walls[0]:.3f} s, {ref_walls[1]:.3f} s, {ref_walls[2]:.3f} s on the twins); "
          f"launches {launches}, per route {routes}; {3 + len(SWEEP_AZIMUTHS)} planes "
          f"max|cuda-twins| {worst:.6g} deg (tol {SX_ATOL}), the 36-azimuth sweep's azimuth 130 "
          f"bit-equal to pipeline.sx, the two-azimuth sweep's planes to the 36-azimuth sweep's "
          f"(azimuth 0) and to compute_sx (45) ({wall:.3f} s)")
    return launches, routes


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


def timed(fn):
    """(``fn()``, its ms on the card by CUDA events): one call, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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


def bound(ops, nbytes):
    """(least ms, which term sets it) of ``ops`` float32 operations moving
    ``nbytes`` through device memory: the larger of the two over the
    published peaks of one H100 SXM at its 700 W limit (float32 outside the
    tensor cores, HBM3), ``Roofline``'s defaults; each input read once,
    each output written once."""
    from topo_descriptors_tpu_torch.utils.profiling import Roofline

    roof = Roofline()
    t_ops = ops / (roof.fp32_tflops * 1e12) * 1e3
    t_bytes = roof.hbm_light_speed_ms(nbytes)
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def disk_work(shape, kshape, runs, pads):
    """(operations, bytes) of one disk convolution of a (B, H, W) stack.
    Only kernel rows whose padded row lies inside the field count: the
    others add prefix rows of zeros, exactly +0.0, which is no work the
    card must do. So: the row scan's one add per input of a field row, then
    per output one add per prefix read (2 per run whose row is inside), one
    subtraction per run group with a row inside and one add per such group
    after the first; the fields read once, the output written once."""
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat

    (ly, hy), (lx, hx) = pads
    b, h, w = shape
    h_out, w_out = h + ly + hy - kshape[0] + 1, w + lx + hx - kshape[1] + 1

    def rows_inside(rows):
        """Per output row y, how many of ``rows`` have ly <= y + r < ly + h."""
        diff = np.zeros(h_out + 1, np.int64)
        for r in rows:
            y0, y1 = min(max(ly - r, 0), h_out), min(max(ly + h - r, 0), h_out)
            diff[y0] += 1
            diff[y1] -= 1
        return np.cumsum(diff[:-1])

    n_runs = rows_inside([r for r, _, _ in runs])
    n_groups = sum((rows_inside(rows) > 0).astype(np.int64)
                   for _, _, rows in disk_sat.group_runs(runs))
    per_row = 2 * n_runs + np.maximum(2 * n_groups - 1, 0)
    ops = b * w_out * int(per_row.sum()) + b * h * (w + lx + hx)
    return ops, 4 * b * (h * w + h_out * w_out)


def sx_work(shape, offsets, distances, border):
    """(operations, bytes) of the Sx kernels on an (H, W) DEM for one
    azimuth's rays ((K, 2) offsets) or a fan's ((A, K, 2)): per interior
    pixel (the zero border computes nothing) and azimuth, one fmax per kept
    ray and a subtraction, a product and an fmax per distance group; the
    DEM read once, one plane written per azimuth."""
    from topo_descriptors_tpu_torch.ops.cuda import sx_block

    h, w = shape
    offsets = np.asarray(offsets).reshape(-1, *np.asarray(offsets).shape[-2:])
    distances = np.asarray(distances).reshape(len(offsets), -1)
    interior = max(h - 2 * border, 0) * max(w - 2 * border, 0)
    ops = 0
    for o, d in zip(offsets, distances):
        offs, _, inv = sx_block.ray_groups(o, d)
        ops += interior * (len(offs) + 3 * len(inv))
    return ops, 4 * h * w * (1 + len(offsets))


def disk_library(z, kernel):
    """One PyTorch call that computes the same function as the disk kernel:
    ``F.conv2d`` of the (B, 1, H, W) stack with the (flipped) kernel and
    'same' padding, in full float32 (``full_float32`` sets cuDNN's
    ``allow_tf32`` to False). Timed here as a yardstick only; the port
    never calls it."""
    from topo_descriptors_tpu_torch.ops.conv import full_float32

    weight = torch.from_numpy(np.ascontiguousarray(kernel[::-1, ::-1], np.float32))
    weight = weight[None, None].to(z.device)
    pad = kernel.shape[0] // 2

    def run():
        with full_float32():
            return torch.nn.functional.conv2d(z[:, None], weight, padding=pad)[:, 0]

    return run


def time_kernels(grids, smi_line):
    """Kernel, twin and (for the disk) library times of the main path's two
    kernels, with their bounds, at both grids; then the whole ops."""
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
        library = disk_library(z, tpi67)
        lib_err = float((library() - disk_sat.disk_conv_sat(z, (67, 67), runs, pads)).abs().max())
        rows = [
            ("disk_sat", "TPI-2000m conv", lambda: disk_sat.disk_conv_sat(z, (67, 67), runs, pads),
             lambda: disk_sat.disk_conv_sat_plain(z, (67, 67), runs, pads),
             disk_work(z.shape, (67, 67), runs, pads), library),
            ("sx_block", "Sx-500m", lambda: sx_block.sx_block(dem, o, d, b, 10.0),
             lambda: sx_block.sx_block_plain(dem, o, d, b, 10.0),
             sx_work(dem.shape, o, d, b), None),
        ]
        for kernel, label, fast, plain, work, lib in rows:
            t_plain, t_kernel = median_ms(plain), median_ms(fast)
            t_bound, bound_by = bound(*work)
            if lib is None:
                t_lib, lib_text = None, "library call: none (no single PyTorch call computes Sx)"
            else:
                t_lib, reps = slow_median_ms(lib)
                lib_text = (f"library F.conv2d full float32 {t_lib:.4f} ms (median of {reps}; "
                            f"max|conv2d-kernel| {lib_err:.6g})")
            times[(kernel, grid)] = dict(ms=t_kernel, plain_ms=t_plain, bound_ms=t_bound,
                                         bound_by=bound_by, library_ms=t_lib)
            print(f"[time] {label} {grid}: kernel {t_kernel:.4f} ms "
                  f"({mpix / t_kernel * 1e3:.1f} Mpixel/s), twin {t_plain:.4f} ms "
                  f"({mpix / t_plain * 1e3:.1f} Mpixel/s); bound {t_bound:.4f} ms ({bound_by}; "
                  f"{work[0]:.4g} ops, {work[1]:.4g} bytes), share of bound "
                  f"{t_bound / t_kernel:.4f}; {lib_text} on {smi_line}")
        t_tpi = median_ms(lambda: ops.tpi(dem, 67, device=dem.device))
        t_sx = median_ms(lambda: ops.sx(dem, o, d, b, device=dem.device))
        print(f"[time] whole op {grid}: ops.tpi(67 px) {t_tpi:.4f} ms "
              f"({mpix / t_tpi * 1e3:.1f} Mpixel/s), ops.sx(500 m) {t_sx:.4f} ms "
              f"({mpix / t_sx * 1e3:.1f} Mpixel/s) on {smi_line}")
    return times


# the disk kernel's wide route: (grid, disk px, B) as the batch feeds it
# (TPI: the mean-centred DEM; B = 3: STD's moment stack); the library call
# (F.conv2d here: about 2e12 MAC/s) times one call where it takes ~12 s
# (2.34e13 MACs), else a median of 3 after a first call
WIDE_CASES = (("900x1440", 201, 1), ("900x1440", 667, 1), ("900x1440", 3333, 1),
              ("900x1440", 667, 3), ("8192x8192", 667, 1), ("8192x8192", 201, 1))
WIDE_LIBRARY_ONCE = {("8192x8192", 667, 1)}
# a wide case's call over 200 ms (twins, library) is timed as a median of 3
WIDE_SLOW_MS = 200.0


def time_wide(grids, smi_line):
    """The wide route of ``disk_sat`` against its twin and the library
    call, beside its bound (rows inside the field only), with the
    launches of one call by route; every timed case is first held against
    the twin as phase 3 holds it (:func:`check_disk`)."""
    from topo_descriptors_tpu_torch.host import circular_kernel
    from topo_descriptors_tpu_torch.ops.conv import _binary_kernel_runs, _same_pads
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat

    times = {}
    for grid, size, fields in WIDE_CASES:
        dem = grids[grid]
        z = dem - torch.round(dem.mean())
        t = torch.trunc(dem) - torch.round(dem.mean())
        xs = (torch.stack([z, t, t * t]) if fields == 3 else z[None]).contiguous()
        kernel = circular_kernel(size)
        runs = _binary_kernel_runs(kernel[::-1, ::-1])
        pads = (_same_pads(size), _same_pads(size))
        before = dict(disk_sat.ROUTE_LAUNCHES)
        disk_sat.disk_conv_sat(xs, kernel.shape, runs, pads)
        torch.cuda.synchronize()
        per_call = {r: n - before[r] for r, n in disk_sat.ROUTE_LAUNCHES.items() if n > before[r]}
        check(per_call == {"wide": 1}, f"disk_sat {size} px {grid}: launches {per_call}")
        check_disk(f"disk{size}_b{fields}_wide", xs, kernel, pads, grid)
        t_kernel, reps = slow_median_ms(lambda: disk_sat.disk_conv_sat(xs, kernel.shape, runs, pads),
                                        WIDE_SLOW_MS)
        t_plain, plain_reps = slow_median_ms(
            lambda: disk_sat.disk_conv_sat_plain(xs, kernel.shape, runs, pads), WIDE_SLOW_MS)
        work = disk_work(xs.shape, kernel.shape, runs, pads)
        t_bound, bound_by = bound(*work)
        macs = xs.numel() * float(kernel.sum())
        if (grid, size, fields) in WIDE_LIBRARY_ONCE:
            _, t_lib = timed(disk_library(xs, kernel))
            lib_text = f"library F.conv2d full float32 {t_lib:.4f} ms (one call, {macs:.3g} MACs)"
        else:
            t_lib, lib_reps = slow_median_ms(disk_library(xs, kernel), WIDE_SLOW_MS)
            lib_text = f"library F.conv2d full float32 {t_lib:.4f} ms (median of {lib_reps})"
        case = f"{size}px {grid} B={fields}"
        times[case] = dict(ms=t_kernel, plain_ms=t_plain, bound_ms=t_bound, bound_by=bound_by,
                           library_ms=t_lib, launches_per_call=per_call)
        print(f"[time] disk_sat wide {case}: kernel {t_kernel:.4f} ms (median of {reps}), twin "
              f"{t_plain:.4f} ms (median of {plain_reps}); bound {t_bound:.4f} ms ({bound_by}; "
              f"{work[0]:.4g} ops, {work[1]:.4g} bytes), share of bound {t_bound / t_kernel:.4f}; "
              f"{lib_text}; launches per call {per_call} on {smi_line}")
    times["tpi_3333"] = whole_op_tpi(grids["900x1440"], smi_line)
    return times


def whole_op_tpi(dem, smi_line):
    """``ops.tpi`` at the 100 km disk (3333 px) on 900x1440 against its
    kernel, and the host work the op repeats on every call: the disk's runs
    from its diameter (``kernels.Disk``, taken once a call) and the count
    plane's factors and product; and the wide plan's build, which
    ``TABLES`` keeps after the first call."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.kernels import Disk
    from topo_descriptors_tpu_torch.ops.conv import _same_pads, edge_count_plane_device
    from topo_descriptors_tpu_torch.ops.cuda import disk_sat

    disk = Disk(3333, exclude_center=True)
    runs = disk.runs
    z = (dem - torch.round(dem.mean()))[None].contiguous()
    pads = (_same_pads(3333), _same_pads(3333))
    parts = {
        "ops.tpi": lambda: ops.tpi(dem, 3333, device=dem.device),
        "kernel": lambda: disk_sat.disk_conv_sat(z, disk.shape, runs, pads),
        "runs": lambda: Disk(3333, exclude_center=True).runs,
        "count plane": lambda: edge_count_plane_device(dem.shape, Disk(3333, True), dem.device),
        "wide plan": lambda: disk_sat.wide_plan(runs),
    }
    ms = {name: median_ms(fn, reps=3, warmup=1) for name, fn in parts.items()}
    print(f"[time] whole op ops.tpi(3333 px) 900x1440: {ms['ops.tpi']:.1f} ms against its "
          f"disk_sat kernel {ms['kernel']:.4f} ms; host work per call: the disk's runs "
          f"{ms['runs']:.1f} ms, edge_count_plane_device {ms['count plane']:.1f} ms (runs "
          f"included); once per kernel: wide_plan {ms['wide plan']:.1f} ms (median of 3) on "
          f"{smi_line}")
    return ms


# phase 5's Sx route cases, all at 10 km: (label, kernel, grid, azimuths;
# None for one azimuth at 45 degrees)
SX_ROUTE_CASES = (("sx_block az 45 900x1440", "sx_block", "900x1440", None),
                  ("sx_sweep az 45 900x1440", "sx_sweep", "900x1440", (45,)),
                  ("sx_sweep az 0, 45 900x1440", "sx_sweep", "900x1440", (0, 45)),
                  ("sx_fan az 0, 45 900x1440", "sx_fan", "900x1440", (0, 45)),
                  ("sx_sweep 36 az 900x1440", "sx_sweep", "900x1440", SWEEP_AZIMUTHS),
                  ("sx_fan 36 az 900x1440", "sx_fan", "900x1440", SWEEP_AZIMUTHS),
                  ("sx_block az 45 8192x8192", "sx_block", "8192x8192", None),
                  ("sx_sweep az 45 8192x8192", "sx_sweep", "8192x8192", (45,)),
                  ("sx_fan 36 az 8192x8192", "sx_fan", "8192x8192", SWEEP_AZIMUTHS))
# the 36-azimuth twin at 10 km on 8192^2 would take minutes: on this crop
TWIN_CROP = 1024
TILE_OUTPUTS = 32 * 64  # outputs of the Sx kernels' tile


def ran_route(routes, fn):
    """(``fn()``, the routes whose launch count one call raised)."""
    before = dict(routes)
    out = fn()
    torch.cuda.synchronize()
    return out, [r for r, n in routes.items() if n > before.get(r, 0)]


def time_sx_routes(grids, smi_line, twin_ms=None, twins=True):
    """The Sx kernels where a halo does not fit one staged box, at 10 km
    (``SX_ROUTE_CASES``): the kernel (CUDA events, median of 20, a call over
    a second median of 3) with the route it ran, read from the launch
    counts, so that the same function times an earlier package whose routes
    have other names, and for ``sx_sweep`` the work items per azimuth of its
    split plan; the twin, its bound (``sx_work``) and the share. The twins:
    median of 3 where over 0.1 s; the 36-azimuth twin at 900x1440 is phase
    3's one call (``twin_ms``); at 8192^2 the fans are held bit for bit
    against ``sx_block`` per azimuth, and kernel and twin are timed and
    compared on a ``TWIN_CROP``-square crop. ``twins=False``: kernels only."""
    from topo_descriptors_tpu_torch.host import (sx_dedupe, sx_offsets, sx_sweep_dedupe,
                                                 sx_sweep_offsets)
    from topo_descriptors_tpu_torch.ops.cuda import sx_block, sx_sweep

    o1, d1, b1 = sx_offsets(45.0, 10_000.0, 30.0, 30.0)
    o1, d1 = sx_dedupe(o1, d1)
    twin_ms = dict(twin_ms or {})
    times = {}
    for label, kernel, grid, azimuths in SX_ROUTE_CASES:
        dem = grids[grid]
        if azimuths is None:
            o, d, b = o1, d1, b1
            fast = lambda: sx_block.sx_block(dem, o, d, b, 10.0)  # noqa: E731
            plain = lambda: sx_block.sx_block_plain(dem, o, d, b, 10.0)  # noqa: E731
            routes = sx_block.ROUTE_LAUNCHES
        else:
            o, d, b = sx_sweep_offsets(azimuths, 10_000.0, 30.0, 30.0)
            o, d = sx_sweep_dedupe(o, d)
            fast = lambda: getattr(sx_sweep, kernel)(dem, o, d, b, 10.0)  # noqa: E731
            plain = lambda: sx_sweep.sx_sweep_plain(dem, o, d, b, 10.0)  # noqa: E731
            routes = sx_sweep.ROUTE_LAUNCHES[kernel]
        out, ran = ran_route(routes, fast)
        splits = sweep_splits(o, d, b, dem) if kernel == "sx_sweep" else None
        crop_text = ""
        if grid == "8192x8192" and azimuths is not None:
            for a in range(len(o)):  # the planes against sx_block, bit for bit
                check(same_bits(out[a], sx_block.sx_block(dem, o[a], d[a], b, 10.0)),
                      f"{label}: azimuth {a} not bit-equal to sx_block")
            if twins:
                crop = dem[:TWIN_CROP, :TWIN_CROP].contiguous()
                small = getattr(sx_sweep, kernel)(crop, o, d, b, 10.0)
                ref, twin_ms[label] = timed(lambda: sx_sweep.sx_sweep_plain(crop, o, d, b, 10.0))
                err = float(torch.nan_to_num(small - ref).abs().max())
                check(torch.equal(torch.isnan(small), torch.isnan(ref)) and err <= SX_ATOL,
                      f"{label}: {TWIN_CROP}^2 crop {err} against the twin")
                t_crop = median_ms(lambda: getattr(sx_sweep, kernel)(crop, o, d, b, 10.0))
                crop_text = (f"; on a {TWIN_CROP}^2 crop kernel {t_crop:.4f} ms against the twin's "
                             f"one call {twin_ms[label]:.4f} ms, max|kernel-twin| {err:.6g} deg")
        del out
        t_kernel, reps = slow_median_ms(fast)
        t_plain, plain_text = None, "twin: not run"
        if twins and label in twin_ms:
            t_plain = twin_ms[label]
            plain_text = (f"twin {t_plain:.4f} ms (one call, "
                          f"{'phase 3' if grid == '900x1440' else f'{TWIN_CROP}^2 crop'})")
        elif twins:
            shared = next((k for k, v in times.items() if v["grid"] == grid
                           and v["azimuths"] == azimuths and v["plain_ms"] is not None), None)
            if shared:  # the two fan kernels share one twin: timed once
                t_plain, plain_reps = times[shared]["plain_ms"], times[shared]["plain_reps"]
            else:
                t_plain, plain_reps = slow_median_ms(plain, 100.0)
            plain_text = f"twin {t_plain:.4f} ms (median of {plain_reps})"
        work = sx_work(dem.shape, o, d, b)
        t_bound, bound_by = bound(*work)
        times[label] = dict(kernel=kernel, grid=grid, azimuths=azimuths, route=ran,
                            splits=splits, ms=t_kernel, reps=reps, plain_ms=t_plain,
                            plain_reps=plain_reps if twins and label not in twin_ms else 1,
                            bound_ms=t_bound, bound_by=bound_by, library_ms=None)
        split_text = f", S = {brief(splits)}" if splits else ""
        print(f"[time] {label}, Sx 10 km ({len(o) if azimuths else 1} az, route {ran}{split_text}): "
              f"kernel {t_kernel:.4f} ms (median of {reps}), {plain_text}; bound {t_bound:.4f} ms "
              f"({bound_by}; {work[0]:.4g} ops, {work[1]:.4g} bytes), share of bound "
              f"{t_bound / t_kernel:.4f}; library call: none{crop_text} on {smi_line}")
    return times


def tune_chunk_stage():
    """The chunked route's stage size against the blocks that fit on an SM
    (``sx_block.CHUNK_STAGES``: two stages per block, for 1, 2 and 3
    blocks) and the stage the cost model picks (``chunk_plan`` without a
    stage): ``sx_block`` at 10 and 20 km (45 degrees) at 8192x8192 and the
    36-azimuth ``sx_fan`` at 10 km on 900x1440 and on a 4096x4096 crop, each
    with its chunks and staged values per output (CUDA events, median of
    5). Run on its own: ``python3 -c "import chip_smoke;
    chip_smoke.tune_chunk_stage()"``."""
    from topo_descriptors_tpu_torch.host import (basodino_like_dem, sx_dedupe, sx_offsets,
                                                 sx_sweep_dedupe, sx_sweep_offsets)
    from topo_descriptors_tpu_torch.ops.cuda import sx_block, sx_sweep

    _, smi_line = card()
    build()
    big = torch.from_numpy(basodino_like_dem(8192, 8192, seed=0).data).cuda()
    grids = {"900x1440": torch.from_numpy(basodino_like_dem(projected=True).data).cuda(),
             "4096x4096": big[:4096, :4096].contiguous()}
    fo, fd, fb = sx_sweep_offsets(SWEEP_AZIMUTHS, 10_000.0, 30.0, 30.0)
    fo, fd = sx_sweep_dedupe(fo, fd)
    fan = sx_sweep.azimuth_tables(*sx_sweep.sweep_tables(fo, fd))
    stages = {f"{n} per SM": stage for n, stage in sx_block.CHUNK_STAGES.items()}
    for label, stage in {**stages, "model": None}.items():
        for radius in (10_000.0, 20_000.0):
            o, d, b = sx_offsets(45.0, radius, 30.0, 30.0)
            o, d = sx_dedupe(o, d)
            plan, n_chunks, stage_floats = sx_block.chunk_plan([sx_block.ray_groups(o, d)], stage)
            recs = plan[4 : 4 + 8 * n_chunks].reshape(-1, 8)
            staged = float((recs[:, 6] * recs[:, 7]).sum()) / TILE_OUTPUTS
            ms = median_ms(lambda: sx_block.sx_block_chunked(big, o, d, b, 10.0,
                                                             stage_bytes=stage), reps=5)
            print(f"[tune] stage {label} ({4 * stage_floats} B): sx_block {radius / 1000:g} km az "
                  f"45 8192x8192: {n_chunks} chunks, {staged:.1f} staged values per output "
                  f"against {len(o)} rays, {ms:.4f} ms (median of 5) on {smi_line}")
        plan, n_chunks, stage_floats = sx_block.chunk_plan(fan, stage)
        items, per_az, _ = sx_block.split_plan(plan, len(fo), 0, 1, 1, splits=1)
        for grid, dem in grids.items():
            p = sx_sweep.upload_plan(plan, stage_floats, items, per_az, dem.device)
            ms = median_ms(lambda: sx_sweep.launch_sweep_chunked(dem, p, fb, 10.0, True, "sx_fan"),
                           reps=5)
            print(f"[tune] stage {label} ({4 * stage_floats} B): sx_fan 36 az 10 km {grid}: "
                  f"{n_chunks} chunks, {ms:.4f} ms (median of 5) on {smi_line}")


def tune_split():
    """``sx_sweep``'s chunked route on 900x1440 at 10 km (azimuth 45 alone;
    0 and 45; 0, 45 and 90), where the unsplit grid leaves SMs idle, on
    every split plan: for each stage of ``sx_block.CHUNK_STAGES``, S = 1, 2,
    ... work items per azimuth as far as its group starts allow, each held
    bit for bit against S = 1, its time (CUDA events, median of 10) beside
    the model's (``split_plan``, ray reads per output); then the plan the
    model picks, launched as those were (``launch_sweep_chunked``) against
    the best timed one and through its wrapper (``sx_sweep_chunked``, its
    host work included), and ``sx_fan``'s chunked route on the same fan.
    Run on its own: ``python3 -c "import chip_smoke;
    chip_smoke.tune_split()"``."""
    from topo_descriptors_tpu_torch.host import (basodino_like_dem, sx_sweep_dedupe,
                                                 sx_sweep_offsets)
    from topo_descriptors_tpu_torch.ops.cuda import sx_block, sx_sweep

    _, smi_line = card()
    build()
    dem = torch.from_numpy(basodino_like_dem(projected=True).data).cuda()
    n_sms = torch.cuda.get_device_properties(dem.device).multi_processor_count
    for azimuths in ((45,), (0, 45), (0, 45, 90)):
        o, d, b = sx_sweep_offsets(azimuths, 10_000.0, 30.0, 30.0)
        o, d = sx_sweep_dedupe(o, d)
        tables = sx_sweep.azimuth_tables(*sx_sweep.sweep_tables(o, d))
        tiles = sx_block.busy_tiles(dem.shape, b, True)
        ref, _ = forced_split(dem, o, d, b, True, 1)
        best = None
        for n, stage in sx_block.CHUNK_STAGES.items():
            plan, n_chunks, stage_floats, _ = sx_block._chunk_plan(tables, stage)
            for splits in range(1, n_chunks + 1):
                items, per_az, model = sx_block.split_plan(plan, len(tables), tiles, n_sms, n,
                                                           splits)
                if per_az.max() < splits:  # every azimuth at its most items
                    break
                p = sx_sweep.upload_plan(plan, stage_floats, items, per_az, dem.device)
                check(same_bits(sx_sweep.launch_sweep_chunked(dem, p, b, 10.0, True), ref),
                      f"sx_sweep {azimuths}: the plan of S = {per_az.tolist()} differs")
                ms = median_ms(lambda: sx_sweep.launch_sweep_chunked(dem, p, b, 10.0, True),
                               reps=10)
                if best is None or ms < best[0]:
                    best = (ms, n, per_az.tolist())
                print(f"[tune] sx_sweep split az {azimuths} 10 km 900x1440, stage {n} per SM "
                      f"({4 * stage_floats} B, {n_chunks} chunks): S = {per_az.tolist()}, "
                      f"{tiles * len(items)} busy blocks, model {model:.0f}: {ms:.4f} ms "
                      f"(median of 10) on {smi_line}")
        plan = sx_sweep.device_sweep_plan(o, d, b, dem.device, dem.shape, True, n_sms)
        ms = median_ms(lambda: sx_sweep.launch_sweep_chunked(dem, plan, b, 10.0, True), reps=10)
        wrapped = median_ms(lambda: sx_sweep.sx_sweep_chunked(dem, o, d, b, 10.0), reps=10)
        fan = median_ms(lambda: sx_sweep.sx_fan(dem, o, d, b, 10.0), reps=10)
        print(f"[tune] sx_sweep split az {azimuths} 10 km 900x1440: the model's plan "
              f"({4 * plan.stage_floats} B stage) S = {sweep_splits(o, d, b, dem)} {ms:.4f} ms, "
              f"{ms / best[0]:.3f} x the best timed plan (stage {best[1]} per SM, S = {best[2]}, "
              f"{best[0]:.4f} ms); through sx_sweep_chunked {wrapped:.4f} ms; sx_fan chunked "
              f"{fan:.4f} ms (median of 10) on {smi_line}")


def time_routes_alone(package_root=None):
    """Phase 5's Sx route timings alone (kernels only), for the package under
    ``package_root`` (put first on ``sys.path``; None: the one found first),
    so that an earlier commit's package, unpacked with ``git archive``, is
    timed beside this one's in one call: ``python3 -c "import chip_smoke;
    chip_smoke.time_routes_alone('build/parent')"``."""
    if package_root is not None:
        sys.path.insert(0, str(package_root))
    import topo_descriptors_tpu_torch
    from topo_descriptors_tpu_torch.host import basodino_like_dem

    print(f"[time] Sx routes of the package at {Path(topo_descriptors_tpu_torch.__file__).parent}")

    _, smi_line = card()
    build()
    grids = {"900x1440": torch.from_numpy(basodino_like_dem(projected=True).data).cuda(),
             "8192x8192": torch.from_numpy(basodino_like_dem(8192, 8192, seed=0).data).cuda()}
    times = time_sx_routes(grids, smi_line, twins=False)
    print(json.dumps({label: {k: v for k, v in t.items() if k != "azimuths"}
                      for label, t in times.items()}))


def slow_median_ms(fn, slow_ms: float = 1000.0):
    """(median ms, repetitions): :func:`median_ms`, but a function whose
    first call takes over ``slow_ms`` (a second) gets 3 repetitions after
    it."""
    first = median_ms(fn, reps=1, warmup=0)
    if first > slow_ms:
        return median_ms(fn, reps=3, warmup=0), 3
    return median_ms(fn, warmup=2), TIMING_REPS


def time_sweeps(grids, smi_line):
    """The 36-azimuth fan at 900x1440 (r = 200 m and 2000 m) and 8192x8192
    (r = 500 m): both fan kernels with their routes, bound and share of
    bound, the per-azimuth sx_block loop (``ops.sx_sweep(method='pallas')``,
    each plane written into one output) and the twin, on the same
    deduplicated tables; then ``ops.sx_sweep`` as ``auto`` routes it."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import sx_sweep_dedupe, sx_sweep_offsets
    from topo_descriptors_tpu_torch.ops.cuda import sx_sweep

    times = {}
    for grid, radius in (("900x1440", 200.0), ("900x1440", 2000.0), ("8192x8192", 500.0)):
        dem = grids[grid]
        o, d, b = sx_sweep_offsets(SWEEP_AZIMUTHS, radius, 30.0, 30.0)
        o, d = sx_sweep_dedupe(o, d)
        mpix_az = dem.numel() * len(o) / 1e6
        case = f"{grid} r{int(radius)}"
        work = sx_work(dem.shape, o, d, b)
        t_bound, bound_by = times[("bound", case)] = bound(*work)
        routes = sweep_routes(o, d, b, dem.device)
        print(f"[time] Sx sweep 36 az {case}: bound {t_bound:.4f} ms ({bound_by}; {work[0]:.4g} ops, "
              f"{work[1]:.4g} bytes); library call: none (no single PyTorch call computes Sx)")
        rows = {
            "sx_sweep": lambda: sx_sweep.sx_sweep(dem, o, d, b, 10.0),
            "sx_fan": lambda: sx_sweep.sx_fan(dem, o, d, b, 10.0),
            "per-azimuth loop": lambda: ops.sx_sweep(dem, o, d, b, method="pallas",
                                                     device=dem.device),
            "twin": lambda: sx_sweep.sx_sweep_plain(dem, o, d, b, 10.0),
            "ops.sx_sweep auto": lambda: ops.sx_sweep(dem, o, d, b, device=dem.device),
        }
        for label, fn in rows.items():
            ms, reps = slow_median_ms(fn)
            times[(label, case)] = ms
            kernel = (f" ({routes[label]} route), bound {t_bound:.4f} ms, share of bound "
                      f"{t_bound / ms:.4f}" if label in routes else "")
            print(f"[time] Sx sweep 36 az {case} (rays {int((~np.isnan(d)).sum())}) {label}{kernel}: "
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


def valley_agree(label, out, ref, rel_max=VALLEY_REL_MAX, tag="slice3"):
    """Norms within the tolerance above (``rel_max`` of the largest norm
    on top of the atol), directions mismatched on < 2% of the pixels;
    ``out``/``ref`` are (norm, direction) numpy pairs; a driver's NaN holes
    are skipped."""
    keep = ~(np.isnan(out[0]) | np.isnan(ref[0]))
    a, b = out[0][keep], ref[0][keep]
    n_err = float(np.abs(a - b).max())
    atol = VALLEY_ATOL + rel_max * float(b.max())
    mism = float((out[1][keep] != ref[1][keep]).mean())
    print(f"[{tag}] {label}: max|norm diff| {n_err:.6g} (max norm {float(b.max()):.6g}, "
          f"rtol {VALLEY_RTOL}, atol {atol:.3g}), direction mismatch {mism:.4%}")
    check(np.allclose(a, b, rtol=VALLEY_RTOL, atol=atol), f"{label}: norms disagree")
    check(mism < DIR_MISMATCH, f"{label}: {mism:.4%} directions disagree")
    return n_err


def field_check(kind, a, b, slope=None):
    """(max error, tolerance, ok) of a DEM or gradient plane ``a`` against
    ``b``. Aspect modulo 360, with the turn a derivative error causes on a
    gentle slope (e * sqrt(2) / |grad| radians; ``slope`` is the reference
    slope plane) on top of ASPECT_ATOL."""
    if kind == "ASPECT":
        turn = np.rad2deg(np.sqrt(2.0) * GRAD_ATOL / np.tan(np.deg2rad(slope)))
        err = np.abs((a - b + 180.0) % 360.0 - 180.0)
        return float(np.nanmax(err)), f"{ASPECT_ATOL} + turn", np.nanmax(err - ASPECT_ATOL - turn) <= 0
    rtol, atol = FIELD_TOL[kind]
    return (float(np.nanmax(np.abs(a - b))), f"rtol {rtol}, atol {atol:.3g}",
            np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True))


def compare_fields(card, cpu):
    """DEM and gradient files of the card against the same drivers on the
    CPU, at the tolerances of :func:`field_check`."""
    check(sorted(card) == sorted(cpu) and len(cpu) == 3 + 4 * 4, f"outputs {sorted(card)}")
    for name in sorted(cpu):
        a, b = card[name].data, cpu[name].data
        check(a.shape == b.shape and a.dtype == np.float32, f"{name}: {a.shape} {a.dtype}")
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{name}: NaN positions differ")
        check(np.isfinite(np.nanmax(np.abs(a))), f"{name}: no finite values")
        kind = name.split("/")[1].split("_")[0]
        slope = cpu[name.replace("ASPECT", "SLOPE")].data if kind == "ASPECT" else None
        err, tol, ok = field_check(kind, a, b, slope)
        print(f"[slice3] {name} {a.shape}: max|cuda-cpu| {err:.6g} ({tol})")
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
    k_stream = max(rotated_extent(n_stream))
    stream_route = streamed_route(*dem.shape, k_stream)
    valley = [
        (f"ops.valley_ridge {BANK_M} m dftmm", "mm", max(rotated_extent(n_bank)), 180 * n_flats, 5,
         lambda: ops.valley_ridge(dem, n_bank, "valley", VALLEY_FLATS, s_bank, method="dftmm",
                                  device=dem.device)),
        (f"ops.valley_ridge {STREAM_M} m stream", stream_route, k_stream,
         n_steps * 4 * 4 * n_flats, 3,
         lambda: ops.valley_ridge(dem, n_stream, "valley", VALLEY_FLATS, s_stream, method="stream",
                                  device=dem.device)),
    ]
    for label, route, kmax, n_kernels, reps, fn in valley:
        clear_valley_caches()
        first = median_ms(fn, reps=1, warmup=0)
        warm = median_ms(fn, reps=reps, warmup=1)
        if route == "mm":
            macs = get_plan(*dem.shape, kmax, kmax, "same", dem.device).macs_per_kernel() * n_kernels
            rate = f"{macs:.4g} MACs, {macs / warm / 1e9:.3f} TMAC/s warm"
        else:
            rate = "an rfft2 and an irfft2 each"
        print(f"[time] {label} {grid} ({route} route, {n_kernels} kernels of {kmax}^2, {rate}): "
              f"first call {first:.4f} ms, warm {warm:.4f} ms (median of {reps}) on {smi_line}")
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
    return launches, main_out


# --- phase 7: out of core on the card --------------------------------------------

OOC_TILE, BIG_TILE = 256, 2048  # rows per band: 4 bands of 900 x 1440 and of 8192 x 8192
BIG_HOLES = [  # (rows, cols, value) of the 8192 x 8192 grid; -9999 is below the minimum elevation
    (slice(1000, 1004), slice(2000, 2100), np.nan),
    (slice(2046, 2051), slice(4000, 4030), np.nan),  # across the first band boundary
    (slice(6140, 6150), slice(8000, None), np.nan),  # up to the right edge
    (slice(3000, 3002), slice(0, 60), -9999.0),
    (slice(7000, 7001), slice(5000, 5020), -9999.0),
]
DEVICE_MEMORY_SHARE = 0.6  # streamed 8192^2 TPI+STD peak / the single pass's


def ooc_calls():
    """The streaming driver calls at 900 x 1440, as ``(driver, kwargs)``:
    every family, valley on the bank route (2 km) and the streamed one
    (20 km), Sx for one azimuth and for the 36-azimuth fan."""
    return [
        ("compute_dem", dict(scales=[100, 2000, 20000])),
        ("compute_tpi_std", dict(scales=[500, 2000])),
        ("compute_gradient", dict(scales=[100, 2000])),
        ("compute_valley_ridge", dict(scales=[BANK_M, STREAM_M], mode="valley", smth_factors=0.5,
                                      flat_list=VALLEY_FLATS)),
        ("compute_valley_ridge", dict(scales=[BANK_M], mode="ridge")),
        ("compute_sx", dict(azimuths=[0], radius=500)),
        ("compute_sx", dict(azimuths=list(SWEEP_AZIMUTHS), radius=2000)),
    ]


def big_calls():
    """The streaming driver calls at 8192 x 8192. The 36-azimuth fan is left
    out: its 9.7 GB of output would sit in host memory."""
    return [("compute_tpi_std", dict(scales=[500, 2000])),
            ("compute_gradient", dict(scales=[2000])),
            ("compute_sx", dict(azimuths=[0], radius=500))]


def single_pass_call(driver, kwargs, ind_nans):
    """The pipeline driver call that writes the same outputs in one pass."""
    if driver != "compute_sx":
        return driver, dict(kwargs, ind_nans=ind_nans)
    azimuths, radius = kwargs["azimuths"], kwargs["radius"]
    if len(azimuths) == 1:
        return "compute_sx", dict(azimuth=azimuths[0], radius=radius)
    return "compute_sx_sweep", dict(azimuths=azimuths, radius=radius)


def call_label(grid, driver, kwargs):
    if driver == "compute_sx":
        return f"{grid} {driver} {len(kwargs['azimuths'])} az r{kwargs['radius']}"
    return f"{grid} {driver}{kwargs['scales']}" + (f" {kwargs['mode']}" if "mode" in kwargs else "")


def band_kernel(driver, kwargs, auto_kernel):
    """The hand kernel a streamed call launches at least once per band, or
    None for the families that run on library calls."""
    if driver == "compute_tpi_std":
        return "disk_sat"
    if driver == "compute_sx":
        return "sx_block" if len(kwargs["azimuths"]) == 1 else auto_kernel
    return None


def band_halo(driver, kwargs, reader):
    """Rows of halo the runner reads above and below a band for this call,
    at its largest scale, as ``TiledRunner`` derives them."""
    from topo_descriptors_tpu_torch.host import (
        gaussian_radius,
        get_sigmas,
        rotated_extent,
        scale_to_pixel,
        sx_offsets,
        sx_sweep_offsets,
    )

    if driver == "compute_sx":
        res = reader.grid.resolution_meters()
        dx, dy = float(res["x"].mean()), float(res["y"].mean())
        azimuths, radius = kwargs["azimuths"], kwargs["radius"]
        if len(azimuths) == 1:
            return int(sx_offsets(azimuths[0], radius, dx, dy)[2])
        return int(sx_sweep_offsets(azimuths, radius, dx, dy)[2])
    sizes, _ = scale_to_pixel(kwargs["scales"], reader)
    sigmas = sizes / 4  # scale_pxl / scale_std
    if driver == "compute_dem":
        halos = [gaussian_radius(s) for s in sigmas]
    elif driver == "compute_tpi_std":
        halos = [int(n) // 2 for n in sizes]
    elif driver == "compute_gradient":
        halos = [1 if s <= 1 else gaussian_radius(s) + 1 for s in sigmas]
    else:
        smooth = get_sigmas([kwargs.get("smth_factors")] * len(sizes), sizes)
        halos = [rotated_extent(int(n))[0] // 2 + 1 + (gaussian_radius(s) if s else 0)
                 for n, s in zip(sizes, smooth)]
    return int(max(halos))


def with_holes(raster, holes):
    data = np.array(raster.data)
    for rows, cols, value in holes:
        data[rows, cols] = value
    return raster.with_data(data)


def ingest(path):
    """(ind_nans, filled Raster) of a whole GeoTIFF as its window reader
    serves it: the single-pass drivers' input."""
    from topo_descriptors_tpu_torch.host import DemWindowReader, Raster

    with DemWindowReader(path) as reader:
        h = reader.shape[0]
        filled = Raster(data=reader.read_rows(0, h), grid=reader.grid, name="DEM", units="m")
        return np.where(reader.nan_rows(0, h)), filled


class MemoryBandWriter:
    """The band writer's interface (``write_rows``, ``close``, ``abort``)
    over a host array; ``close`` publishes the raster into ``store``."""

    def __init__(self, store, key, dem, name, units):
        self.store, self.key = store, key
        self.meta = dict(grid=dem.grid, name=name, units=units, attrs=dict(dem.attrs))
        self.data = np.full(dem.shape, np.nan, np.float32)
        self.rows = 0
        self.state = "open"

    def write_rows(self, r0, block):
        self.data[r0 : r0 + block.shape[0]] = block
        self.rows += block.shape[0]

    def close(self):
        from topo_descriptors_tpu_torch.host import Raster

        check(self.rows == self.data.shape[0], f"{self.key}: {self.rows} rows written")
        self.store[self.key] = Raster(data=self.data, **self.meta)
        self.state = "closed"

    def abort(self):
        self.state = "aborted"


@contextlib.contextmanager
def memory_band_writers(store, writer=MemoryBandWriter):
    """Keep the streaming drivers' outputs in ``store``, keyed
    ``"<outdir name>/<variable>"``, through their one writer seam
    (``streaming._open_writer``; the NetCDF band writer needs h5py).
    Yields the list of writers opened."""
    from topo_descriptors_tpu_torch import streaming

    opened = []

    def open_writer(dem, name, outdir, units):
        name = str.upper(name)
        opened.append(writer(store, f"{Path(outdir).name}/{name}", dem, name, units))
        return Path(outdir) / f"topo_{name}.nc", opened[-1]

    saved = streaming._open_writer
    streaming._open_writer = open_writer
    try:
        yield opened
    finally:
        streaming._open_writer = saved


def read_outputs(outdir, store):
    """The NetCDF outputs in ``outdir`` into ``store`` (where h5py wrote them)."""
    from topo_descriptors_tpu_torch.host import read_raster

    for f in sorted(Path(outdir).glob("topo_*.nc")):
        r = read_raster(f)
        store[f"{Path(outdir).name}/{r.name}"] = r


@contextlib.contextmanager
def busy_seconds(on):
    """Yields a function that gives, after the block, the card's busy
    seconds in it (``utils.profiling.device_busy_s``: the union of the
    device intervals of a torch.profiler trace, None if it holds none), or
    None when ``on`` is false."""
    if not on:
        yield lambda: None
        return
    from torch.profiler import ProfilerActivity, profile

    from topo_descriptors_tpu_torch.utils.profiling import device_busy_s, device_spans

    result = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield lambda: result.get("busy")
    result["busy"] = device_busy_s(device_spans(prof))


def stream_drivers(path, calls, use_h5py, tmp, prefix, tile_rows, pipeline=True, profile=False):
    """Run the streaming ``calls`` on the GeoTIFF at ``path``, each through
    a fresh window reader, with the kernel counts set to 0 just before the
    call and read just after. Returns the outputs keyed
    ``"<prefix><i>/<variable>"`` and one record per call: wall seconds,
    launches, the most rows read at once, the band halo, and with
    ``profile`` the card's busy seconds."""
    from topo_descriptors_tpu_torch import streaming
    from topo_descriptors_tpu_torch.host import DemWindowReader

    store, records = {}, []
    with contextlib.ExitStack() as stack:
        if not use_h5py:
            stack.enter_context(memory_band_writers(store))
        for i, (driver, kwargs) in enumerate(calls):
            outdir = Path(tmp) / f"{prefix}{i}"
            with DemWindowReader(path) as reader:
                with busy_seconds(profile) as busy:
                    reset_launches()
                    start = time.perf_counter()
                    getattr(streaming, driver)(reader, outdir=outdir, tile_rows=tile_rows,
                                               pipeline=pipeline, **kwargs)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - start
                    launches = read_launches()
                records.append(dict(wall=wall, launches=launches, routes=read_route_launches(),
                                    rows=reader.max_rows_read,
                                    halo=band_halo(driver, kwargs, reader), busy=busy(),
                                    n_rows=reader.shape[0]))
            if use_h5py:
                read_outputs(outdir, store)
    return store, records


def check_bands(label, driver, kwargs, rec, tile_rows, auto_kernel):
    """Out of core in fact: no read above one band and both halos, and the
    family's kernel launched at least once per band (a fan kernel on its
    tile route)."""
    bound = min(rec["n_rows"], tile_rows + 2 * rec["halo"])
    n_bands = -(-rec["n_rows"] // tile_rows)
    kernel = band_kernel(driver, kwargs, auto_kernel)
    print(f"[ooc] {label}: {n_bands} bands, wall {rec['wall']:.3f} s, max rows read "
          f"{rec['rows']} (bound {bound}, halo {rec['halo']}), launches {rec['launches']}")
    check(rec["rows"] <= bound, f"{label}: read {rec['rows']} rows at once, bound {bound}")
    if kernel is not None:
        check(rec["launches"][kernel] >= n_bands,
              f"{label}: {kernel} launched {rec['launches'][kernel]} times for {n_bands} bands")
    if kernel in ("sx_sweep", "sx_fan"):
        check(rec["routes"][kernel]["tile"] >= n_bands,
              f"{label}: {kernel} routes {rec['routes'][kernel]} for {n_bands} bands")


def compare_to_single(label, out, call, ref, ref_call, tag="ooc"):
    """Every output of one streamed, tiled or sharded ``call`` against the
    single pass ``ref_call`` on the same filled grid: Sx bit for bit (a band
    or block reads the same neighbours with the same code), TPI and STD as
    phase 4, DEM and gradient as phase 6, valley/ridge as
    :func:`valley_agree`."""
    names = sorted(k.split("/")[1] for k in ref if k.startswith(f"{ref_call}/"))
    got = sorted(k.split("/")[1] for k in out if k.startswith(f"{call}/"))
    check(bool(names) and got == names, f"{label}: outputs {got}, expected {names}")
    lines = []
    for var in names:
        a, b = out[f"{call}/{var}"].data, ref[f"{ref_call}/{var}"].data
        check(a.shape == b.shape and a.dtype == np.float32, f"{label} {var}: {a.shape} {a.dtype}")
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{label} {var}: NaN positions differ")
        check(np.isfinite(np.nanmax(np.abs(a))), f"{label} {var}: no finite values")
        kind = var.split("_")[0]
        if kind == "SX":
            check(same_bits(torch.from_numpy(a), torch.from_numpy(b)),
                  f"{label} {var}: not bit-equal to the single pass")
            continue
        if kind in ("VALLEY", "RIDGE"):
            if "_NORM_" in var:
                pair = [var, var.replace("_NORM_", "_DIR_")]
                valley_agree(f"{label} {var}", tuple(out[f"{call}/{v}"].data for v in pair),
                             tuple(ref[f"{ref_call}/{v}"].data for v in pair), tag=tag)
            continue
        if kind in ("TPI", "STD"):
            err, tol, unit = disk_sx_error(kind, a, b)
            ok, tol = err <= tol, f"{tol} {unit}"
        else:
            slope = ref[f"{ref_call}/{var.replace('ASPECT', 'SLOPE')}"].data if kind == "ASPECT" else None
            err, tol, ok = field_check(kind, a, b, slope)
        lines.append(f"{var} {err:.6g} ({tol})")
        check(ok, f"{label} {var}: {err} against the single pass ({tol})")
    if sx := sum(n.startswith("SX") for n in names):
        lines.append(f"{sx} Sx plane(s) bit-equal")
    if lines:
        print(f"[{tag}] {label} vs single pass: " + "; ".join(lines))


def same_outputs(label, a, a_call, b, b_call):
    """Two runs' outputs of one call, bit for bit."""
    names = sorted(k.split("/")[1] for k in b if k.startswith(f"{b_call}/"))
    check(bool(names), f"{label}: no outputs")
    for var in names:
        check(f"{a_call}/{var}" in a and np.array_equal(a[f"{a_call}/{var}"].data.view(np.int32),
                                                      b[f"{b_call}/{var}"].data.view(np.int32)),
              f"{label}: {var} differs")
    print(f"[ooc] {label}: {len(names)} outputs bit-equal")


def host_rss_gib():
    """Resident memory of this process in GiB (VmRSS)."""
    with open("/proc/self/status") as f:
        line = next(line for line in f if line.startswith("VmRSS:"))
    return int(line.split()[1]) / 2**20


@contextlib.contextmanager
def rss_peak(period_s=0.05):
    """Yields a function that gives, after the block, the largest resident
    set sampled in it every ``period_s`` seconds (GiB): the peak of one call,
    which the process-wide high-water mark cannot give after the earlier
    phases."""
    peak, stop = [host_rss_gib()], threading.Event()

    def sample():
        while not stop.wait(period_s):
            peak[0] = max(peak[0], host_rss_gib())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield lambda: peak[0]
    finally:
        stop.set()
        thread.join()


def run_big(tif, use_h5py, tmp, smi_line, auto_kernel):
    """The 8192 x 8192 families, one at a time: the single pass (peak
    device memory), the streamed pipelined run under the profiler (wall,
    Mpixel/s, the card's idle share, peak device and host memory), for
    TPI+STD the serial run too (same bits, wall), and the comparison."""
    ind_nans, big_ds = ingest(tif)
    mpix = big_ds.data.size / 1e6
    launches = dict.fromkeys(("disk_sat", "sx_block", "sx_sweep", "sx_fan"), 0)
    for j, (driver, kwargs) in enumerate(big_calls()):
        label = call_label("8192x8192", driver, kwargs)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ref, walls = run_drivers(big_ds, [single_pass_call(driver, kwargs, ind_nans)], use_h5py,
                                 prefix=f"ref{j}_")
        single_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rss_before = host_rss_gib()
        with rss_peak() as host_peak:
            out, (rec,) = stream_drivers(tif, [(driver, kwargs)], use_h5py, tmp, f"big{j}_",
                                         BIG_TILE, profile=True)
        stream_peak = torch.cuda.max_memory_allocated() - base
        for kernel, n in rec["launches"].items():
            launches[kernel] += n
        check_bands(label, driver, kwargs, rec, BIG_TILE, auto_kernel)
        compare_to_single(label, out, f"big{j}_0", ref, f"ref{j}_0")
        busy = rec["busy"]
        idle = "not measured (no device event in the trace)" if busy is None else (
            f"{busy:.4f} s busy, idle share {1 - busy / rec['wall']:.4f}")
        print(f"[time] {label} streamed pipelined from a deflate GeoTIFF: wall {rec['wall']:.3f} s "
              f"({mpix / rec['wall']:.2f} Mpixel/s end to end), card {idle}; single pass from "
              f"memory {walls[0]:.3f} s ({mpix / walls[0]:.2f} Mpixel/s) on {smi_line}")
        print(f"[ooc] {label} peak device memory: streamed {stream_peak / 2**30:.3f} GiB, single "
              f"pass {single_peak / 2**30:.3f} GiB (ratio {stream_peak / single_peak:.3f}); host "
              f"RSS {rss_before:.2f} GiB before the streamed call, peak {host_peak():.2f} GiB "
              f"in it (sampled every 50 ms; the call's outputs stay in host memory)")
        if driver == "compute_tpi_std":
            check(stream_peak < DEVICE_MEMORY_SHARE * single_peak,
                  f"{label}: streamed peak {stream_peak} not below {DEVICE_MEMORY_SHARE} of "
                  f"{single_peak}")
            serial, (srec,) = stream_drivers(tif, [(driver, kwargs)], use_h5py, tmp, "bigserial",
                                             BIG_TILE, pipeline=False, profile=True)
            for kernel, n in srec["launches"].items():
                launches[kernel] += n
            same_outputs(f"{label} pipelined vs serial", out, f"big{j}_0", serial, "bigserial0")
            sbusy = "not measured" if srec["busy"] is None else f"{srec['busy']:.4f} s busy"
            print(f"[time] {label} serial band loop: wall {srec['wall']:.3f} s (card {sbusy}); "
                  f"pipelined {rec['wall']:.3f} s: the overlap saves "
                  f"{1 - rec['wall'] / srec['wall']:.4f} of the serial wall on {smi_line}")
        del ref, out
    return launches


def run_out_of_core(baso, big, use_h5py, smi_line, auto_kernel):
    """Phase 7: the streaming drivers, the tiled pipeline backend and the
    CLI's ``--stream`` on the card, from deflate strip GeoTIFFs. Returns the
    hand kernels' launches in the streamed and tiled calls."""
    from topo_descriptors_tpu_torch import cli, streaming
    from topo_descriptors_tpu_torch.host import write_geotiff
    from topo_descriptors_tpu_torch.parallel import TiledRunner

    t0 = time.perf_counter()
    launches = dict.fromkeys(("disk_sat", "sx_block", "sx_sweep", "sx_fan"), 0)
    with tempfile.TemporaryDirectory() as tmp:
        tifs = {"900x1440": Path(tmp) / "baso.tif", "8192x8192": Path(tmp) / "big.tif"}
        write_geotiff(baso, tifs["900x1440"], compress=True, rows_per_strip=16)
        write_geotiff(big, tifs["8192x8192"], compress=True, rows_per_strip=64)
        print(f"[ooc] deflate strip GeoTIFFs written in {time.perf_counter() - t0:.2f} s")

        tif = tifs["900x1440"]
        ind_nans, dem_ds = ingest(tif)
        calls = ooc_calls()
        ref, _ = run_drivers(dem_ds, [single_pass_call(d, k, ind_nans) for d, k in calls],
                             use_h5py, prefix="ref")
        out, records = stream_drivers(tif, calls, use_h5py, tmp, "ooc", OOC_TILE)
        for i, ((driver, kwargs), rec) in enumerate(zip(calls, records)):
            label = call_label("900x1440", driver, kwargs)
            for kernel, n in rec["launches"].items():
                launches[kernel] += n
            check_bands(label, driver, kwargs, rec, OOC_TILE, auto_kernel)
            compare_to_single(label, out, f"ooc{i}", ref, f"ref{i}")
        check(np.isnan(out["ooc1/TPI_500M"].data[ind_nans]).all(), "NaN holes not reassigned")

        fan = len(calls) - 1
        serial, (srec,) = stream_drivers(tif, [calls[fan]], use_h5py, tmp, "serial", OOC_TILE,
                                         pipeline=False)
        same_outputs("900x1440 36-azimuth Sx fan pipelined vs serial", out, f"ooc{fan}",
                     serial, "serial0")
        print(f"[time] 900x1440 36-azimuth Sx fan streamed: pipelined {records[fan]['wall']:.3f} s, "
              f"serial {srec['wall']:.3f} s on {smi_line}")

        tiled_idx = [i for i, (d, _) in enumerate(calls)
                     if d in ("compute_dem", "compute_tpi_std", "compute_gradient")] + [fan]
        tiled_calls = []
        for i in tiled_idx:
            driver, kwargs = single_pass_call(*calls[i], ind_nans)
            tiled_calls.append((driver, dict(kwargs, sharded=TiledRunner(OOC_TILE))))
        reset_launches()
        tiled, walls = run_drivers(dem_ds, tiled_calls, use_h5py, prefix="tiled")
        for kernel, n in read_launches().items():
            launches[kernel] += n
        for j, i in enumerate(tiled_idx):
            compare_to_single(f"900x1440 pipeline.{tiled_calls[j][0]} sharded=TiledRunner"
                              f"({OOC_TILE}) in {walls[j]:.3f} s", tiled, f"tiled{j}", ref, f"ref{i}")

        cli_store = {}
        with contextlib.ExitStack() as stack:
            if not use_h5py:
                stack.enter_context(memory_band_writers(cli_store))
            check(cli.main(["--dem", str(tif), "--outdir", str(Path(tmp) / "cli"),
                            "--descriptors", "tpi", "std", "sx", "--scales", "500", "2000",
                            "--sx-azimuths", "0", "--sx-radius", "500",
                            "--stream", str(OOC_TILE)]) == 0, "the CLI failed")
        if use_h5py:
            read_outputs(Path(tmp) / "cli", cli_store)
        check(len(cli_store) == 5, f"CLI outputs {sorted(cli_store)}")
        same_outputs("CLI --stream TPI+STD vs compute_tpi_std", cli_store, "cli", out, "ooc1")
        same_outputs("CLI --stream Sx vs compute_sx", cli_store, "cli", out, "ooc5")

        class FailingWriter(MemoryBandWriter):
            def write_rows(self, r0, block):
                if r0 >= 2 * OOC_TILE:
                    raise OSError("writer failed on its third band")
                super().write_rows(r0, block)

        failed = {}
        with memory_band_writers(failed, FailingWriter) as opened:
            try:
                streaming.compute_tpi_std(tif, [500, 2000], outdir=Path(tmp) / "c1",
                                          tile_rows=OOC_TILE)
                raised = None
            except OSError as exc:
                raised = exc
        check(raised is not None and "third band" in str(raised), f"C1: raised {raised!r}")
        states = [w.state for w in opened]
        check(len(opened) == 4 and set(states) == {"aborted"} and not failed,
              f"C1: writers {states}, published {sorted(failed)}")
        print(f"[ooc] C1: a writer failing on its third band re-raised ({raised}); all "
              f"{len(opened)} writers of the call aborted, none published")
        print(f"[ooc] 900x1440 done at {time.perf_counter() - t0:.1f} s")

        del ref, out, serial, tiled, cli_store
        for kernel, n in run_big(tifs["8192x8192"], use_h5py, tmp, smi_line, auto_kernel).items():
            launches[kernel] += n
    print(f"[ooc] done in {time.perf_counter() - t0:.1f} s, launches in the streamed and tiled "
          f"calls {launches}")
    for kernel in ("disk_sat", "sx_block", auto_kernel):
        check(launches[kernel] > 0, f"the out-of-core path launched no {kernel}: {launches}")
    return launches


# --- phase 8: the mesh on the card ------------------------------------------------

MESH_SIZES = (17, 67, 201)  # 500 m, 2 km and 6 km disks at 30 m: both disk_sat routes
HAND_KERNELS = ("disk_sat", "sx_block", "sx_sweep", "sx_fan")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def counted(fn):
    """(``fn()``, the hand kernels' launches in it): the counts set to 0
    just before the call and read just after it."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, read_launches()


def mesh_op_cases(dem_ds, auto_kernel):
    """``(label, kinds, sharded(sops, x, vs), single(dem), {kernel: launches
    per block}, fill)`` of every ShardedOps method on ``dem_ds``'s grid:
    TPI, STD and the fused batch at MESH_SIZES, the Gaussian at 2 km, the
    gradient at 100 m (Sobel) and 2 km, valley at 2 km (the bank route), Sx
    at 500 m and the 36-azimuth sweep at 200 m. ``fill`` pads a ragged grid
    as the drivers do (NaN for Sx)."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import scale_to_pixel, sx_offsets, sx_sweep_offsets

    (n2,), res = scale_to_pixel([2000], dem_ds)
    n2, s2 = int(n2), float(n2) / 4  # the driver's sigma: scale_pxl / scale_std
    dx, dy = float(res["x"].mean()), float(res["y"].mean())
    o, d, b = sx_offsets(0.0, 500.0, dx, dy)
    so, sd, sb = sx_sweep_offsets(SWEEP_AZIMUTHS, 200.0, dx, dy)
    cases = []
    for n in MESH_SIZES:
        cases += [
            (f"tpi {n} px", ("TPI",), lambda s, x, vs, n=n: [s.tpi(x, n, **vs)],
             lambda t, n=n: [ops.tpi(t, n, device=t.device)], {"disk_sat": 1}, 0.0),
            (f"std {n} px", ("STD",), lambda s, x, vs, n=n: [s.std(x, n, **vs)],
             lambda t, n=n: [ops.std(t, n, device=t.device)], {"disk_sat": 1}, 0.0),
        ]

    def fused(s, x, vs):
        batch = s.disk_descriptors(x, MESH_SIZES, **vs)
        return [batch["tpi"], batch["std"]]

    def fused_single(t):
        batch = ops.disk_descriptors(t, MESH_SIZES, device=t.device)
        return [batch["tpi"], batch["std"]]

    grad = ("WE", "SN", "SLOPE", "ASPECT")
    cases += [
        (f"fused tpi+std {MESH_SIZES} px", ("TPI", "STD"), fused, fused_single,
         {"disk_sat": len(MESH_SIZES)}, 0.0),
        (f"gaussian 2 km (sigma {s2})", ("DEM",), lambda s, x, vs: [s.gaussian(x, s2, **vs)],
         lambda t: [ops.gaussian_filter(t, s2)], {}, 0.0),
        ("gradient 100 m (Sobel)", grad, lambda s, x, vs: s.gradient(x, 0.75, res, **vs),
         lambda t: ops.gradient(t, 0.75, res, device=t.device), {}, 0.0),
        (f"gradient 2 km (sigma {s2})", grad, lambda s, x, vs: s.gradient(x, s2, res, **vs),
         lambda t: ops.gradient(t, s2, res, device=t.device), {}, 0.0),
        (f"valley 2 km ({n2} px, bank)", ("VALLEY",),
         lambda s, x, vs: s.valley_ridge(x, n2, "valley", VALLEY_FLATS, **vs),
         lambda t: ops.valley_ridge(t, n2, "valley", VALLEY_FLATS, device=t.device), {}, 0.0),
        ("sx 500 m", ("SX",), lambda s, x, vs: [s.sx(x, o, d, b, **vs)],
         lambda t: [ops.sx(t, o, d, b, device=t.device)], {"sx_block": 1}, np.nan),
        ("sx sweep 36 az r200", ("SX",), lambda s, x, vs: [s.sx_sweep(x, so, sd, sb, **vs)],
         lambda t: [ops.sx_sweep(t, so, sd, sb, device=t.device)], {auto_kernel: 1}, np.nan),
    ]
    return cases


def compare_mesh(label, kinds, outs, refs):
    """Sharded outputs against the single pass: Sx bit for bit, TPI and STD
    as phase 4, DEM and gradient as phase 6, valley as :func:`valley_agree`."""
    if kinds == ("VALLEY",):
        valley_agree(label, tuple(outs), tuple(refs), tag="mesh")
        return
    lines = []
    for kind, a, b in zip(kinds, outs, refs):
        check(a.shape == b.shape and a.dtype == np.float32, f"{label} {kind}: {a.shape} {a.dtype}")
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{label} {kind}: NaN positions differ")
        check(np.isfinite(np.nanmax(np.abs(a))), f"{label} {kind}: no finite values")
        if kind == "SX":
            check(np.array_equal(a.view(np.int32), b.view(np.int32)),
                  f"{label}: not bit-equal to the single pass")
            lines.append(f"{a.shape} bit-equal")
            continue
        if kind in ("TPI", "STD"):
            err, tol, unit = disk_sx_error(kind, a, b)
            ok, tol = err <= tol, f"{tol} {unit}"
        else:
            slope = refs[kinds.index("SLOPE")] if kind == "ASPECT" else None
            err, tol, ok = field_check(kind, a, b, slope)
        lines.append(f"{kind} {err:.6g} ({tol})")
        check(ok, f"{label} {kind}: {err} against the single pass ({tol})")
    print(f"[mesh] {label} vs single pass: " + "; ".join(lines))


def mesh_grid(sops, dem_ds, grid, auto_kernel, launches):
    """Every ShardedOps method on ``dem_ds`` (padded to the mesh where
    ragged) against the single pass on the card; each call must launch its
    hand kernel once per block and convolution, and no other."""
    from topo_descriptors_tpu_torch.parallel import pad_to_mesh

    data = np.ascontiguousarray(dem_ds.data, np.float32)
    h, w = data.shape
    single_dem = torch.from_numpy(data).cuda()
    ragged = h % sops.gy or w % sops.gx
    vs = {"valid_shape": (h, w)} if ragged else {}
    placed = {}
    n_blocks = len(sops.mesh.local_blocks())
    for label, kinds, sharded, single, per_block, fill in mesh_op_cases(dem_ds, auto_kernel):
        key = "nan" if np.isnan(fill) else "zero"
        if key not in placed:
            placed[key] = sops.put(pad_to_mesh(data, sops.mesh, fill=fill)[0])
        start = time.perf_counter()
        out, got = counted(lambda: sharded(sops, placed[key], vs))
        wall = time.perf_counter() - start
        expect = {k: per_block.get(k, 0) * n_blocks for k in HAND_KERNELS}
        check(got == expect, f"{grid} {label}: launches {got}, expected {expect}")
        for k, n in got.items():
            launches[k] += n
        outs = [np.asarray(a.numpy())[..., :h, :w] for a in out]
        refs = [t.cpu().numpy() for t in single(single_dem)]
        compare_mesh(f"{grid} {sops.gy}x{sops.gx}{' ragged' if ragged else ''} {label} "
                     f"({wall:.3f} s, launches {({k: n for k, n in got.items() if n})})",
                     kinds, outs, refs)


def mesh_nccl_1x1(dem_ds, ind_nans, use_h5py, auto_kernel, launches):
    """A 1x1 mesh under a one-rank NCCL group (``runtime.initialize``)
    through the drivers, against the drivers without a mesh."""
    import torch.distributed as dist

    from topo_descriptors_tpu_torch.parallel import ShardedOps, make_mesh, runtime

    check(runtime.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0),
          "runtime.initialize joined no group")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"backend {dist.get_backend()}")
        sops = ShardedOps(make_mesh((1, 1)))
        calls = [("compute_tpi", dict(scales=[2000], ind_nans=ind_nans), "disk_sat"),
                 ("compute_sx", dict(azimuth=0, radius=500), "sx_block"),
                 ("compute_sx_sweep", dict(azimuths=SWEEP_AZIMUTHS, radius=2000), auto_kernel)]
        for j, (driver, kwargs, kernel) in enumerate(calls):
            (out, _), got = counted(lambda: run_drivers(
                dem_ds, [(driver, dict(kwargs, sharded=sops))], use_h5py, prefix=f"nccl{j}_"))
            check(got[kernel] == 1, f"1x1 NCCL {driver}: launches {got}")
            launches[kernel] += got[kernel]
            ref, _ = run_drivers(dem_ds, [(driver, kwargs)], use_h5py, prefix=f"ref{j}_")
            compare_to_single(f"1x1 mesh, one-rank NCCL group ({sops.mesh.entries}): {driver} "
                              f"(launches {got[kernel]} {kernel})",
                              out, f"nccl{j}_0", ref, f"ref{j}_0", tag="mesh")
    finally:
        dist.destroy_process_group()


def mesh_multihop(dem_ds, launches):
    """A 2 km Sx on a (4, 1) mesh of a 200-row crop: 50-row blocks against a
    67-px ray border, so each halo takes two hops."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import sx_offsets
    from topo_descriptors_tpu_torch.parallel import ShardedOps, make_mesh

    crop = np.ascontiguousarray(dem_ds.data[:200], np.float32)
    sops = ShardedOps(make_mesh((4, 1), ["cuda:0"] * 4))
    x, t = sops.put(crop), torch.from_numpy(crop).cuda()
    rows = x.block_shape[0]
    for az in (0.0, 180.0):
        o, d, b = sx_offsets(az, 2000.0, 30.0, 30.0)
        check(b > rows, f"border {b} does not exceed the {rows}-row blocks")
        out, got = counted(lambda: sops.sx(x, o, d, b))
        check(got["sx_block"] == 4, f"multi-hop Sx: launches {got}")
        launches["sx_block"] += 4
        compare_mesh(f"{crop.shape} (4, 1) Sx 2 km azimuth {az:g}, border {b} over {rows}-row "
                     f"blocks ({-(-b // rows)} hops)", ("SX",), [out.numpy()],
                     [ops.sx(t, o, d, b, device=t.device).cpu().numpy()])


def mesh_timing(grids_np, smi_line, launches):
    """TPI-2000m and Sx-500m on a 2x2 mesh of four blocks on cuda:0 against
    the single pass (CUDA events, median of 20, the DEM already on the card
    for both), with the halo exchange alone timed beside them. Four blocks
    on one card share its SMs and memory: no scaling figure."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import sx_dedupe, sx_offsets
    from topo_descriptors_tpu_torch.parallel import ShardedOps, exchange_halo, make_mesh

    sops = ShardedOps(make_mesh((2, 2), ["cuda:0"] * 4))
    o, d, b = sx_offsets(0.0, 500.0, 30.0, 30.0)
    times = {}
    for grid, data in grids_np.items():
        t, x = torch.from_numpy(data).cuda(), sops.put(data)
        mpix = data.size / 1e6
        def uncached():  # the count planes rebuilt in each call, as ops.tpi does
            sops._cache.clear()
            return sops.tpi(x, 67)

        rows = [
            ("TPI-2000m", "TPI", lambda: ops.tpi(t, 67, device=t.device), lambda: sops.tpi(x, 67),
             lambda: exchange_halo(x.blocks, sops.mesh, 33, 33, "zero"), "disk_sat", uncached),
            ("Sx-500m", "SX", lambda: ops.sx(t, o, d, b, device=t.device),
             lambda: sops.sx(x, o, d, b), lambda: exchange_halo(x.blocks, sops.mesh, b, b, "nan"),
             "sx_block", None),
        ]
        for label, kind, single, sharded, halo, kernel, cold in rows:
            out, got = counted(sharded)
            check(got[kernel] == 4, f"{grid} {label} on 2x2: launches {got}")
            launches[kernel] += 4
            compare_mesh(f"{grid} 2x2 {label}", (kind,), [out.numpy()], [single().cpu().numpy()])
            reset_launches()
            t_single, t_sharded, t_halo = median_ms(single), median_ms(sharded), median_ms(halo)
            times[(label, grid)] = dict(single=t_single, sharded=t_sharded, halo=t_halo)
            extra = ""
            if cold is not None:
                times[(label, grid)]["uncached"] = t_cold = median_ms(cold)
                extra = f"; the mesh with its count planes rebuilt per call {t_cold:.4f} ms"
            print(f"[time] {label} {grid}: single pass {t_single:.4f} ms "
                  f"({mpix / t_single * 1e3:.1f} Mpixel/s); 2x2 mesh of four blocks on cuda:0 "
                  f"{t_sharded:.4f} ms ({mpix / t_sharded * 1e3:.1f} Mpixel/s; "
                  f"{t_sharded / t_single:.3f} x the single pass), its halo exchange alone "
                  f"{t_halo:.4f} ms ({t_halo / t_sharded:.3f} of the mesh wall; median of "
                  f"{TIMING_REPS}){extra} on {smi_line}")
        del t, x
    return times


def gloo_worker(rank, port, queue):
    """One rank of phase 8's two-process gloo group on cuda:0: two blocks of
    a 2x2 mesh (rank 0 the top row), TPI 67 px and Sx 500 m at 900 x 1440,
    its own blocks held against the single pass on the card. Puts ``(rank,
    result)`` on ``queue``; an exception is put as its text and raised."""
    try:
        import torch.distributed as dist

        from topo_descriptors_tpu_torch import ops
        from topo_descriptors_tpu_torch.host import basodino_like_dem, sx_offsets
        from topo_descriptors_tpu_torch.parallel import ShardedOps, make_mesh, runtime

        torch.cuda.set_device(0)
        check(runtime.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                                 backend="gloo"), "no group")
        mesh = make_mesh((2, 2), ["cuda:0"] * 2)
        check(mesh.multi_process and [b[0] for b in mesh.local_blocks()] == [rank, rank],
              f"rank {rank} holds {mesh.local_blocks()}")
        sops = ShardedOps(mesh)
        data = basodino_like_dem(projected=True).data.astype(np.float32)
        bh, bw = 450, 720
        blocks = [data[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw] for i, j in mesh.local_blocks()]
        x = runtime.host_local_to_global(mesh, blocks)
        dem = torch.from_numpy(data).cuda()
        o, d, b = sx_offsets(0.0, 500.0, 30.0, 30.0)
        tpi, got_tpi = counted(lambda: sops.tpi(x, 67))
        sx, got_sx = counted(lambda: sops.sx(x, o, d, b))
        ref_tpi = ops.tpi(dem, 67, device=dem.device).cpu().numpy()
        ref_sx = ops.sx(dem, o, d, b, device=dem.device).cpu().numpy()
        err, sx_bits = 0.0, True
        for (i, j), block in tpi.blocks.items():
            err = max(err, float(np.abs(block.cpu().numpy()
                                        - ref_tpi[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw]).max()))
        for (i, j), block in sx.blocks.items():
            want = ref_sx[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw]
            sx_bits &= bool(np.array_equal(block.cpu().numpy().view(np.int32), want.view(np.int32)))
        dist.destroy_process_group()
        queue.put((rank, dict(blocks=mesh.local_blocks(), tpi_err=err, sx_bits=sx_bits,
                              launches={"disk_sat": got_tpi["disk_sat"],
                                        "sx_block": got_sx["sx_block"]})))
    except BaseException as exc:
        queue.put((rank, f"{type(exc).__name__}: {exc}"))
        raise


def mesh_two_processes(launches):
    """Two spawned processes in one gloo group, two blocks each on cuda:0
    (the kernels were built by this process before)."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    start = time.perf_counter()
    procs = [ctx.Process(target=gloo_worker, args=(rank, port, q)) for rank in range(2)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + 300
    try:
        while len(results) < len(procs):
            try:
                rank, res = q.get(timeout=1)
                results[rank] = res
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None
                        and r not in results]
                if dead:  # a result put just before the exit may still be in the pipe
                    with contextlib.suppress(queue_mod.Empty):
                        rank, res = q.get(timeout=5)
                        results[rank] = res
                    dead = [r for r in dead if r not in results]
                check(not dead, f"gloo rank(s) {dead} exited without a result")
                check(time.monotonic() < deadline,
                      f"two-process gloo run: no result after 300 s ({results})")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(2):
        res = results.get(rank)
        check(isinstance(res, dict), f"gloo rank {rank} failed: {res}")
        check(procs[rank].exitcode == 0, f"gloo rank {rank} exit code {procs[rank].exitcode}")
        check(res["tpi_err"] <= 1e-2 and res["sx_bits"],
              f"gloo rank {rank}: TPI error {res['tpi_err']}, Sx bit-equal {res['sx_bits']}")
        check(res["launches"] == {"disk_sat": 2, "sx_block": 2},
              f"gloo rank {rank}: launches {res['launches']}")
        for k, n in res["launches"].items():
            launches[k] += n
        print(f"[mesh] two-process gloo group on cuda:0, rank {rank} blocks {res['blocks']}: "
              f"TPI 67 px max|mesh-single| {res['tpi_err']:.6g} m (tol 1e-2), Sx 500 m "
              f"bit-equal, launches {res['launches']}")
    print(f"[mesh] two-process gloo run in {time.perf_counter() - start:.1f} s (spawn and CUDA "
          "start-up included)")


def mesh_cli(use_h5py, launches):
    """``cli.main([... --sharded --mesh 1 1])`` on the card against the
    drivers' single pass."""
    from topo_descriptors_tpu_torch import cli
    from topo_descriptors_tpu_torch.host import basodino_like_dem

    store = {}
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.ExitStack() as stack:
            if not use_h5py:
                stack.enter_context(memory_writer(store))
            rc, got = counted(lambda: cli.main([
                "--synthetic", "900x1440", "--outdir", str(Path(tmp) / "climesh"),
                "--descriptors", "tpi", "sx", "--scales", "2000", "--sx-radius", "500",
                "--sharded", "--mesh", "1", "1"]))
        check(rc == 0, "the CLI failed")
        if use_h5py:
            read_outputs(Path(tmp) / "climesh", store)
    check(got["disk_sat"] == 1 and got["sx_block"] == 1, f"CLI --sharded launches {got}")
    for k in ("disk_sat", "sx_block"):
        launches[k] += 1
    ref, _ = run_drivers(basodino_like_dem(900, 1440, projected=True),
                         [("compute_tpi", dict(scales=[2000])),
                          ("compute_sx", dict(azimuth=0, radius=500))], use_h5py, prefix="cliref")
    for j, var in enumerate(("TPI_2000M", "SX_RADIUS500_AZIMUTH0")):
        store[f"clione{j}/{var}"] = store[f"climesh/{var}"]
        compare_to_single(f"CLI --sharded --mesh 1 1 {var}", store, f"clione{j}", ref,
                          f"cliref{j}", tag="mesh")


def run_mesh(baso_ds, ragged_ds, big_np, dem_ds, ind_nans, use_h5py, smi_line, auto_kernel):
    """Phase 8: the mesh on the card. Returns the hand kernels' launches in
    the sharded calls and the 2x2 times."""
    from topo_descriptors_tpu_torch.parallel import ShardedOps, make_mesh

    t0 = time.perf_counter()
    launches = dict.fromkeys(HAND_KERNELS, 0)
    mesh_nccl_1x1(dem_ds, ind_nans, use_h5py, auto_kernel, launches)
    sops = ShardedOps(make_mesh((2, 2), ["cuda:0"] * 4))
    mesh_grid(sops, baso_ds, "900x1440", auto_kernel, launches)
    mesh_grid(sops, ragged_ds, "1000x1337", auto_kernel, launches)
    mesh_multihop(baso_ds, launches)
    times = mesh_timing({"900x1440": np.ascontiguousarray(baso_ds.data, np.float32),
                         "8192x8192": big_np}, smi_line, launches)
    mesh_two_processes(launches)
    mesh_cli(use_h5py, launches)
    print(f"[mesh] done in {time.perf_counter() - t0:.1f} s, launches in the sharded calls "
          f"{launches}")
    for kernel in ("disk_sat", "sx_block", auto_kernel):
        check(launches[kernel] > 0, f"the mesh launched no {kernel}: {launches}")
    return launches, times


# --- phase 9: profiling and the reference batch on the card ----------------------

SHARE_MAX = 1.05  # a floor above the measured time by more than this: the model is wrong
STREAM_BATCH = 48  # kernels per step of the streamed route: 4 variants x q_batch 4 x 3 flats
LARGEST_M = 100000  # the batch's largest scale: the second FFT calibration shape
FLOOR_SCALES = (30000, 60000, LARGEST_M)  # batch valley/ridge scales shown beside their floors


def roofline(cal=None):
    """The port's ``Roofline``; with ``cal`` (from :func:`calibrate`), this
    run's measured rates in place of the defaults."""
    from topo_descriptors_tpu_torch.utils.profiling import Roofline

    if cal is None:
        return Roofline()
    return Roofline(mm_tmacs=cal["mm_tmacs"], fft_tflops=cal["fft_tflops"],
                    gather_rows_gps=cal["gather_rows_gps"])


def valley_px(dem_ds, scale):
    """(size px, the streamed route's square canvas side) of a valley scale."""
    from topo_descriptors_tpu_torch.host import scale_to_pixel

    vr = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")
    (size,), _ = scale_to_pixel([scale], dem_ds)
    return int(size), vr.streamed_schedule(int(size))[0]


def calibrate(dem_ds, dem, smi_line):
    """The card's rates for the routing cost model and the roofline (CUDA
    events, median of 20, of 3 for a call over 1 s; random kernels: the
    rates do not depend on the values):

    * ``mm_tmacs``: ``conv_bank`` on one chunk of the 2 km bank and on one
      step (48 kernels) of the 20 km streamed route, the mix's MACs (the
      roofline's formula, ``DftConvPlan.macs_per_kernel``) over its time;
      ``mm_macs_per_sec`` is the same rate for ``prefer_dft_matmul``;
    * ``fft_tflops``: the streamed FFT route's kernel convolution (rfft2,
      spectral product, irfft2) on one step at the 5-smooth shapes of
      20 km and 100 km, 5 N log2 N flops per transform; the faster shape's
      rate, a ceiling that no case may beat. ``fft_sec_per_pt``: both
      shapes' time over their transformed points, 2 per kernel as the cost
      model counts them;
    * ``gather_rows_gps``: the rotation-table gather of one 20 km canvas
      (27-float rows), 1e9 rows per second.
    """
    from topo_descriptors_tpu_torch.config import CFG
    from topo_descriptors_tpu_torch.device import upload
    from topo_descriptors_tpu_torch.host import rotated_extent, valley_kernels
    from topo_descriptors_tpu_torch.ops import dft_conv
    from topo_descriptors_tpu_torch.ops.conv import _fft_shape
    from topo_descriptors_tpu_torch.ops.spline_rotate import (
        _footprints,
        build_rotation_table,
        prefilter2d_o2,
    )

    vr = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")
    h, w = dem.shape
    z = (dem - dem.mean()) / dem.std()
    gen = torch.Generator(device=dem.device).manual_seed(0)
    n_bank, _ = valley_px(dem_ds, BANK_M)
    n20, k20 = valley_px(dem_ds, STREAM_M)
    _, k_largest = valley_px(dem_ds, LARGEST_M)

    bank_plan = dft_conv.get_plan(h, w, *rotated_extent(n_bank), "same", dem.device)
    per_angle = bank_plan.fh * bank_plan.nb * 8 * len(VALLEY_FLATS)  # the bank route's chunk
    chunk = int(max(1, min(30, CFG.valley_chunk_bytes // per_angle)))
    while 180 % chunk:
        chunk -= 1
    macs, mm_ms = 0, 0.0
    for label, plan, batch in ((f"{BANK_M} m bank chunk", bank_plan, chunk * len(VALLEY_FLATS)),
                               (f"{STREAM_M} m streamed step",
                                dft_conv.get_plan(h, w, k20, k20, "same", dem.device),
                                STREAM_BATCH)):
        kernels = torch.randn((batch, *plan.kshape), generator=gen, device=dem.device)
        fdr, fdi = dft_conv.field_spectrum(z, plan)
        ms, reps = slow_median_ms(lambda: dft_conv.conv_bank(kernels, fdr, fdi, plan))
        m = plan.macs_per_kernel() * batch
        macs, mm_ms = macs + m, mm_ms + ms
        print(f"[calib] conv_bank {label}: {batch} kernels of {plan.kshape[0]}x{plan.kshape[1]} "
              f"on {h}x{w}, {m:.4g} MACs in {ms:.4f} ms (median of {reps}): "
              f"{m / ms / 1e9:.4f} TMAC/s on {smi_line}")
        del kernels, fdr, fdi
    mm_tmacs = macs / mm_ms / 1e9

    rates, fft_ms, points = [], 0.0, 0
    for scale, kmax in ((STREAM_M, k20), (LARGEST_M, k_largest)):
        conv = vr._fft_conv_fn(z, kmax)
        fh, fw = _fft_shape(h + kmax - 1), _fft_shape(w + kmax - 1)
        kernels = torch.randn((STREAM_BATCH, kmax, kmax), generator=gen, device=dem.device)
        ms, reps = slow_median_ms(lambda: conv(kernels))
        n = fh * fw
        rates.append(STREAM_BATCH * 2 * 5.0 * n * math.log2(n) / ms / 1e9)
        fft_ms, points = fft_ms + ms, points + STREAM_BATCH * 2 * n
        print(f"[calib] FFT route conv {scale} m: {STREAM_BATCH} kernels of {kmax}^2 at {fh}x{fw} "
              f"(5-smooth) in {ms:.4f} ms (median of {reps}): {rates[-1]:.4f} TFLOP/s "
              f"(5 N log2 N per transform), {ms / 1e3 / (STREAM_BATCH * 2 * n):.6g} s per "
              f"transformed point on {smi_line}")
        del conv, kernels
    torch.cuda.empty_cache()

    table = build_rotation_table(prefilter2d_o2(upload(
        valley_kernels(n20, VALLEY_FLATS).astype(np.float32), dem.device)))
    qparams = vr.streamed_schedule(n20)[1]
    mid = len(qparams) // 2
    _, ystart, xstart, _, _ = _footprints(n20, qparams[mid:mid + 1], (k20, k20), dem.device)
    idx = ((ystart + 1) * (n20 + 2) + (xstart + 1)).reshape(-1)
    ms = median_ms(lambda: table[idx])
    gather = idx.numel() / ms / 1e6
    print(f"[calib] rotation-table gather {STREAM_M} m: {idx.numel()} rows of {table.shape[1]} "
          f"floats in {ms:.4f} ms: {gather:.4f} G rows/s on {smi_line}")

    cal = dict(mm_tmacs=mm_tmacs, fft_tflops=max(rates), gather_rows_gps=gather,
               mm_macs_per_sec=mm_tmacs * 1e12, fft_sec_per_pt=fft_ms / 1e3 / points)
    code = roofline()
    print(f"[calib] measured: mm_tmacs {cal['mm_tmacs']:.4f} (in the code: Roofline "
          f"{code.mm_tmacs}, _MM_MACS_PER_SEC {dft_conv._MM_MACS_PER_SEC:.6g}); fft_tflops "
          f"{cal['fft_tflops']:.4f} (Roofline {code.fft_tflops}); fft_sec_per_pt "
          f"{cal['fft_sec_per_pt']:.6g} (_FFT_SEC_PER_PT {dft_conv._FFT_SEC_PER_PT:.6g}); "
          f"gather_rows_gps {cal['gather_rows_gps']:.4f} (Roofline {code.gather_rows_gps}) "
          f"on {smi_line}")
    return cal


def streamed_route(h, w, kmax, **rates):
    """'mm' or 'fft': what ``prefer_dft_matmul`` picks for a kmax canvas on
    an (h, w) field, with the code's constants or the given ``rates``."""
    from topo_descriptors_tpu_torch.ops import dft_conv

    return "mm" if dft_conv.prefer_dft_matmul(h, w, kmax, kmax, **rates) else "fft"


def print_routes(dem_ds, shape, cal, smi_line):
    """The route at each valley/ridge scale of the batch: the bank, or the
    streamed route's choice with the code's constants and with this run's,
    beside the cost model's two times per kernel at this run's rates."""
    from topo_descriptors_tpu_torch.config import CFG
    from topo_descriptors_tpu_torch.examples.compute_topo_descriptors import SCALES_METERS
    from topo_descriptors_tpu_torch.ops import dft_conv

    vr = importlib.import_module("topo_descriptors_tpu_torch.ops.valley_ridge")
    rates = dict(mm_macs_per_sec=cal["mm_macs_per_sec"], fft_sec_per_pt=cal["fft_sec_per_pt"])
    for scale in SCALES_METERS[3:]:
        size, kmax = valley_px(dem_ds, scale)
        if vr.bank_fits(size, len(VALLEY_FLATS)):
            print(f"[calib] {scale} m ({size} px) on {shape}: the bank route (dftmm)")
            continue
        t_mm, t_fft = dft_conv.route_seconds(*shape, kmax, kmax, **rates)
        print(f"[calib] {scale} m ({size} px, kmax {kmax}) on {shape}: streamed route "
              f"{streamed_route(*shape, kmax)} with the code's constants, "
              f"{streamed_route(*shape, kmax, **rates)} with this run's (per kernel: mm "
              f"{t_mm * 1e3:.4f} ms, fft {t_fft * 1e3:.4f} ms) on {smi_line}")


def share_line(label, floor_ms, ms, method, smi_line, tag="roofline"):
    """Print a floor beside a measured time and fail if the floor exceeds
    it by more than SHARE_MAX; returns the share."""
    share = floor_ms / ms
    print(f"[{tag}] {label}: {ms:.4f} ms, floor ({method}) {floor_ms:.4f} ms, share of floor "
          f"{share:.4f} on {smi_line}")
    check(share <= SHARE_MAX, f"{label}: the {method} floor is {share:.4f} of the time; the "
          f"model counts work the card did not do, or a ceiling is too low")
    return share


def check_roofline(dem_ds, dem, cal, smi_line):
    """The roofline with this run's rates beside three measured times: the
    Sx-500m kernel (grouped form), the 2 km dftmm valley and the 20 km
    streamed valley on its route (cold: caches cleared; warm)."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import sx_dedupe, sx_offsets
    from topo_descriptors_tpu_torch.ops.cuda import sx_block

    roof = roofline(cal)
    h, w = dem.shape
    grid = f"{h}x{w}"
    o, d, b = sx_offsets(0.0, 500.0, 30.0, 30.0)
    o, d = sx_dedupe(o, d)
    rays, _, inv = sx_block.ray_groups(o, d)
    share_line(f"Sx-500m sx_block {grid} ({len(rays)} rays, {len(inv)} groups)",
               roof.sx_light_speed_ms(h * w, len(rays), len(inv)),
               median_ms(lambda: sx_block.sx_block(dem, o, d, b, 10.0)), "grouped Sx", smi_line)
    (n_bank, s_bank), (n_stream, s_stream) = valley_sizes(dem_ds).values()
    ms, reps = slow_median_ms(lambda: ops.valley_ridge(
        dem, n_bank, "valley", VALLEY_FLATS, s_bank, method="dftmm", device=dem.device))
    share_line(f"valley {BANK_M} m dftmm {grid} (warm, median of {reps})",
               roof.valley_ridge_light_speed_ms(h, w, n_bank, len(VALLEY_FLATS), 180, "mm_bank"),
               ms, "mm_bank", smi_line)
    route = streamed_route(h, w, valley_px(dem_ds, STREAM_M)[1])

    def stream():
        return ops.valley_ridge_streamed(dem, n_stream, "valley", VALLEY_FLATS, s_stream,
                                         device=dem.device)

    clear_valley_caches()
    cold = median_ms(stream, reps=1, warmup=0)
    warm = median_ms(stream, reps=3, warmup=1)
    for label, ms, method in ((f"cold, {route} route", cold, "mm_stream" if route == "mm" else "fft"),
                              (f"warm, {route} route", warm, "mm_cached" if route == "mm" else "fft")):
        share_line(f"valley {STREAM_M} m streamed {grid} ({label})",
                   roof.valley_ridge_light_speed_ms(h, w, n_stream, len(VALLEY_FLATS), 180, method),
                   ms, method, smi_line)
    return route


def trace_tpi(dem_ds, ind_nans, use_h5py, smi_line):
    """``device_trace`` around one ``compute_tpi(scales=[2000])``: the Chrome
    trace must exist and hold a ``disk_sat`` kernel event."""
    from topo_descriptors_tpu_torch.utils.profiling import device_trace

    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(Path(tmp) / "trace") as trace:
            run_drivers(dem_ds, [("compute_tpi", dict(scales=[2000], ind_nans=ind_nans))],
                        use_h5py, prefix="trace")
            torch.cuda.synchronize()
        check(trace.path.exists(), f"no trace at {trace.path}")
        events = json.loads(trace.path.read_text())["traceEvents"]
        size = trace.path.stat().st_size
    names = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    disk = [n for n in names if "disk_sat" in n]
    check(bool(disk), f"the trace holds no disk_sat kernel event: {names}")
    check(trace.busy_s is not None and trace.busy_s > 0, "the trace holds no device time")
    print(f"[trace] compute_tpi(scales=[2000]) traced: {size} bytes, {len(events)} events, "
          f"kernels {disk}; busy {trace.busy_s * 1e3:.4f} ms of {trace.wall_s * 1e3:.4f} ms wall "
          f"(busy share {trace.busy_s / trace.wall_s:.4f}) on {smi_line}")


def batch_names():
    """The output variables of the batch at the reference's scales, as the
    port's drivers name them (tests/test_torch_examples.py holds these
    names to the JAX drivers')."""
    from topo_descriptors_tpu_torch import pipeline as p
    from topo_descriptors_tpu_torch.examples.compute_topo_descriptors import SCALES_METERS

    scales = list(SCALES_METERS)
    names = [n for s in scales for n in p._dem_outputs(s)[0]]
    names += [p._disk_name("tpi", s, f) for f in (None, 1) for s in scales]
    names += [n for s in scales for n in p._gradient_outputs(s, 1)[0]]
    names += [p._disk_name("std", s, None) for s in scales]
    for mode in ("valley", "ridge"):
        names += [n.upper() for s in scales[3:] for n in p._valley_ridge_outputs(s, mode, 0.5)[0]]
    return names + [p._sx_name(1000, 0)]


def batch_timings(dem_ds, shape, wall, cal, smi_line):
    """Seconds and Mpixel/s per timer label (``throughput_report``), per
    family, the total; the 30, 60 and 100 km valley/ridge scales beside the
    floors of both streamed routes. Returns {label: seconds}."""
    from topo_descriptors_tpu_torch.utils import Timings, throughput_report

    pixels = shape[0] * shape[1]
    report = throughput_report(pixels)
    seconds = {label: sum(samples) for label, samples in Timings.samples.items()}
    families = {}
    for label, s in seconds.items():
        print(f"[batch] {label}: {s:.4f} s, {report[label]:.4f} Mpixel/s on {smi_line}")
        family = label.split()[0]
        families[family] = families.get(family, 0.0) + s
    print(f"[batch] per family (s): {json.dumps({k: round(v, 4) for k, v in families.items()})}; "
          f"timed {sum(seconds.values()):.4f} s of {wall:.4f} s wall on {smi_line}")
    roof = roofline(cal)
    for mode in ("valley", "ridge"):
        for scale in FLOOR_SCALES:
            size, kmax = valley_px(dem_ds, scale)
            ms = seconds[f"{mode} scale {scale}m"] * 1e3
            route = streamed_route(*shape, kmax)
            floors = {m: roof.valley_ridge_light_speed_ms(*shape, size, 3, 180, m)
                      for m in ("mm_stream", "fft")}
            method = "mm_stream" if route == "mm" else "fft"
            other = "fft" if route == "mm" else "mm_stream"
            share_line(f"{mode} {scale} m ({size} px, kmax {kmax}) in the batch, {route} route "
                       f"(the {other} floor {floors[other]:.4f} ms)", floors[method], ms, method,
                       smi_line, tag="batch")
    return seconds


def run_batch(raw_ds, ind_nans, use_h5py, phase4_out, phase6_out, cal, smi_line):
    """The reference's batch (``examples.compute_topo_descriptors``, the
    demo raster with phase 4's holes) on the card, with the kernel counts
    set to 0 just before it and read just after. Returns the launches."""
    from topo_descriptors_tpu_torch.examples.compute_topo_descriptors import (
        SCALES_METERS,
        compute_batch,
    )
    from topo_descriptors_tpu_torch.utils import Timings

    shape = raw_ds.data.shape
    holes = np.zeros(shape, bool)
    holes[ind_nans] = True
    store = {}
    Timings.clear()
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        if not use_h5py:
            stack.enter_context(memory_writer(store))
        reset_launches()
        start = time.perf_counter()
        files = compute_batch(raw_ds, SCALES_METERS, "cuda", Path(tmp) / "batch")
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches, routes = read_launches(), read_route_launches()
        if use_h5py:
            read_outputs(Path(tmp) / "batch", store)
    print(f"[batch] compute_topo_descriptors on {shape}, {len(SCALES_METERS)} scales: "
          f"{len(files)} outputs in {wall:.3f} s, launches {launches}, per route {routes} "
          f"on {smi_line}")
    expected = batch_names()
    got = sorted(k.split("/", 1)[1] for k in store)
    check(len(files) == len(expected) and got == sorted(expected),
          f"batch outputs {len(files)}: {sorted(set(got) ^ set(expected))}")
    for key, raster in store.items():
        a = raster.data
        check(a.shape == shape and a.dtype == np.float32, f"{key}: {a.shape} {a.dtype}")
        if "/SX_" in key:  # compute_sx takes no ind_nans, as the reference's
            check(bool(np.isfinite(a).all()), f"{key}: not finite")
        else:
            check(bool(np.isnan(a[holes]).all()) and bool(np.isfinite(a[~holes]).all()),
                  f"{key}: not NaN in the holes and finite elsewhere")
    check(routes["disk_sat"]["fused"] > 0 and routes["disk_sat"]["wide"] > 0
          and launches["sx_block"] > 0, f"the batch missed a kernel route: {routes}")
    for kind, ours, ref in (("TPI", f"TPI_{BANK_M}M", f"call0/TPI_{BANK_M}M"),
                            ("STD", f"STD_{BANK_M}M", f"call2/STD_{BANK_M}M")):
        err, tol, unit = disk_sx_error(kind, store[f"batch/{ours}"].data, phase4_out[ref].data)
        print(f"[batch] {ours} vs phase 4's {ref}: max|diff| {err:.6g} {unit} (tol {tol})")
        check(err <= tol, f"batch {ours}: {err} > {tol}")
    valley = [f"VALLEY_{k}_{BANK_M}M_SMTHFACT0.5" for k in ("NORM", "DIR")]
    valley_agree(f"batch valley {BANK_M} m vs phase 6's s3call3",
                 tuple(store[f"batch/{n}"].data for n in valley),
                 tuple(phase6_out[f"s3call3/{n}"].data for n in valley), tag="batch")
    batch_timings(raw_ds, shape, wall, cal, smi_line)
    return launches, store


def check_largest_routes(dem_ds, dem, store, smi_line):
    """The batch's valley index at its largest scale against the streamed
    route that the cost model did not pick, on the same filled DEM: the
    routing constants may move a scale from one route to the other only
    where both agree (phase 6's valley tolerances)."""
    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import get_sigmas

    size, kmax = valley_px(dem_ds, LARGEST_M)
    (sigma,) = get_sigmas([0.5], [size])
    route = streamed_route(*dem.shape, kmax)
    other = "fft" if route == "mm" else "mm"
    start = time.perf_counter()
    out = host_pair(ops.valley_ridge_streamed(dem, size, "valley", VALLEY_FLATS, sigma,
                                              conv_method=other, device=dem.device))
    wall = time.perf_counter() - start
    names = [f"batch/VALLEY_{k}_{LARGEST_M}M_SMTHFACT0.5" for k in ("NORM", "DIR")]
    valley_agree(f"batch valley {LARGEST_M} m ({size} px, {route} route) vs the {other} route "
                 f"({wall:.3f} s on {smi_line})", tuple(store[n].data for n in names), out,
                 tag="batch")


def run_walkthrough(raster, use_h5py):
    """``examples.walkthrough`` on the card where h5py can write its NetCDF
    ingest and outputs; it must print every file it wrote."""
    if not use_h5py:
        print("[batch] walkthrough not run: no h5py here, and its ingest writes and reads "
              "NetCDF; the batch and phases 4-6 run its driver calls on the card")
        return
    from topo_descriptors_tpu_torch.examples.walkthrough import walkthrough

    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(printed):
        paths = walkthrough(raster, device="cuda", outdir=tmp)
    text = printed.getvalue()
    check(text.startswith("device: cuda") and paths and all(p.name in text for p in paths),
          f"the walkthrough printed {text[:200]!r}")
    print(f"[batch] walkthrough on the card: {len(paths)} output files written and printed")


def run_profiling_batch(baso, raw_ds, dem_ds, ind_nans, dem, use_h5py, phase4_out, phase6_out,
                        smi_line):
    """Phase 9: calibration, the roofline against the card, a device trace,
    the reference's batch and the walkthrough. Returns the batch's launches."""
    t0 = time.perf_counter()
    cal = calibrate(dem_ds, dem, smi_line)
    print_routes(dem_ds, tuple(dem.shape), cal, smi_line)
    check_roofline(dem_ds, dem, cal, smi_line)
    trace_tpi(dem_ds, ind_nans, use_h5py, smi_line)
    launches, store = run_batch(raw_ds, ind_nans, use_h5py, phase4_out, phase6_out, cal, smi_line)
    check_largest_routes(dem_ds, dem, store, smi_line)
    run_walkthrough(baso, use_h5py)
    print(f"[batch] phase 9 done in {time.perf_counter() - t0:.1f} s")
    return launches


def add_shares(entry: dict) -> None:
    """Beside every ``ms{suffix}`` with a ``bound_ms{suffix}`` of ``entry``
    and of the route dicts nested in it, ``share{suffix}``: the bound over
    the measured time."""
    for key in [k for k in entry if k.startswith("ms")]:
        suffix = key[2:]
        if isinstance(entry.get(f"bound_ms{suffix}"), float) and entry[key]:
            entry[f"share{suffix}"] = entry[f"bound_ms{suffix}"] / entry[key]
    for value in list(entry.values()):
        if isinstance(value, dict):
            for nested in value.values():
                if isinstance(nested, dict):
                    add_shares(nested)


def main() -> int:
    name, smi_line = card()
    from topo_descriptors_tpu_torch.host import basodino_like_dem, fill_na
    from topo_descriptors_tpu_torch.ops.cuda import sx_sweep

    build()

    t0 = start = time.perf_counter()
    baso = basodino_like_dem(projected=True)
    big = basodino_like_dem(8192, 8192, seed=0)  # synthetic_dem(8192, 8192) on a 30 m grid
    grids = {
        "900x1440": torch.from_numpy(baso.data).cuda(),
        "8192x8192": torch.from_numpy(big.data).cuda(),
    }
    print(f"[data] grids made in {time.perf_counter() - start:.2f} s")
    errs = {"disk_sat": 0.0, "sx_block": 0.0, "sx_sweep": 0.0, "sx_fan": 0.0}
    reset_launches()
    # 1000 x 1337: no multiple of either kernel's tile; 50 x 61: smaller
    # than the 2000 m halo (border 67)
    ragged = torch.from_numpy(basodino_like_dem(1000, 1337, seed=3).data).cuda()
    small = grids["900x1440"][:50, :61].contiguous()
    twin_ms = {}  # phase 3's twin calls that phase 5 reports
    for grid, dem in {**grids, "1000x1337": ragged, "50x61": small}.items():
        for case in disk_cases(dem, grid):
            errs["disk_sat"] = max(errs["disk_sat"], check_disk(*case, grid))
        for case in sx_cases(grid):
            errs["sx_block"] = max(errs["sx_block"], check_sx(case[0], dem, *case[1:], grid))
        if grid in ("900x1440", "1000x1337"):
            check_chunked(dem, grid)
        for case in sweep_cases(grid):
            case_errs, ms = check_sweep(case[0], dem, *case[1:], grid)
            if (case[0], grid) == ("36az_r10000", "900x1440"):
                twin_ms["sx_sweep 36 az 900x1440"] = twin_ms["sx_fan 36 az 900x1440"] = ms
            for kernel, err in case_errs.items():
                errs[kernel] = max(errs[kernel], err)
    routes = read_route_launches()
    print(f"[parity] done at {time.perf_counter() - t0:.1f} s; launches per route {routes}")
    for kernel, counts in routes.items():
        check(all(n > 0 for n in counts.values()), f"{kernel}: a route was not run: {counts}")
    del ragged, small

    data = np.array(baso.data)
    data[100:104, 200:230] = np.nan  # holes: filled for compute, NaN again in the outputs
    ind_nans, dem_ds = fill_na(baso.with_data(data))
    use_h5py = importlib.util.find_spec("h5py") is not None
    print(f"[drivers] writing {'NetCDF through h5py, read back' if use_h5py else 'to memory (no h5py here)'}")
    dem_filled = torch.from_numpy(np.ascontiguousarray(dem_ds.data, np.float32)).cuda()
    auto_kernel = auto_kernel_of(dem_filled, *driver_fan(dem_ds, 2000))  # the main path's fans
    reset_launches()
    start = time.perf_counter()
    main_out, _ = run_drivers(dem_ds, main_path_calls(ind_nans), use_h5py)
    other_method, other_out = other_sweep_call(dem_ds, dem_filled)
    torch.cuda.synchronize()
    launches, main_routes = read_launches(), read_route_launches()
    print(f"[drivers] 7 driver calls and ops.sx_sweep(method={other_method!r}) in "
          f"{time.perf_counter() - start:.3f} s, launches {launches}, per route {main_routes}; "
          f"auto routes the sweep to {auto_kernel}")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(launches[auto_kernel] >= 2, f"compute_sx_sweep did not launch {auto_kernel}")
    other_kernel = {"pallas_fan": "sx_fan", "pallas_sweep": "sx_sweep"}[other_method]
    check(main_routes["disk_sat"]["fused"] > 0 and main_routes["sx_block"]["tile"] > 0
          and main_routes[auto_kernel]["tile"] >= 2 and main_routes[other_kernel]["tile"] > 0,
          f"the main path missed a shared-memory route: {main_routes}")
    per_call = {}
    for driver, kwargs in (("compute_tpi", dict(scales=[2000], ind_nans=ind_nans)),
                           ("compute_sx", dict(azimuth=0, radius=500))):
        reset_launches()
        run_drivers(dem_ds, [(driver, kwargs)], use_h5py, prefix="one")
        torch.cuda.synchronize()
        label = f"{driver}({'scales=[2000]' if driver == 'compute_tpi' else 'radius=500'})"
        per_call[label] = {k: n for k, n in read_launches().items() if n}
        per_call[label]["routes"] = {k: {r: n for r, n in v.items() if n}
                                     for k, v in read_route_launches().items()
                                     if any(v.values())}
    print(f"[drivers] launches per call: {per_call}")
    with plain_twins():
        ref_out, _ = run_drivers(dem_ds, main_path_calls(ind_nans), use_h5py)
        _, other_ref = other_sweep_call(dem_ds, dem_filled)
    compare_outputs(main_out, ref_out, baso.data.shape)
    check(torch.equal(torch.isnan(other_out), torch.isnan(other_ref))
          and float(torch.nan_to_num(other_out - other_ref).abs().max()) <= SX_ATOL,
          f"ops.sx_sweep(method={other_method!r}) disagrees with the twin")
    check_sweep_drivers(dem_ds, main_out, other_out)
    check(np.isnan(main_out["call0/TPI_500M"].data[ind_nans]).all(), "NaN holes not reassigned")
    km10_launches, km10_routes = run_10km_drivers(dem_ds, use_h5py)
    check_against_recipes(baso.data[:90, :144])
    print(f"[drivers] done at {time.perf_counter() - t0:.1f} s")

    times = time_kernels(grids, smi_line)
    sweep_times = time_sweeps(grids, smi_line)
    wide_times = time_wide(grids, smi_line)
    route_times = time_sx_routes(grids, smi_line, twin_ms)
    for label, t in route_times.items():
        check(t["route"] == ["chunked"], f"{label}: route {t['route']}, not chunked")
    print(f"[time] done at {time.perf_counter() - t0:.1f} s")
    del grids
    slice3_launches, slice3_out = run_slice3(dem_ds, ind_nans, use_h5py, dem_filled,
                                             np.ascontiguousarray(baso.data[:90, :144]), smi_line)
    print(f"[slice3] done at {time.perf_counter() - t0:.1f} s")
    streamed_launches = run_out_of_core(baso.with_data(data), with_holes(big, BIG_HOLES), use_h5py,
                                        smi_line, auto_kernel)
    print(f"[ooc] done at {time.perf_counter() - t0:.1f} s")
    sharded_launches, _ = run_mesh(baso, basodino_like_dem(1000, 1337, seed=3),
                                   np.ascontiguousarray(big.data, np.float32), dem_ds, ind_nans,
                                   use_h5py, smi_line, auto_kernel)
    print(f"[mesh] done at {time.perf_counter() - t0:.1f} s")
    batch_launches = run_profiling_batch(baso, baso.with_data(data), dem_ds, ind_nans, dem_filled,
                                         use_h5py, main_out, slice3_out, smi_line)
    print(f"[batch] done at {time.perf_counter() - t0:.1f} s")
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
        if kernel in main_routes:  # launches per route on the main path, and per call
            entry["launches_routes"] = main_routes[kernel]
            entry["launches_per_call"] = {call: counts.get(kernel, 0)
                                          for call, counts in per_call.items()}
        if kernel in slice3_launches:  # TerrainSuite.forward, phase 6
            entry["launches_suite"] = slice3_launches[kernel]
        if kernel != "disk_sat":  # the 10 km drivers, phase 4
            entry["launches_10km"] = km10_launches[kernel]
            entry["launches_10km_routes"] = km10_routes[kernel]
        entry["launches_streamed"] = streamed_launches[kernel]  # phase 7
        entry["launches_sharded"] = sharded_launches[kernel]  # phase 8
        entry["launches_batch"] = batch_launches[kernel]  # phase 9
        if kernel in sx_sweep.LAUNCHES:  # 36 azimuths; ms at 900x1440 r = 200 m
            for suffix, case in (("", "900x1440 r200"), ("_r2000", "900x1440 r2000"),
                                 ("_8192", "8192x8192 r500")):
                entry[f"ms{suffix}"] = sweep_times[(kernel, case)]
                entry[f"plain_ms{suffix}"] = sweep_times[("twin", case)]
                entry[f"bound_ms{suffix}"], entry[f"bound_by{suffix}"] = sweep_times[("bound", case)]
            entry["library_ms"] = None  # no single PyTorch call computes Sx
        else:  # TPI-2000m conv / Sx-500m at 900x1440, then at 8192x8192
            for suffix, grid in (("", "900x1440"), ("_8192", "8192x8192")):
                for key, value in times[(kernel, grid)].items():
                    entry[f"{key}{suffix}"] = value
        if kernel == "disk_sat":  # the wide route, phase 5
            entry["wide"] = wide_times
        else:  # the 10 km cases, phase 5: the chunked routes
            entry["chunked"] = {
                label: {k: t[k] for k in ("grid", "route", "splits", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}
                for label, t in route_times.items() if t["kernel"] == kernel}
        add_shares(entry)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
