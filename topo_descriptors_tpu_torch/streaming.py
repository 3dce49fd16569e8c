"""Out-of-core batch drivers on PyTorch: disk -> device -> disk, one band at
a time.

The streaming counterparts of :mod:`topo_descriptors_tpu_torch.pipeline`
for grids larger than host memory; the single-device half of
``topo_descriptors_tpu.streaming``. Every driver composes three
bounded-memory pieces:

* :class:`~topo_descriptors_tpu_torch.io.windowed.DemWindowReader`: windowed
  ingest (GeoTIFF strips/tiles or HDF5 hyperslabs) with the reference's
  float32 cast, min-elevation mask and nearest-in-x NaN fill applied per
  window;
* :class:`~topo_descriptors_tpu_torch.parallel.TiledRunner`: banded,
  halo-overlapped execution on ``device`` (default ``"cuda"``, which
  raises where CUDA is missing);
* :class:`~topo_descriptors_tpu_torch.io.netcdf.RasterBandWriter`: NetCDF4 output
  appended band by band into a ``.partial`` file, renamed onto
  ``topo_<NAME>.nc`` when it closes.

Peak host memory is a few halo-extended bands, whatever the grid's height.
Outputs keep the per-(descriptor, scale) file contract, including the NaN
reassignment at the original holes, recomputed per band from the reader
(the holes are row-local). A driver that fails aborts every writer it
opened, so it leaves neither a final-named file nor a ``.partial`` one, and
``skip_existing`` can trust what exists. ``crop`` is not supported: crop
the outputs afterwards or use the in-memory pipeline.

The ``*_sharded`` drivers read each process's blocks straight onto a
device mesh (:func:`~topo_descriptors_tpu_torch.parallel.runtime.
ingest_sharded`), run the descriptors as
:class:`~topo_descriptors_tpu_torch.parallel.ShardedOps` methods and
stream the outputs back to NetCDF in row bands, through the same aborting
writers.

Both families take their scales, names, units and Sx rays from the recipe
in :mod:`.pipeline`; they differ from the in-memory drivers in their
backend and in their emit step (:func:`_stream_to`). One difference of
plan stays: under ``skip_existing`` a streamed TPI/STD driver reruns every
kind of a scale that misses any, where the in-memory one runs only the
missing kinds.
"""

from __future__ import annotations

import contextlib
import functools
import logging
from pathlib import Path
from typing import List, Union

import numpy as np

from topo_descriptors_tpu_torch.grid import check_dem
from topo_descriptors_tpu_torch.io.netcdf import RasterBandWriter
from topo_descriptors_tpu_torch.io.windowed import DemWindowReader
from topo_descriptors_tpu_torch.parallel.runtime import ingest_sharded
from topo_descriptors_tpu_torch.parallel.tiles import LockedReader, TiledRunner
from topo_descriptors_tpu_torch.pipeline import (
    _as_list,
    _dem_outputs,
    _disk_name,
    _gradient_outputs,
    _on_disk,
    _Padded,
    _per_scale,
    _scales,
    _sx_name,
    _sx_rays,
    _valley_ridge_outputs,
)
from topo_descriptors_tpu_torch.utils.timing import timer

logger = logging.getLogger(__name__)


def open_dem(dem: Union[str, Path, DemWindowReader, LockedReader], fill: bool = True):
    """A :class:`LockedReader` over ``dem``: a path is opened as a
    :class:`DemWindowReader`, a reader is wrapped (a locked one passes
    through). The driver hands the same object to its runner and its
    sinks, so their reads share one lock."""
    if isinstance(dem, (str, Path)):
        dem = DemWindowReader(dem, fill=fill)
    return LockedReader.wrap(dem)


class _Sink:
    """Band sink: NaN reassignment at the original holes, then the write.
    The runner hands over bands it owns, so the NaNs go in in place."""

    def __init__(self, writer, dem, reassign_nans: bool):
        self.writer = writer
        self.dem = dem
        self.reassign = reassign_nans

    def __call__(self, start: int, band: np.ndarray) -> None:
        if self.reassign:
            mask = self.dem.nan_rows(start, start + band.shape[-2])
            if mask.any():
                band[..., mask] = np.nan
        self.writer.write_rows(start, band)


class _StackSink:
    """Fan an (A, rows, W) band out to one sink per azimuth."""

    def __init__(self, sinks):
        self.sinks = sinks

    def __call__(self, start: int, band: np.ndarray) -> None:
        for a, sink in enumerate(self.sinks):
            sink(start, band[a])


def _open_writer(dem, name, outdir, units):
    """``(path, writer)`` for one output: the only place a writer is made.
    A writer has ``write_rows(start, band)``, ``close()`` (publish the
    file) and ``abort()`` (discard it)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    name = str.upper(name)
    path = outdir / f"topo_{name}.nc"
    return path, RasterBandWriter(path, dem.grid, name, units=units, attrs=dict(dem.attrs))


@contextlib.contextmanager
def _writers(dem, names, outdir, units):
    """Open one writer per name; on success close them all, on any error
    abort them all (fault C1 of the reference: its drivers close writers
    in ``finally``, which publishes a truncated file after an error) and
    re-raise."""
    opened = []
    try:
        for name, unit in zip(names, units):
            opened.append(_open_writer(dem, name, outdir, unit))
        yield opened
    except BaseException:
        for _, writer in opened:
            writer.abort()
        raise
    for path, writer in opened:
        writer.close()
        logger.info(f"saved: {path}")


def _stream_to(dem, names, units, outdir, reassign_nans, run) -> List[Path]:
    """The emit step of both streamed families: ``run(sinks)`` feeds one
    band sink per output (:class:`_Sink`) through writers that are all
    aborted if anything fails; the paths written."""
    with _writers(dem, names, outdir, units) as opened:
        run([_Sink(writer, dem, reassign_nans) for _, writer in opened])
    return [path for path, _ in opened]


def _streams(driver):
    """Run ``driver`` on ``open_dem(dem)``; a reader opened here from a path
    is closed when the driver returns or raises."""

    @functools.wraps(driver)
    def run(dem, *args, **kwargs):
        reader = open_dem(dem)
        try:
            return driver(reader, *args, **kwargs)
        finally:
            if isinstance(dem, (str, Path)):
                reader.close()

    return run


def _stream_disk_groups(plan, kinds, outdir, skip_existing, group):
    """Every path of a streamed TPI/STD call, kind-major. The scales not
    all on disk run by pre-smooth sigma, every kind of each: ``group(sigma,
    idxs, names)`` writes one group's outputs (kind-major, then scale) and
    returns their paths."""
    written, groups = {}, {}
    for i, sigma in enumerate(plan.sigmas):
        names = [_disk_name(k, plan.meters[i], plan.factors[i]) for k in kinds]
        if paths := _on_disk(names, outdir, skip_existing):
            written.update({(k, i): p for k, p in zip(kinds, paths)})
        else:
            groups.setdefault(sigma, []).append(i)
    for sigma, idxs in groups.items():
        keys = [(k, i) for k in kinds for i in idxs]
        names = [_disk_name(k, plan.meters[i], plan.factors[i]) for k, i in keys]
        written.update(zip(keys, group(sigma, idxs, names)))
    return [written[(k, i)] for k in kinds for i in range(len(plan.meters))]


@_streams
def compute_dem(dem, scales, outdir=".", tile_rows: int = 4096, reassign_nans: bool = True,
                skip_existing: bool = False, pipeline: bool = True, device="cuda"):
    """Streamed smoothed-DEM driver (reference compute_dem, topo.py:16-59)."""
    runner = TiledRunner(tile_rows, pipeline, device)
    logger.info(f"***Streaming dem computation for scales {scales} meters***")
    plan = _scales(dem, scales)

    def run(i, names, units):
        with timer(f"dem scale {plan.meters[i]}m streamed"):
            return _stream_to(dem, names, units, outdir, reassign_nans, lambda sinks:
                              runner.gaussian(dem, plan.sigmas[i], sink=sinks[0]))

    return _per_scale(map(_dem_outputs, plan.meters), outdir, skip_existing, run)


@_streams
def _compute_disk_family(dem, scales, smth_factors, kinds, outdir, tile_rows, reassign_nans,
                         skip_existing, pipeline, device):
    """Streamed TPI/STD. Scales that share a pre-smooth sigma run fused: one
    banded pass sends each halo window to the device once and writes every
    (descriptor, scale) output of the group (``TiledRunner.disk_descriptors``);
    a lone (scale, kind) runs ``TiledRunner.tpi`` or ``.std``."""
    runner = TiledRunner(tile_rows, pipeline, device)
    plan = _scales(dem, scales, smth_factors)

    def group(sigma, idxs, names):
        sizes = [plan.sizes[i] for i in idxs]

        def run(sinks):
            if len(idxs) == 1 and len(kinds) == 1:
                getattr(runner, kinds[0])(dem, sizes[0], sigma, sink=sinks[0])
            else:
                runner.disk_descriptors(
                    dem, sizes, sigma, compute_tpi="tpi" in kinds, compute_std="std" in kinds,
                    sinks={k: sinks[j * len(idxs):(j + 1) * len(idxs)]
                           for j, k in enumerate(kinds)})

        with timer(f"{'+'.join(kinds)} x{len(idxs)} scales streamed"):
            return _stream_to(dem, names, ["m"] * len(names), outdir, reassign_nans, run)

    return _stream_disk_groups(plan, kinds, outdir, skip_existing, group)


def compute_tpi(dem, scales, smth_factors=None, outdir=".", tile_rows: int = 4096,
                reassign_nans: bool = True, skip_existing: bool = False, pipeline: bool = True,
                device="cuda"):
    """Streamed TPI driver (reference compute_tpi, topo.py:88-141)."""
    logger.info(f"***Streaming TPI computation for scales {scales} meters***")
    return _compute_disk_family(dem, scales, smth_factors, ("tpi",), outdir, tile_rows,
                                reassign_nans, skip_existing, pipeline, device)


def compute_std(dem, scales, smth_factors=None, outdir=".", tile_rows: int = 4096,
                reassign_nans: bool = True, skip_existing: bool = False, pipeline: bool = True,
                device="cuda"):
    """Streamed rolling-STD driver (reference compute_std, topo.py:216-269)."""
    logger.info(f"***Streaming STD computation for scales {scales} meters***")
    return _compute_disk_family(dem, scales, smth_factors, ("std",), outdir, tile_rows,
                                reassign_nans, skip_existing, pipeline, device)


def compute_tpi_std(dem, scales, smth_factors=None, outdir=".", tile_rows: int = 4096,
                    reassign_nans: bool = True, skip_existing: bool = False,
                    pipeline: bool = True, device="cuda"):
    """Streamed fused TPI+STD: one banded pass per sigma group writes every
    (descriptor, scale) output from the shared moment fields, half the
    ingest and transfer traffic of the two family drivers run apart."""
    logger.info(f"***Streaming fused TPI+STD computation for scales {scales} meters***")
    return _compute_disk_family(dem, scales, smth_factors, ("tpi", "std"), outdir, tile_rows,
                                reassign_nans, skip_existing, pipeline, device)


@_streams
def compute_gradient(dem, scales, sig_ratios=1, outdir=".", tile_rows: int = 4096,
                     reassign_nans: bool = True, skip_existing: bool = False,
                     pipeline: bool = True, device="cuda"):
    """Streamed gradient/slope/aspect driver (reference compute_gradient,
    topo.py:534-594): the four outputs of a band come from one device call
    and go to four band writers."""
    runner = TiledRunner(tile_rows, pipeline, device)
    logger.info(f"***Streaming gradients computation for scales {scales} meters***")
    plan = _scales(dem, scales)
    sig_ratios = _as_list(sig_ratios, len(plan.meters))

    def run(i, names, units):
        with timer(f"gradient scale {plan.meters[i]}m streamed"):
            return _stream_to(dem, names, units, outdir, reassign_nans, lambda sinks:
                              runner.gradient(dem, plan.sigmas[i], plan.res, sig_ratios[i],
                                              sinks=sinks))

    outputs = [_gradient_outputs(m, r) for m, r in zip(plan.meters, sig_ratios)]
    return _per_scale(outputs, outdir, skip_existing, run)


@_streams
def compute_valley_ridge(dem, scales, mode: str, flat_list=(0, 0.15, 0.3), smth_factors=None,
                         outdir=".", tile_rows: int = 4096, reassign_nans: bool = True,
                         skip_existing: bool = False, pipeline: bool = True, device="cuda"):
    """Streamed valley/ridge driver (reference compute_valley_ridge,
    topo.py:317-386). The global standardization stats come from a
    band-wise float64 host pass over the (optionally smoothed) field."""
    runner = TiledRunner(tile_rows, pipeline, device)
    logger.info(f"***Streaming {mode} index computation for scales {scales} meters***")
    plan = _scales(dem, scales, smth_factors)

    def run(i, names, units):
        with timer(f"{mode} scale {plan.meters[i]}m streamed"):
            return _stream_to(dem, names, units, outdir, reassign_nans, lambda sinks:
                              runner.valley_ridge(dem, plan.sizes[i], mode, list(flat_list),
                                                  plan.sigmas[i], sinks=sinks))

    outputs = [_valley_ridge_outputs(m, mode, f) for m, f in zip(plan.meters, plan.factors)]
    return _per_scale(outputs, outdir, skip_existing, run)


@_streams
def compute_sx(dem, azimuths, radius: float, height: float = 10.0, azimuth_arc: float = 10.0,
               azimuth_steps: int = 15, radius_min: float = 0.0, outdir=".",
               tile_rows: int = 4096, reassign_nans: bool = False, skip_existing: bool = False,
               pipeline: bool = True, device="cuda"):
    """Streamed Sx driver (reference compute_sx, topo.py:715-772).

    One azimuth streams ``TiledRunner.sx``; a fan streams
    ``TiledRunner.sx_sweep``, which sends each band's window to the device
    once for all azimuths. ``reassign_nans`` defaults off like the
    reference (its sx wrapper never reassigns, topo.py:760-772).
    """
    runner = TiledRunner(tile_rows, pipeline, device)
    check_dem(dem)
    azimuths = _as_list(azimuths)
    names = [_sx_name(radius, a) for a in azimuths]
    if paths := _on_disk(names, outdir, skip_existing):
        return paths
    logger.info(f"***Streaming Sx for azimuths {azimuths} and radius {radius}***")
    one = len(azimuths) == 1
    rays = _sx_rays(dem, azimuths[0] if one else azimuths, radius, azimuth_arc, azimuth_steps,
                    radius_min)

    def run(sinks):
        if one:
            runner.sx(dem, *rays, height, sink=sinks[0])
        else:
            runner.sx_sweep(dem, *rays, height, sink=_StackSink(sinks))

    with timer(f"sx {len(azimuths)} azimuths r {radius}m streamed"):
        return _stream_to(dem, names, ["degree"] * len(names), outdir, reassign_nans, run)


# --- windowed ingest -> device mesh ------------------------------------------


def _ingest(dem, sops, fill):
    """``(ops, DEM on the mesh, valid_shape)``; on a grid padded to the
    mesh, ``ops`` passes ``valid_shape`` to every method (as the in-memory
    drivers' backend does)."""
    dem_s, valid_shape = ingest_sharded(dem, sops.mesh, fill=fill)
    if tuple(dem_s.shape) != tuple(valid_shape):
        sops = _Padded(sops, valid_shape)
    return sops, dem_s, valid_shape


def _write_sharded(dem, arrays, names, units, outdir, valid_shape, reassign_nans, band_rows):
    """Each sharded (H, W) array streamed to its output in row bands, the
    ragged pad cropped (no host array of the whole grid), through
    :func:`_stream_to`; the written paths."""
    vh, vw = valid_shape

    def run(sinks):
        for arr, sink in zip(arrays, sinks):
            for r0 in range(0, vh, band_rows):
                sink(r0, arr[r0 : min(r0 + band_rows, vh), :vw])

    return _stream_to(dem, names, units, outdir, reassign_nans, run)


@_streams
def compute_tpi_std_sharded(dem, scales, sops, kinds=("tpi", "std"), smth_factors=None,
                            outdir=".", reassign_nans: bool = True, skip_existing: bool = False,
                            band_rows: int = 2048):
    """Windowed ingest -> device mesh -> banded NetCDF output, for TPI
    and/or STD: each process reads only its blocks from disk, every sigma
    group runs as one fused :meth:`ShardedOps.disk_descriptors` call, and
    the outputs stream back in row bands."""
    logger.info(f"***Sharded-streaming {'+'.join(kinds)} for scales {scales} meters***")
    plan = _scales(dem, scales, smth_factors)
    ingest = functools.cache(lambda: _ingest(dem, sops, 0.0))

    def group(sigma, idxs, names):
        mesh_ops, dem_s, valid_shape = ingest()
        with timer(f"{'+'.join(kinds)} sharded-streamed x{len(idxs)} scales"):
            batch = mesh_ops.disk_descriptors(dem_s, [plan.sizes[i] for i in idxs], sigma,
                                              compute_tpi="tpi" in kinds,
                                              compute_std="std" in kinds)
            return _write_sharded(dem, [batch[k][j] for k in kinds for j in range(len(idxs))],
                                  names, ["m"] * len(names), outdir, valid_shape,
                                  reassign_nans, band_rows)

    return _stream_disk_groups(plan, kinds, outdir, skip_existing, group)


@_streams
def compute_dem_sharded(dem, scales, sops, outdir=".", reassign_nans: bool = True,
                        skip_existing: bool = False, band_rows: int = 2048):
    """Windowed-ingest sharded smoothed-DEM driver (see
    :func:`compute_tpi_std_sharded`)."""
    plan = _scales(dem, scales)
    ingest = functools.cache(lambda: _ingest(dem, sops, 0.0))

    def run(i, names, units):
        mesh_ops, dem_s, valid_shape = ingest()
        with timer(f"dem scale {plan.meters[i]}m sharded-streamed"):
            return _write_sharded(dem, [mesh_ops.gaussian(dem_s, plan.sigmas[i])], names, units,
                                  outdir, valid_shape, reassign_nans, band_rows)

    return _per_scale(map(_dem_outputs, plan.meters), outdir, skip_existing, run)


@_streams
def compute_gradient_sharded(dem, scales, sops, sig_ratios=1, outdir=".",
                             reassign_nans: bool = True, skip_existing: bool = False,
                             band_rows: int = 2048):
    """Windowed-ingest sharded gradient/slope/aspect driver (reference
    compute_gradient, topo.py:534-594): the four outputs of a scale come
    from one :meth:`ShardedOps.gradient` call and stream back in row
    bands."""
    logger.info(f"***Sharded-streaming gradients for scales {scales} meters***")
    plan = _scales(dem, scales)
    sig_ratios = _as_list(sig_ratios, len(plan.meters))
    ingest = functools.cache(lambda: _ingest(dem, sops, 0.0))

    def run(i, names, units):
        mesh_ops, dem_s, valid_shape = ingest()
        with timer(f"gradient scale {plan.meters[i]}m sharded-streamed"):
            arrays = mesh_ops.gradient(dem_s, plan.sigmas[i], plan.res, sig_ratios[i])
            return _write_sharded(dem, arrays, names, units, outdir, valid_shape,
                                  reassign_nans, band_rows)

    outputs = [_gradient_outputs(m, r) for m, r in zip(plan.meters, sig_ratios)]
    return _per_scale(outputs, outdir, skip_existing, run)


@_streams
def compute_valley_ridge_sharded(dem, scales, sops, mode: str, flat_list=(0, 0.15, 0.3),
                                 smth_factors=None, outdir=".", reassign_nans: bool = True,
                                 skip_existing: bool = False, band_rows: int = 2048):
    """Windowed-ingest sharded valley/ridge driver (reference
    compute_valley_ridge, topo.py:317-386); :meth:`ShardedOps.valley_ridge`
    streams the scales whose rotated bank exceeds
    ``CFG.valley_bank_max_bytes``."""
    logger.info(f"***Sharded-streaming {mode} index for scales {scales} meters***")
    plan = _scales(dem, scales, smth_factors)
    ingest = functools.cache(lambda: _ingest(dem, sops, 0.0))

    def run(i, names, units):
        mesh_ops, dem_s, valid_shape = ingest()
        with timer(f"{mode} scale {plan.meters[i]}m sharded-streamed"):
            arrays = mesh_ops.valley_ridge(dem_s, plan.sizes[i], mode, list(flat_list),
                                           plan.sigmas[i])
            return _write_sharded(dem, arrays, names, units, outdir, valid_shape,
                                  reassign_nans, band_rows)

    outputs = [_valley_ridge_outputs(m, mode, f) for m, f in zip(plan.meters, plan.factors)]
    return _per_scale(outputs, outdir, skip_existing, run)


@_streams
def compute_sx_sharded(dem, azimuths, radius: float, sops, height: float = 10.0,
                       azimuth_arc: float = 10.0, azimuth_steps: int = 15,
                       radius_min: float = 0.0, outdir=".", reassign_nans: bool = False,
                       skip_existing: bool = False, band_rows: int = 2048):
    """Windowed-ingest sharded Sx driver (reference compute_sx,
    topo.py:715-772). A fan runs as one :meth:`ShardedOps.sx_sweep` call,
    its ray halo exchanged once for every azimuth. A ragged grid is padded
    with NaN, which the ray maximum skips as it skips the beyond-edge fill.
    ``reassign_nans`` defaults off like the reference's sx wrapper."""
    check_dem(dem)
    azimuths = _as_list(azimuths)
    names = [_sx_name(radius, a) for a in azimuths]
    if paths := _on_disk(names, outdir, skip_existing):
        return paths
    logger.info(f"***Sharded-streaming Sx for azimuths {azimuths}, radius {radius}***")
    one = len(azimuths) == 1
    rays = _sx_rays(dem, azimuths[0] if one else azimuths, radius, azimuth_arc, azimuth_steps,
                    radius_min)
    mesh_ops, dem_s, valid_shape = _ingest(dem, sops, np.nan)
    with timer(f"sx sharded-streamed {len(azimuths)} az r {radius}m"):
        if one:
            stack = [mesh_ops.sx(dem_s, *rays, height)]
        else:
            out = mesh_ops.sx_sweep(dem_s, *rays, height)
            stack = [out[a] for a in range(len(azimuths))]
        return _write_sharded(dem, stack, names, ["degree"] * len(names), outdir, valid_shape,
                              reassign_nans, band_rows)
