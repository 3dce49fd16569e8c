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
"""

from __future__ import annotations

import contextlib
import functools
import logging
from pathlib import Path
from typing import Optional, Union

import numpy as np

from topo_descriptors_tpu_torch import geo
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.grid import check_dem
from topo_descriptors_tpu_torch.io.netcdf import RasterBandWriter
from topo_descriptors_tpu_torch.io.windowed import DemWindowReader
from topo_descriptors_tpu_torch.kernels.sx_geometry import sx_offsets, sx_sweep_offsets
from topo_descriptors_tpu_torch.ops.valley_ridge import bank_nbytes
from topo_descriptors_tpu_torch.parallel.runtime import ingest_sharded
from topo_descriptors_tpu_torch.parallel.tiles import LockedReader, TiledRunner
from topo_descriptors_tpu_torch.pipeline import (
    _as_list,
    _dem_name,
    _existing,
    _gradient_names,
    _std_name,
    _sx_name,
    _tpi_name,
    _valley_ridge_names,
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


def _skip(name, outdir, skip_existing) -> Optional[Path]:
    if skip_existing and (path := _existing(name, outdir)):
        logger.info(f"skipping existing {path}")
        return path
    return None


@_streams
def compute_dem(dem, scales, outdir=".", tile_rows: int = 4096, reassign_nans: bool = True,
                skip_existing: bool = False, pipeline: bool = True, device="cuda"):
    """Streamed smoothed-DEM driver (reference compute_dem, topo.py:16-59)."""
    runner = TiledRunner(tile_rows, pipeline, device)
    check_dem(dem)
    logger.info(f"***Streaming dem computation for scales {scales} meters***")
    scales = _as_list(scales)
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = scales_pxl / CFG.scale_std

    written = []
    for idx, sigma in enumerate(sigmas):
        name = _dem_name(scales[idx])
        if path := _skip(name, outdir, skip_existing):
            written.append(path)
            continue
        with timer(f"dem scale {scales[idx]}m streamed"), \
                _writers(dem, [name], outdir, ["m"]) as opened:
            runner.gaussian(dem, float(sigma), sink=_Sink(opened[0][1], dem, reassign_nans))
        written.append(opened[0][0])
    return written


@_streams
def _compute_disk_family(dem, scales, smth_factors, kinds, outdir, tile_rows, reassign_nans,
                         skip_existing, pipeline, device):
    """Streamed TPI/STD. Scales that share a pre-smooth sigma run fused: one
    banded pass sends each halo window to the device once and writes every
    (descriptor, scale) output of the group (``TiledRunner.disk_descriptors``);
    a lone (scale, kind) runs ``TiledRunner.tpi`` or ``.std``."""
    runner = TiledRunner(tile_rows, pipeline, device)
    check_dem(dem)
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    namers = {"tpi": _tpi_name, "std": _std_name}

    written = {}
    pending = []
    for idx in range(len(scales)):
        done = True
        for kind in kinds:
            if path := _skip(namers[kind](scales[idx], smth_factors[idx]), outdir, skip_existing):
                written[(kind, idx)] = path
            else:
                done = False
        if not done:
            pending.append(idx)

    groups = {}
    for idx in pending:
        groups.setdefault(sigmas[idx], []).append(idx)

    for sigma, idxs in groups.items():
        sizes = [int(scales_pxl[i]) for i in idxs]
        names = [namers[k](scales[i], smth_factors[i]) for k in kinds for i in idxs]
        with timer(f"{'+'.join(kinds)} x{len(idxs)} scales streamed"), \
                _writers(dem, names, outdir, ["m"] * len(names)) as opened:
            sinks = [_Sink(w, dem, reassign_nans) for _, w in opened]
            if len(idxs) == 1 and len(kinds) == 1:
                op = runner.tpi if kinds[0] == "tpi" else runner.std
                op(dem, sizes[0], sigma, sink=sinks[0])
            else:
                runner.disk_descriptors(
                    dem, sizes, sigma, compute_tpi="tpi" in kinds, compute_std="std" in kinds,
                    sinks={k: sinks[j * len(idxs):(j + 1) * len(idxs)]
                           for j, k in enumerate(kinds)},
                )
        for j, kind in enumerate(kinds):
            for i, idx in enumerate(idxs):
                written[(kind, idx)] = opened[j * len(idxs) + i][0]
    return [written[(k, i)] for k in kinds for i in range(len(scales))]


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
    check_dem(dem)
    logger.info(f"***Streaming gradients computation for scales {scales} meters***")
    scales = _as_list(scales)
    sig_ratios = _as_list(sig_ratios, len(scales))
    scales_pxl, res_meters = geo.scale_to_pixel(scales, dem)
    sigmas = scales_pxl / CFG.scale_std

    written = []
    for idx, sigma in enumerate(sigmas):
        names = _gradient_names(scales[idx], sig_ratios[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        with timer(f"gradient scale {scales[idx]}m streamed"), \
                _writers(dem, names, outdir, ["1", "1", "degree", "degree"]) as opened:
            runner.gradient(dem, float(sigma), res_meters, sig_ratios[idx],
                            sinks=[_Sink(w, dem, reassign_nans) for _, w in opened])
        written.extend(path for path, _ in opened)
    return written


@_streams
def compute_valley_ridge(dem, scales, mode: str, flat_list=(0, 0.15, 0.3), smth_factors=None,
                         outdir=".", tile_rows: int = 4096, reassign_nans: bool = True,
                         skip_existing: bool = False, pipeline: bool = True, device="cuda"):
    """Streamed valley/ridge driver (reference compute_valley_ridge,
    topo.py:317-386). The global standardization stats come from a
    band-wise float64 host pass over the (optionally smoothed) field."""
    runner = TiledRunner(tile_rows, pipeline, device)
    check_dem(dem)
    logger.info(f"***Streaming {mode} index computation for scales {scales} meters***")
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)

    written = []
    for idx, scale_pxl in enumerate(scales_pxl):
        names = _valley_ridge_names(scales[idx], mode, smth_factors[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        with timer(f"{mode} scale {scales[idx]}m streamed"), \
                _writers(dem, names, outdir, ["1", "1"]) as opened:
            runner.valley_ridge(dem, int(scale_pxl), mode, list(flat_list), sigmas[idx],
                                sinks=[_Sink(w, dem, reassign_nans) for _, w in opened])
        written.extend(path for path, _ in opened)
    return written


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
    if skip_existing and all(_existing(n, outdir) for n in names):
        return [_existing(n, outdir) for n in names]
    logger.info(f"***Streaming Sx for azimuths {azimuths} and radius {radius}***")
    _, res_meters = geo.scale_to_pixel(radius, dem)
    dx = float(res_meters["x"].mean())
    dy = float(res_meters["y"].mean())

    with timer(f"sx {len(azimuths)} azimuths r {radius}m streamed"), \
            _writers(dem, names, outdir, ["degree"] * len(names)) as opened:
        sinks = [_Sink(w, dem, reassign_nans) for _, w in opened]
        if len(azimuths) == 1:
            offsets, distances, border = sx_offsets(
                azimuths[0], radius, dx, dy, azimuth_arc, azimuth_steps, radius_min)
            runner.sx(dem, offsets, distances, border, height, sink=sinks[0])
        else:
            offsets, distances, border = sx_sweep_offsets(
                azimuths, radius, dx, dy, azimuth_arc, azimuth_steps, radius_min)
            runner.sx_sweep(dem, offsets, distances, border, height, sink=_StackSink(sinks))
    return [path for path, _ in opened]


# --- windowed ingest -> device mesh ------------------------------------------


def _fetch_banded(arr, valid_shape, sink, band_rows: int = 2048):
    """Stream a sharded (H, W) array to ``sink`` in row bands, the ragged
    pad cropped; no host array of the whole grid."""
    vh, vw = valid_shape
    for r0 in range(0, vh, band_rows):
        sink(r0, arr[r0 : min(r0 + band_rows, vh), :vw])


def _ingest(dem, sops, fill):
    """(DEM on the mesh, valid_shape, ``valid_shape=`` for a padded grid)."""
    dem_s, valid_shape = ingest_sharded(dem, sops.mesh, fill=fill)
    padded = tuple(dem_s.shape) != tuple(valid_shape)
    return dem_s, valid_shape, {"valid_shape": valid_shape} if padded else {}


def _write_sharded(dem, arrays, names, units, outdir, valid_shape, reassign_nans, band_rows):
    """Write each sharded (H, W) array to its output in row bands, through
    writers that are all aborted if anything fails; the written paths."""
    with _writers(dem, names, outdir, units) as opened:
        for arr, (_, writer) in zip(arrays, opened):
            _fetch_banded(arr, valid_shape, _Sink(writer, dem, reassign_nans), band_rows)
    return [path for path, _ in opened]


@_streams
def compute_tpi_std_sharded(dem, scales, sops, kinds=("tpi", "std"), smth_factors=None,
                            outdir=".", reassign_nans: bool = True, skip_existing: bool = False,
                            band_rows: int = 2048):
    """Windowed ingest -> device mesh -> banded NetCDF output, for TPI
    and/or STD: each process reads only its blocks from disk, every sigma
    group runs as one fused :meth:`ShardedOps.disk_descriptors` call, and
    the outputs stream back in row bands."""
    check_dem(dem)
    logger.info(f"***Sharded-streaming {'+'.join(kinds)} for scales {scales} meters***")
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    namers = {"tpi": _tpi_name, "std": _std_name}

    written, pending = {}, []
    for idx in range(len(scales)):
        paths = [_skip(namers[k](scales[idx], smth_factors[idx]), outdir, skip_existing)
                 for k in kinds]
        if all(paths):
            written.update({(k, idx): p for k, p in zip(kinds, paths)})
        else:
            pending.append(idx)
    if pending:
        dem_s, valid_shape, vs = _ingest(dem, sops, 0.0)
        groups = {}
        for idx in pending:
            groups.setdefault(sigmas[idx], []).append(idx)
        for sigma, idxs in groups.items():
            with timer(f"{'+'.join(kinds)} sharded-streamed x{len(idxs)} scales"):
                batch = sops.disk_descriptors(dem_s, [int(scales_pxl[i]) for i in idxs], sigma,
                                              compute_tpi="tpi" in kinds,
                                              compute_std="std" in kinds, **vs)
                keys = [(k, j, i) for k in kinds for j, i in enumerate(idxs)]
                paths = _write_sharded(
                    dem, [batch[k][j] for k, j, _ in keys],
                    [namers[k](scales[i], smth_factors[i]) for k, _, i in keys],
                    ["m"] * len(keys), outdir, valid_shape, reassign_nans, band_rows)
            written.update({(k, i): p for (k, _, i), p in zip(keys, paths)})
    return [written[(k, i)] for k in kinds for i in range(len(scales))]


@_streams
def compute_dem_sharded(dem, scales, sops, outdir=".", reassign_nans: bool = True,
                        skip_existing: bool = False, band_rows: int = 2048):
    """Windowed-ingest sharded smoothed-DEM driver (see
    :func:`compute_tpi_std_sharded`)."""
    check_dem(dem)
    scales = _as_list(scales)
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = scales_pxl / CFG.scale_std
    written, dem_s = [], None
    for idx, sigma in enumerate(sigmas):
        name = _dem_name(scales[idx])
        if path := _skip(name, outdir, skip_existing):
            written.append(path)
            continue
        if dem_s is None:
            dem_s, valid_shape, vs = _ingest(dem, sops, 0.0)
        with timer(f"dem scale {scales[idx]}m sharded-streamed"):
            out = sops.gaussian(dem_s, float(sigma), **vs)
            written += _write_sharded(dem, [out], [name], ["m"], outdir, valid_shape,
                                      reassign_nans, band_rows)
    return written


@_streams
def compute_gradient_sharded(dem, scales, sops, sig_ratios=1, outdir=".",
                             reassign_nans: bool = True, skip_existing: bool = False,
                             band_rows: int = 2048):
    """Windowed-ingest sharded gradient/slope/aspect driver (reference
    compute_gradient, topo.py:534-594): the four outputs of a scale come
    from one :meth:`ShardedOps.gradient` call and stream back in row
    bands."""
    check_dem(dem)
    logger.info(f"***Sharded-streaming gradients for scales {scales} meters***")
    scales = _as_list(scales)
    sig_ratios = _as_list(sig_ratios, len(scales))
    scales_pxl, res_meters = geo.scale_to_pixel(scales, dem)
    sigmas = scales_pxl / CFG.scale_std
    written, dem_s = [], None
    for idx, sigma in enumerate(sigmas):
        names = _gradient_names(scales[idx], sig_ratios[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        if dem_s is None:
            dem_s, valid_shape, vs = _ingest(dem, sops, 0.0)
        with timer(f"gradient scale {scales[idx]}m sharded-streamed"):
            arrays = sops.gradient(dem_s, float(sigma), res_meters, sig_ratios[idx], **vs)
            written += _write_sharded(dem, arrays, names, ["1", "1", "degree", "degree"], outdir,
                                      valid_shape, reassign_nans, band_rows)
    return written


@_streams
def compute_valley_ridge_sharded(dem, scales, sops, mode: str, flat_list=(0, 0.15, 0.3),
                                 smth_factors=None, outdir=".", reassign_nans: bool = True,
                                 skip_existing: bool = False, band_rows: int = 2048):
    """Windowed-ingest sharded valley/ridge driver (reference
    compute_valley_ridge, topo.py:317-386). Scales whose rotated bank fits
    ``CFG.valley_bank_max_bytes`` run :meth:`ShardedOps.valley_ridge`,
    larger ones :meth:`ShardedOps.valley_ridge_streamed`."""
    check_dem(dem)
    logger.info(f"***Sharded-streaming {mode} index for scales {scales} meters***")
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    written, dem_s = [], None
    for idx, scale_pxl in enumerate(scales_pxl):
        names = _valley_ridge_names(scales[idx], mode, smth_factors[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        if dem_s is None:
            dem_s, valid_shape, vs = _ingest(dem, sops, 0.0)
        size = int(scale_pxl)
        fits = bank_nbytes(size, len(flat_list)) <= CFG.valley_bank_max_bytes
        with timer(f"{mode} scale {scales[idx]}m sharded-streamed"):
            op = sops.valley_ridge if fits else sops.valley_ridge_streamed
            arrays = op(dem_s, size, mode, list(flat_list), sigmas[idx], **vs)
            written += _write_sharded(dem, arrays, names, ["1", "1"], outdir, valid_shape,
                                      reassign_nans, band_rows)
    return written


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
    if skip_existing and all(_existing(n, outdir) for n in names):
        return [_existing(n, outdir) for n in names]
    logger.info(f"***Sharded-streaming Sx for azimuths {azimuths}, radius {radius}***")
    _, res_meters = geo.scale_to_pixel(radius, dem)
    dx = float(res_meters["x"].mean())
    dy = float(res_meters["y"].mean())
    dem_s, valid_shape, vs = _ingest(dem, sops, np.nan)
    with timer(f"sx sharded-streamed {len(azimuths)} az r {radius}m"):
        if len(azimuths) == 1:
            offsets, distances, border = sx_offsets(
                azimuths[0], radius, dx, dy, azimuth_arc, azimuth_steps, radius_min)
            stack = [sops.sx(dem_s, offsets, distances, border, height, **vs)]
        else:
            offsets, distances, border = sx_sweep_offsets(
                azimuths, radius, dx, dy, azimuth_arc, azimuth_steps, radius_min)
            out = sops.sx_sweep(dem_s, offsets, distances, border, height, **vs)
            stack = [out[a] for a in range(len(azimuths))]
        return _write_sharded(dem, stack, names, ["degree"] * len(names), outdir, valid_shape,
                              reassign_nans, band_rows)
