"""Batch drivers on PyTorch: the single-device subset of
``topo_descriptors_tpu.pipeline``, and the recipe every driver family
shares.

Each driver validates the DEM, converts scales to odd pixel counts, runs
the descriptor ops on ``device`` (default ``"cuda"``), reassigns the
original NaNs, optionally crops, and writes one NetCDF per descriptor
through the shared ``io.netcdf.to_netcdf`` with the reference's naming.
Signatures match the JAX drivers plus ``device=``. ``sharded=`` takes a
:class:`~topo_descriptors_tpu_torch.parallel.ShardedOps` (the blocks of
a device mesh) or a :class:`~topo_descriptors_tpu_torch.parallel.TiledRunner`
(out-of-core bands on the runner's device). :func:`_compute_backend` is
the one place that tells the three backends apart: every driver calls its
descriptor as a method of the backend it returns. The drivers:
``compute_dem``, ``compute_tpi``, ``compute_std``, ``compute_tpi_std``,
``compute_valley_ridge``, ``compute_gradient``, ``compute_sx`` and
``compute_sx_sweep``.

The recipe (a call's scales as sizes and sigmas, the output names and
units, the Sx ray geometry, the per-scale skip loop) is shared with the two
families of :mod:`.streaming`, which differ from these drivers in their
backend and their emit step only.
"""

from __future__ import annotations

import functools
import logging
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from topo_descriptors_tpu_torch import geo, ops
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.device import as_field, resolve_device, to_host
from topo_descriptors_tpu_torch.grid import Raster, check_dem
from topo_descriptors_tpu_torch.io.netcdf import to_netcdf
from topo_descriptors_tpu_torch.kernels.sx_geometry import sx_offsets, sx_sweep_offsets
from topo_descriptors_tpu_torch.parallel.mesh import pad_to_mesh
from topo_descriptors_tpu_torch.parallel.sharded import ShardedOps
from topo_descriptors_tpu_torch.parallel.tiles import TiledRunner
from topo_descriptors_tpu_torch.utils.timing import span, timer

logger = logging.getLogger(__name__)


# --- the recipe of every driver family -----------------------------------------


def _as_list(value, length=None):
    if not hasattr(value, "__iter__"):
        value = [value] if length is None else [value] * length
    return list(value)


class _Scales(NamedTuple):
    meters: list  # as given: the output names carry them
    factors: list  # the smoothing factors, one per scale
    sizes: List[int]  # odd pixel counts
    sigmas: list  # Gaussian sigmas in pixels, None for no smoothing
    res: dict  # the grid's metric resolution, 'x' and 'y'


def _scales(dem, scales, smth_factors=1) -> _Scales:
    """A driver call's scales from its one ``geo.scale_to_pixel`` (on a
    geographic grid, the UTM reprojection). The default factor 1 gives the
    smoothed DEM's and the gradient's sigma, ``size / CFG.scale_std``; the
    disk and valley drivers pass their pre-smooth factors (None or 0: no
    smoothing)."""
    meters = _as_list(scales)
    factors = _as_list(smth_factors, len(meters))
    sizes, res = geo.scale_to_pixel(meters, dem)
    return _Scales(meters, factors, [int(s) for s in sizes], geo.get_sigmas(factors, sizes), res)


def _sx_rays(dem, azimuth, radius, azimuth_arc, azimuth_steps, radius_min):
    """``(offsets, distances, border)`` of the Sx rays at the grid's mean
    metric resolution: ``sx_offsets`` for one azimuth, ``sx_sweep_offsets``
    for a sequence of them (a sweep's fan)."""
    res = _scales(dem, radius).res
    dx, dy = float(res["x"].mean()), float(res["y"].mean())
    rays = sx_offsets if np.ndim(azimuth) == 0 else sx_sweep_offsets
    return rays(azimuth, radius, dx, dy, azimuth_arc, azimuth_steps, radius_min)


# output names of one scale, and their units (reference topo.py:83-85,
# 184-188, 310-314, 456-463, 647-655, 956-960)


def _smth_suffix(smth_factor):
    return f"_SMTHFACT{smth_factor:.3g}" if smth_factor else ""


def _dem_outputs(scale):
    return [f"DEM_{scale}M"], ["m"]


def _disk_name(kind, scale, smth_factor):
    """TPI or STD, in m."""
    return f"{kind.upper()}_{scale}M{_smth_suffix(smth_factor)}"


def _valley_ridge_outputs(scale, mode, smth_factor):
    add = _smth_suffix(smth_factor)
    return [f"{mode}_NORM_{scale}M{add}", f"{mode}_DIR_{scale}M{add}"], ["1", "1"]


def _gradient_outputs(scale, sig_ratio):
    kinds = ("WE_DERIVATIVE", "SN_DERIVATIVE", "SLOPE", "ASPECT")
    return ([f"{k}_{scale}M_SIGRATIO{sig_ratio:.3g}" for k in kinds],
            ["1", "1", "degree", "degree"])


def _sx_name(radius, azimuth):
    """Sx, in degrees."""
    return f"SX_RADIUS{int(radius)}_AZIMUTH{int(azimuth)}"


def _on_disk(names, outdir, skip_existing) -> Optional[List[Path]]:
    """The outputs' paths when ``skip_existing`` finds every one on disk,
    else None. Per-(descriptor, scale) outputs are independent files, so a
    rerun can skip the ones already there."""
    if skip_existing:
        paths = [Path(outdir) / f"topo_{str.upper(n)}.nc" for n in names]
        if all(p.exists() for p in paths):
            logger.info(f"skipping existing {paths}")
            return paths
    return None


def _per_scale(outputs, outdir, skip_existing, run) -> List[Path]:
    """Every output path of a per-scale driver, in order. ``outputs[i]``
    is scale i's ``(names, units)``; ``run(i, names, units)`` computes and
    writes them unless :func:`_on_disk` finds them all."""
    written = []
    for i, (names, units) in enumerate(outputs):
        written += _on_disk(names, outdir, skip_existing) or run(i, names, units)
    return written


# --- the backend seam and the emit step of the in-memory drivers ----------------


class _OneDevice:
    """One pass on one device, with the method surface of ShardedOps and
    TiledRunner: each method runs the op of its name (``ops.dem`` for
    ``gaussian``), looked up at call time, on the field's device."""

    def gaussian(self, x, sigma):
        return ops.dem(x, sigma, device=x.device)

    def tpi(self, x, size, sigma=None):
        return ops.tpi(x, size, sigma, device=x.device)

    def std(self, x, size, sigma=None):
        return ops.std(x, size, sigma, device=x.device)

    def disk_descriptors(self, x, sizes, sigma, **kinds):
        return ops.disk_descriptors(x, sizes, sigma, device=x.device, **kinds)

    def gradient(self, x, sigma, res_meters, sig_ratio):
        return ops.gradient(x, sigma, res_meters, sig_ratio, device=x.device)

    def valley_ridge(self, x, size, mode, flat_list, sigma):
        return ops.valley_ridge(x, size, mode, flat_list, sigma, device=x.device)

    def sx(self, x, offsets, distances, border, height):
        return ops.sx(x, offsets, distances, border, height, device=x.device)

    def sx_sweep(self, x, offsets, distances, border, height):
        return ops.sx_sweep(x, offsets, distances, border, height, device=x.device)


class _Padded:
    """A ShardedOps on a grid padded to its mesh: every method gets the
    grid's own shape as ``valid_shape``."""

    def __init__(self, sops: ShardedOps, valid_shape):
        self._sops, self._valid_shape = sops, valid_shape

    def __getattr__(self, name):
        return functools.partial(getattr(self._sops, name), valid_shape=self._valid_shape)


def _compute_backend(dem_val, backend, device, ragged_fill):
    """``(ops, array, to_host)``: the backend whose methods run the
    descriptors, the DEM as it takes it, and the download of its results.

    ``backend=None`` (one pass on one device): :class:`_OneDevice` and a
    tensor on ``device``. A :class:`TiledRunner`: the runner and the
    float32 host array, which it streams to its own device in bands. A
    :class:`ShardedOps`: the DEM placed on its mesh. ``device`` must
    resolve to the runner's device or to one of the mesh's.

    On a mesh that the grid does not divide, the DEM is padded bottom/right
    with ``ragged_fill`` (``pad_to_mesh``), the backend passes the grid's
    shape as ``valid_shape`` to each method (:class:`_Padded`), and
    ``to_host`` crops back.
    """
    if backend is None:
        with span("upload"):
            dem_val = np.asarray(dem_val, dtype=CFG.compute_dtype)
            return _OneDevice(), as_field(dem_val, device), _to_host
    dem_val = np.asarray(dem_val, dtype=CFG.compute_dtype)
    if isinstance(backend, TiledRunner):
        if resolve_device(device) != backend.device:
            raise ValueError(f"device={device!r} but the TiledRunner runs on {backend.device}; "
                             "pass the runner's device")
        return backend, dem_val, np.asarray
    if not isinstance(backend, ShardedOps):
        raise TypeError(f"sharded= takes a ShardedOps or a TiledRunner, not "
                        f"{type(backend).__name__}")
    if resolve_device(device) not in backend.mesh.local_devices():
        raise ValueError(f"device={device!r} but the mesh's blocks live on "
                         f"{sorted(set(map(str, backend.mesh.local_devices())))}; pass one of them")
    sops = backend
    h, w = dem_val.shape
    if h % backend.gy or w % backend.gx:
        dem_val, _ = pad_to_mesh(dem_val, backend.mesh, fill=ragged_fill)
        sops = _Padded(backend, (h, w))

    def to_host(a):
        return np.asarray(a.numpy())[..., :h, :w]

    return sops, backend.put(dem_val), to_host


def _to_host(t: torch.Tensor) -> np.ndarray:
    with span("d2h"):
        return to_host(t)


def _apply_nans(array: np.ndarray, ind_nans) -> np.ndarray:
    with span("nan_pass"):
        array = np.array(array)
        if ind_nans is not None and len(ind_nans) and len(ind_nans[0]):
            array[ind_nans] = np.nan
        return array


def _saver(dem_ds, ind_nans, crop, outdir):
    """The in-memory drivers' emit step for host planes: the original NaNs
    put back (:func:`_apply_nans`), then one ``to_netcdf`` each (looked up
    at call time)."""

    def save(planes, names, units) -> List[Path]:
        return [to_netcdf(_apply_nans(plane, ind_nans), dem_ds, name, crop, outdir, unit)
                for plane, name, unit in zip(planes, names, units)]

    return save


# --- drivers -----------------------------------------------------------------


def compute_dem(
    dem_ds: Raster,
    scales,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
    device="cuda",
):
    """Smoothed DEM at each scale (reference compute_dem, topo.py:16-59)."""
    logger.info(f"***Starting dem computation for scales {scales} meters***")
    plan = _scales(dem_ds, scales)
    backend, x, to_host = _compute_backend(dem_ds.data, sharded, device, 0.0)
    save = _saver(dem_ds, ind_nans, crop, outdir)

    def run(i, names, units):
        logger.info(f"Computing scale {plan.meters[i]} meters")
        with timer(f"dem scale {plan.meters[i]}m"):
            planes = [to_host(backend.gaussian(x, plan.sigmas[i]))]
        return save(planes, names, units)

    return _per_scale(map(_dem_outputs, plan.meters), outdir, skip_existing, run)


def _compute_disk_family(
    dem_ds: Raster,
    scales,
    smth_factors,
    kinds: Sequence[str],
    ind_nans,
    crop,
    outdir,
    sharded,
    skip_existing,
    device,
):
    """Shared driver for the disk-kernel descriptors (TPI, rolling STD).

    Under ``skip_existing`` only the (scale, kind) outputs missing on disk
    run. Scales that share one pre-smooth sigma and the same missing kinds
    run as one ``disk_descriptors`` batch when there are several of them
    or both kinds are asked for; a lone (scale, kind) runs ``tpi`` or
    ``std``. Output files keep the reference's per-(descriptor, scale)
    contract. On a ragged mesh the grid is zero-padded, and the valid-aware
    sharded ops (true-edge reflection, masked centring, the true grid's tap
    counts) keep the cropped result the single pass's.
    """
    plan = _scales(dem_ds, scales, smth_factors)

    def name(kind, i):
        return _disk_name(kind, plan.meters[i], plan.factors[i])

    written: Dict[tuple, Path] = {}
    groups: Dict[tuple, List[int]] = {}  # (sigma, missing kinds) -> scales of one batch
    for i, sigma in enumerate(plan.sigmas):
        missing = []
        for kind in kinds:
            if paths := _on_disk([name(kind, i)], outdir, skip_existing):
                written[(kind, i)] = paths[0]
            else:
                missing.append(kind)
        if missing:
            groups.setdefault((sigma, tuple(missing)), []).append(i)

    backend, x, to_host = _compute_backend(dem_ds.data, sharded, device, 0.0)
    save = _saver(dem_ds, ind_nans, crop, outdir)
    for (sigma, kk), idxs in groups.items():
        if len(idxs) > 1 or len(kk) > 1:
            logger.info(f"Computing scales {[plan.meters[i] for i in idxs]} meters fused "
                        f"({'+'.join(kk)}, sigma {sigma}) ...")
            with timer(f"{'+'.join(kk)} fused x{len(idxs)} scales"):
                batch = backend.disk_descriptors(x, tuple(plan.sizes[i] for i in idxs), sigma,
                                                 compute_tpi="tpi" in kk,
                                                 compute_std="std" in kk)
                batch = {k: to_host(v) for k, v in batch.items()}
            planes = {(kind, i): batch[kind][j] for j, i in enumerate(idxs) for kind in kk}
        else:
            (i,), (kind,) = idxs, kk
            logger.info(f"Computing scale {plan.meters[i]} meters with smoothing factor"
                        f" {plan.factors[i]} ...")
            with timer(f"{kind} scale {plan.meters[i]}m"):
                planes = {(kind, i): to_host(getattr(backend, kind)(x, plan.sizes[i], sigma))}
        for key, plane in planes.items():
            (written[key],) = save([plane], [name(*key)], ["m"])

    return [written[(kind, i)] for kind in kinds for i in range(len(plan.meters))]


def compute_tpi(
    dem_ds: Raster,
    scales,
    smth_factors=None,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
    device="cuda",
):
    """TPI at each scale (reference compute_tpi, topo.py:88-141)."""
    logger.info(f"***Starting TPI computation for scales {scales} meters***")
    return _compute_disk_family(
        dem_ds, scales, smth_factors, ("tpi",), ind_nans, crop, outdir,
        sharded, skip_existing, device,
    )


def compute_std(
    dem_ds: Raster,
    scales,
    smth_factors=None,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
    device="cuda",
):
    """Rolling STD at each scale (reference compute_std, topo.py:216-269)."""
    logger.info(f"***Starting STD computation for scales {scales} meters***")
    return _compute_disk_family(
        dem_ds, scales, smth_factors, ("std",), ind_nans, crop, outdir,
        sharded, skip_existing, device,
    )


def compute_tpi_std(
    dem_ds: Raster,
    scales,
    smth_factors=None,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
    device="cuda",
):
    """TPI and rolling STD for every scale on shared moment fields: the same
    files as :func:`compute_tpi` then :func:`compute_std`."""
    logger.info(
        f"***Starting fused TPI+STD computation for scales {scales} meters***"
    )
    return _compute_disk_family(
        dem_ds, scales, smth_factors, ("tpi", "std"), ind_nans, crop, outdir,
        sharded, skip_existing, device,
    )


def compute_valley_ridge(
    dem_ds: Raster,
    scales,
    mode: str,
    flat_list=(0, 0.15, 0.3),
    smth_factors=None,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
    device="cuda",
):
    """Valley/ridge index at each scale (reference compute_valley_ridge,
    topo.py:317-386). Every backend takes the route itself: the precomputed
    bank within ``CFG.valley_bank_max_bytes``, the streamed on-device
    rotation above it (``ops.valley_ridge.bank_fits``)."""
    logger.info(f"***Starting {mode} index computation for scales {scales} meters***")
    plan = _scales(dem_ds, scales, smth_factors)
    backend, x, to_host = _compute_backend(dem_ds.data, sharded, device, 0.0)
    save = _saver(dem_ds, ind_nans, crop, outdir)

    def run(i, names, units):
        logger.info(f"Computing scale {plan.meters[i]} meters with smoothing factor"
                    f" {plan.factors[i]} ...")
        with timer(f"{mode} scale {plan.meters[i]}m"):
            planes = [to_host(a) for a in backend.valley_ridge(
                x, plan.sizes[i], mode, list(flat_list), plan.sigmas[i])]
        return save(planes, names, units)

    outputs = [_valley_ridge_outputs(m, mode, f) for m, f in zip(plan.meters, plan.factors)]
    return _per_scale(outputs, outdir, skip_existing, run)


def compute_gradient(
    dem_ds: Raster,
    scales,
    sig_ratios=1,
    ind_nans=None,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
    device="cuda",
):
    """Gradients/slope/aspect at each scale (reference compute_gradient,
    topo.py:534-594)."""
    logger.info(f"***Starting gradients computation for scales {scales} meters***")
    plan = _scales(dem_ds, scales)
    sig_ratios = _as_list(sig_ratios, len(plan.meters))
    backend, x, to_host = _compute_backend(dem_ds.data, sharded, device, 0.0)
    save = _saver(dem_ds, ind_nans, crop, outdir)

    def run(i, names, units):
        logger.info(f"Computing scale {plan.meters[i]} meters with sigma ratio "
                    f"{sig_ratios[i]} ...")
        with timer(f"gradient scale {plan.meters[i]}m"):
            planes = [to_host(a) for a in backend.gradient(
                x, plan.sigmas[i], plan.res, sig_ratios[i])]
        return save(planes, names, units)

    outputs = [_gradient_outputs(m, r) for m, r in zip(plan.meters, sig_ratios)]
    return _per_scale(outputs, outdir, skip_existing, run)


def sx(
    dem_ds: Raster,
    azimuth: float,
    radius: float,
    height: float = 10.0,
    azimuth_arc: float = 10.0,
    azimuth_steps: int = 15,
    radius_min: float = 0.0,
    sharded=None,
    device="cuda",
) -> np.ndarray:
    """Sx horizon scan for one azimuth (reference sx, topo.py:776-858).

    Takes the full Raster: the geometry needs the grid's metric resolution.
    On a mesh that the grid does not divide, the DEM is padded with NaN,
    which the ray maximum skips as it skips the beyond-edge fill.
    """
    if not isinstance(dem_ds, Raster):
        raise TypeError("Argument 'dem_ds' must be a Raster.")
    backend, x, to_host = _compute_backend(dem_ds.data, sharded, device, np.nan)
    rays = _sx_rays(dem_ds, azimuth, radius, azimuth_arc, azimuth_steps, radius_min)
    with timer(f"sx az {azimuth} r {radius}m"):
        return to_host(backend.sx(x, *rays, height))


def compute_sx_sweep(
    dem_ds: Raster,
    azimuths,
    radius: float,
    height: float = 10.0,
    azimuth_arc: float = 10.0,
    azimuth_steps: int = 15,
    radius_min: float = 0.0,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
    device="cuda",
):
    """Sx for a fan of azimuths in one ``sx_sweep`` call (on a mesh, one
    halo exchange; on a runner, one window per band): the same files as
    :func:`compute_sx` for each azimuth, in the order given (reference
    usage: a 0-350 degree sweep is 36 ``compute_sx`` runs)."""
    check_dem(dem_ds)
    azimuths = _as_list(azimuths)
    names = [_sx_name(radius, a) for a in azimuths]
    if paths := _on_disk(names, outdir, skip_existing):
        return paths
    logger.info(
        f"***Starting Sx sweep for azimuths {azimuths} and radius {radius}***"
    )
    backend, x, to_host = _compute_backend(dem_ds.data, sharded, device, np.nan)
    rays = _sx_rays(dem_ds, azimuths, radius, azimuth_arc, azimuth_steps, radius_min)
    with timer(f"sx sweep {len(azimuths)} azimuths r {radius}m"):
        stack = to_host(backend.sx_sweep(x, *rays, height))
    return [
        to_netcdf(array, dem_ds, name, crop, outdir, "degree")
        for array, name in zip(stack, names)
    ]


def compute_sx(
    dem_ds: Raster,
    azimuth: float,
    radius: float,
    height: float = 10.0,
    azimuth_arc: float = 10.0,
    azimuth_steps: int = 15,
    radius_min: float = 0.0,
    crop=None,
    outdir=".",
    sharded=None,
    skip_existing=False,
    device="cuda",
):
    """Sx driver (reference compute_sx, topo.py:715-772)."""
    check_dem(dem_ds)
    name = _sx_name(radius, azimuth)
    if paths := _on_disk([name], outdir, skip_existing):
        return paths
    logger.info(
        f"***Starting Sx computation for azimuth {azimuth} and radius {radius}***"
    )
    array = sx(
        dem_ds,
        azimuth,
        radius,
        height=height,
        azimuth_arc=azimuth_arc,
        azimuth_steps=azimuth_steps,
        radius_min=radius_min,
        sharded=sharded,
        device=device,
    )
    return [to_netcdf(array, dem_ds, name, crop, outdir, "degree")]
