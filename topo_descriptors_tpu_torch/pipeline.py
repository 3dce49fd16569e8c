"""Batch drivers on PyTorch: the single-device subset of
``topo_descriptors_tpu.pipeline``.

Each driver validates the DEM, converts scales to odd pixel counts, runs
the descriptor ops on ``device`` (default ``"cuda"``), reassigns the
original NaNs, optionally crops, and writes one NetCDF per descriptor
through the shared ``io.netcdf.to_netcdf`` with the reference's naming.
Signatures match the JAX drivers plus ``device=``. ``sharded=`` takes a
:class:`~topo_descriptors_tpu_torch.parallel.ShardedOps` (the blocks of
a device mesh) or a :class:`~topo_descriptors_tpu_torch.parallel.TiledRunner`
(out-of-core bands on the runner's device). The drivers: ``compute_dem``,
``compute_tpi``, ``compute_std``, ``compute_tpi_std``,
``compute_valley_ridge``, ``compute_gradient``, ``compute_sx`` and
``compute_sx_sweep``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from topo_descriptors_tpu_torch import geo, ops
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.device import as_field, resolve_device, to_host
from topo_descriptors_tpu_torch.grid import Raster, check_dem
from topo_descriptors_tpu_torch.io.netcdf import to_netcdf
from topo_descriptors_tpu_torch.kernels.sx_geometry import sx_offsets, sx_sweep_offsets
from topo_descriptors_tpu_torch.ops.valley_ridge import bank_nbytes
from topo_descriptors_tpu_torch.parallel.mesh import pad_to_mesh
from topo_descriptors_tpu_torch.parallel.sharded import ShardedOps
from topo_descriptors_tpu_torch.parallel.tiles import TiledRunner
from topo_descriptors_tpu_torch.utils.timing import span, timer

logger = logging.getLogger(__name__)


def _as_list(value, length=None):
    if not hasattr(value, "__iter__"):
        value = [value] if length is None else [value] * length
    return list(value)


def _apply_nans(array: np.ndarray, ind_nans) -> np.ndarray:
    with span("nan_pass"):
        array = np.array(array)
        if ind_nans is not None and len(ind_nans) and len(ind_nans[0]):
            array[ind_nans] = np.nan
        return array


def _existing(name: str, outdir) -> Optional[Path]:
    """Per-(descriptor, scale) outputs are independent files, so a rerun can
    skip the ones already on disk."""
    path = Path(outdir) / f"topo_{str.upper(name)}.nc"
    return path if path.exists() else None


def _compute_backend(dem_val, backend, device, ragged_fill=None):
    """``(array for the backend, to_host, valid_shape)``.

    ``backend=None`` (one pass on one device): a tensor on ``device``. A
    :class:`TiledRunner`: the float32 host array, which the runner streams
    to its own device in bands. A :class:`ShardedOps`: the DEM placed on
    its mesh. ``device`` must resolve to the runner's device or to one of
    the mesh's.

    ``valid_shape`` is the grid's shape. It differs from the array's only
    on a mesh that the grid does not divide: the DEM is then padded
    bottom/right with ``ragged_fill`` (``pad_to_mesh``) and ``to_host``
    crops back. A driver whose op has no exact padded form passes
    ``ragged_fill=None`` and gets an actionable error instead.
    """
    if backend is None:
        with span("upload"):
            dem_val = np.asarray(dem_val, dtype=CFG.compute_dtype)
            return as_field(dem_val, device), _to_host, dem_val.shape
    dem_val = np.asarray(dem_val, dtype=CFG.compute_dtype)
    shape = dem_val.shape
    if isinstance(backend, TiledRunner):
        if resolve_device(device) != backend.device:
            raise ValueError(f"device={device!r} but the TiledRunner runs on {backend.device}; "
                             "pass the runner's device")
        return dem_val, np.asarray, shape
    if not isinstance(backend, ShardedOps):
        raise TypeError(f"sharded= takes a ShardedOps or a TiledRunner, not "
                        f"{type(backend).__name__}")
    if resolve_device(device) not in backend.mesh.local_devices():
        raise ValueError(f"device={device!r} but the mesh's blocks live on "
                         f"{sorted(set(map(str, backend.mesh.local_devices())))}; pass one of them")
    h, w = shape
    if h % backend.gy or w % backend.gx:
        if ragged_fill is None:
            raise ValueError(
                f"grid {shape} does not divide the ({backend.gy}, {backend.gx}) mesh and this "
                "descriptor has no exact padded formulation; choose a mesh shape that divides "
                "the grid or use the tiled runner")
        dem_val, _ = pad_to_mesh(dem_val, backend.mesh, fill=ragged_fill)

    def to_host(a):
        return np.asarray(a.numpy())[..., :h, :w]

    return backend.put(dem_val), to_host, shape


def _to_host(t: torch.Tensor) -> np.ndarray:
    with span("d2h"):
        return to_host(t)


def _valid_kwargs(backend, array, valid_shape) -> dict:
    """``valid_shape=`` for a ShardedOps call on a padded grid."""
    if isinstance(backend, ShardedOps) and tuple(array.shape) != tuple(valid_shape):
        return {"valid_shape": valid_shape}
    return {}


# --- naming (reference topo.py:83-85, 184-188, 310-314, 456-463, 647-655,
#     956-960) ---------------------------------------------------------------


def _dem_name(scale):
    return f"DEM_{scale}M"


def _smth_suffix(smth_factor):
    return f"_SMTHFACT{smth_factor:.3g}" if smth_factor else ""


def _tpi_name(scale, smth_factor):
    return f"TPI_{scale}M{_smth_suffix(smth_factor)}"


def _std_name(scale, smth_factor):
    return f"STD_{scale}M{_smth_suffix(smth_factor)}"


def _valley_ridge_names(scale, mode, smth_factor):
    add = _smth_suffix(smth_factor)
    return [f"{mode}_NORM_{scale}M{add}", f"{mode}_DIR_{scale}M{add}"]


def _gradient_names(scale, sig_ratio):
    return [
        f"WE_DERIVATIVE_{scale}M_SIGRATIO{sig_ratio:.3g}",
        f"SN_DERIVATIVE_{scale}M_SIGRATIO{sig_ratio:.3g}",
        f"SLOPE_{scale}M_SIGRATIO{sig_ratio:.3g}",
        f"ASPECT_{scale}M_SIGRATIO{sig_ratio:.3g}",
    ]


def _sx_name(radius, azimuth):
    return f"SX_RADIUS{int(radius)}_AZIMUTH{int(azimuth)}"


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
    check_dem(dem_ds)
    logger.info(f"***Starting dem computation for scales {scales} meters***")
    scales = _as_list(scales)
    scales_pxl, _ = geo.scale_to_pixel(scales, dem_ds)
    sigmas = scales_pxl / CFG.scale_std
    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, device, 0.0)
    vs = _valid_kwargs(sharded, dem_dev, valid_shape)

    written = []
    for idx, sigma in enumerate(sigmas):
        name = _dem_name(scales[idx])
        if skip_existing and (path := _existing(name, outdir)):
            logger.info(f"skipping existing {path}")
            written.append(path)
            continue
        logger.info(f"Computing scale {scales[idx]} meters")
        with timer(f"dem scale {scales[idx]}m"):
            if sharded is None:
                array = to_host(ops.dem(dem_dev, float(sigma), device=dem_dev.device))
            else:
                array = to_host(sharded.gaussian(dem_dev, float(sigma), **vs))
        array = _apply_nans(array, ind_nans)
        written.append(to_netcdf(array, dem_ds, name, crop, outdir, "m"))
    return written


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

    Scales that share one pre-smooth sigma run as one
    :func:`ops.disk_descriptors` batch when there are several of them or
    both kinds are asked for; a lone (scale, kind) runs :func:`ops.tpi` or
    :func:`ops.std`. Output files keep the reference's per-(descriptor,
    scale) contract. A :class:`TiledRunner` or :class:`ShardedOps` backend
    runs the same grouping banded or on the mesh; a ragged grid is
    zero-padded to the mesh, and the valid-aware sharded ops (true-edge
    reflection, masked centring, the true grid's tap counts) keep the
    cropped result the single pass's.
    """
    check_dem(dem_ds)
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem_ds)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    namers = {"tpi": _tpi_name, "std": _std_name}

    written: Dict[tuple, Path] = {}
    pending: Dict[int, List[str]] = {}
    for idx in range(len(scales)):
        for kind in kinds:
            name = namers[kind](scales[idx], smth_factors[idx])
            if skip_existing and (path := _existing(name, outdir)):
                logger.info(f"skipping existing {path}")
                written[(kind, idx)] = path
            else:
                pending.setdefault(idx, []).append(kind)

    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, device, 0.0)
    vs = _valid_kwargs(sharded, dem_dev, valid_shape)

    def write(kind, idx, array):
        array = _apply_nans(array, ind_nans)
        name = namers[kind](scales[idx], smth_factors[idx])
        written[(kind, idx)] = to_netcdf(array, dem_ds, name, crop, outdir, "m")

    # group by (sigma, kind set): members of a group share one fused batch
    groups: Dict[tuple, List[int]] = {}
    for idx, kk in pending.items():
        groups.setdefault((sigmas[idx], tuple(kk)), []).append(idx)

    for (sigma, kk), idxs in groups.items():
        if len(idxs) > 1 or len(kk) > 1:
            sizes = tuple(int(scales_pxl[i]) for i in idxs)
            logger.info(
                f"Computing scales {[scales[i] for i in idxs]} meters fused "
                f"({'+'.join(kk)}, sigma {sigma}) ..."
            )
            with timer(f"{'+'.join(kk)} fused x{len(idxs)} scales"):
                kwargs = dict(compute_tpi="tpi" in kk, compute_std="std" in kk)
                if sharded is None:
                    batch = ops.disk_descriptors(dem_dev, sizes, sigma, device=dem_dev.device,
                                                 **kwargs)
                else:
                    batch = sharded.disk_descriptors(dem_dev, sizes, sigma, **vs, **kwargs)
                batch = {k: to_host(v) for k, v in batch.items()}
            for j, idx in enumerate(idxs):
                for kind in kk:
                    write(kind, idx, batch[kind][j])
            continue
        for idx in idxs:
            logger.info(
                f"Computing scale {scales[idx]} meters with smoothing factor"
                f" {smth_factors[idx]} ..."
            )
            for kind in kk:
                with timer(f"{kind} scale {scales[idx]}m"):
                    if sharded is None:
                        op = ops.tpi if kind == "tpi" else ops.std
                        array = op(dem_dev, int(scales_pxl[idx]), sigmas[idx],
                                   device=dem_dev.device)
                    else:
                        op = sharded.tpi if kind == "tpi" else sharded.std
                        array = op(dem_dev, int(scales_pxl[idx]), sigmas[idx], **vs)
                    array = to_host(array)
                write(kind, idx, array)

    return [
        written[(kind, idx)] for kind in kinds for idx in range(len(scales))
    ]


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
    topo.py:317-386). :func:`ops.valley_ridge` picks the route: the
    precomputed bank within ``CFG.valley_bank_max_bytes``, the streamed
    on-device rotation above it; a :class:`ShardedOps` backend takes the
    same choice between its ``valley_ridge`` and ``valley_ridge_streamed``,
    a :class:`TiledRunner` makes it per band."""
    check_dem(dem_ds)
    logger.info(f"***Starting {mode} index computation for scales {scales} meters***")
    scales = _as_list(scales)
    smth_factors = _as_list(smth_factors, len(scales))
    scales_pxl, _ = geo.scale_to_pixel(scales, dem_ds)
    sigmas = geo.get_sigmas(smth_factors, scales_pxl)
    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, device, 0.0)
    vs = _valid_kwargs(sharded, dem_dev, valid_shape)

    written = []
    for idx, scale_pxl in enumerate(scales_pxl):
        names = _valley_ridge_names(scales[idx], mode, smth_factors[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        logger.info(
            f"Computing scale {scales[idx]} meters with smoothing factor"
            f" {smth_factors[idx]} ..."
        )
        with timer(f"{mode} scale {scales[idx]}m"):
            if sharded is None:
                arrays = ops.valley_ridge(
                    dem_dev, int(scale_pxl), mode, list(flat_list), sigmas[idx],
                    device=dem_dev.device,
                )
            elif isinstance(sharded, ShardedOps):
                fits = bank_nbytes(int(scale_pxl), len(flat_list)) <= CFG.valley_bank_max_bytes
                op = sharded.valley_ridge if fits else sharded.valley_ridge_streamed
                arrays = op(dem_dev, int(scale_pxl), mode, list(flat_list), sigmas[idx], **vs)
            else:  # routes by the bank budget per band, as the op does
                arrays = sharded.valley_ridge(
                    dem_dev, int(scale_pxl), mode, list(flat_list), sigmas[idx]
                )
            arrays = [to_host(a) for a in arrays]
        for array, name in zip(arrays, names):
            array = _apply_nans(array, ind_nans)
            written.append(to_netcdf(array, dem_ds, name, crop, outdir, "1"))
    return written


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
    check_dem(dem_ds)
    logger.info(f"***Starting gradients computation for scales {scales} meters***")
    scales = _as_list(scales)
    sig_ratios = _as_list(sig_ratios, len(scales))
    scales_pxl, res_meters = geo.scale_to_pixel(scales, dem_ds)
    sigmas = scales_pxl / CFG.scale_std
    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, device, 0.0)
    vs = _valid_kwargs(sharded, dem_dev, valid_shape)
    all_units = ["1", "1", "degree", "degree"]

    written = []
    for idx, sigma in enumerate(sigmas):
        names = _gradient_names(scales[idx], sig_ratios[idx])
        paths = [_existing(n, outdir) for n in names]
        if skip_existing and all(paths):
            logger.info(f"skipping existing {paths}")
            written.extend(paths)
            continue
        logger.info(
            f"Computing scale {scales[idx]} meters with sigma ratio "
            f"{sig_ratios[idx]} ..."
        )
        with timer(f"gradient scale {scales[idx]}m"):
            if sharded is None:
                arrays = ops.gradient(
                    dem_dev, float(sigma), res_meters, sig_ratios[idx], device=dem_dev.device
                )
            else:
                arrays = sharded.gradient(dem_dev, float(sigma), res_meters, sig_ratios[idx],
                                          **vs)
            arrays = [to_host(a) for a in arrays]
        for array, name, units in zip(arrays, names, all_units):
            array = _apply_nans(array, ind_nans)
            written.append(to_netcdf(array, dem_ds, name, crop, outdir, units))
    return written


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
    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, device, np.nan)
    _, res_meters = geo.scale_to_pixel(radius, dem_ds)
    dx = float(res_meters["x"].mean())
    dy = float(res_meters["y"].mean())
    offsets, distances, border = sx_offsets(
        azimuth, radius, dx, dy, azimuth_arc, azimuth_steps, radius_min
    )
    with timer(f"sx az {azimuth} r {radius}m"):
        if sharded is not None:
            return to_host(sharded.sx(dem_dev, offsets, distances, border, height,
                                      **_valid_kwargs(sharded, dem_dev, valid_shape)))
        return to_host(
            ops.sx(dem_dev, offsets, distances, border, height,
                   device=dem_dev.device)
        )


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
    """Sx for a fan of azimuths in one :func:`ops.sx_sweep` call: the same
    files as :func:`compute_sx` for each azimuth, in the order given
    (reference usage: a 0-350 degree sweep is 36 ``compute_sx`` runs)."""
    check_dem(dem_ds)
    azimuths = _as_list(azimuths)
    names = [_sx_name(radius, a) for a in azimuths]
    if skip_existing and all(_existing(n, outdir) for n in names):
        return [_existing(n, outdir) for n in names]
    logger.info(
        f"***Starting Sx sweep for azimuths {azimuths} and radius {radius}***"
    )
    dem_dev, to_host, valid_shape = _compute_backend(dem_ds.data, sharded, device, np.nan)
    _, res_meters = geo.scale_to_pixel(radius, dem_ds)
    dx = float(res_meters["x"].mean())
    dy = float(res_meters["y"].mean())
    offsets, distances, border = sx_sweep_offsets(
        azimuths, radius, dx, dy, azimuth_arc, azimuth_steps, radius_min
    )
    with timer(f"sx sweep {len(azimuths)} azimuths r {radius}m"):
        if sharded is None:
            stack = ops.sx_sweep(dem_dev, offsets, distances, border, height,
                                 device=dem_dev.device)
        else:  # one halo exchange or one window per band for the whole fan
            stack = sharded.sx_sweep(dem_dev, offsets, distances, border, height,
                                     **_valid_kwargs(sharded, dem_dev, valid_shape))
        stack = to_host(stack)
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
    if skip_existing and (path := _existing(name, outdir)):
        logger.info(f"skipping existing {path}")
        return [path]
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
