"""Command-line batch driver of the PyTorch port.

The counterpart of ``topo_descriptors_tpu.cli``: ingest a DEM, fill NaNs,
and run a battery of descriptors over a list of scales, writing one NetCDF
per (descriptor, scale). Same flags and battery (TPI and STD fused when
both are asked for, the Sx sweep for more than one azimuth, ``--sharded``
and ``--mesh``, ``--tiled``, ``--stream``, ``--skip-existing``, crop),
plus ``--device`` (default ``cuda``, which exits with an error where CUDA
is missing; ``cpu`` runs the plain PyTorch versions). ``--sharded`` runs
on a mesh of every visible CUDA device, whose shape ``--mesh`` must match;
with ``--device cpu``, ``--mesh GY GX`` places gy*gx blocks on the CPU.

Usage::

    python -m topo_descriptors_tpu_torch --dem DEM.nc --outdir out \\
        --descriptors tpi std gradient --scales 500 2000

    python -m topo_descriptors_tpu_torch --dem DEM.tif --outdir out \\
        --descriptors tpi std sx --sx-azimuths 0 90 --stream 2048

    python -m topo_descriptors_tpu_torch --synthetic 900x1440 --outdir out \\
        --descriptors tpi sx --sharded --mesh 2 2 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

logger = logging.getLogger(__name__)

ALL_DESCRIPTORS = ("dem", "tpi", "std", "gradient", "valley", "ridge", "sx")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="topo_descriptors_tpu_torch",
        description="Multi-scale terrain descriptors on PyTorch (CUDA kernels on the GPU)",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--dem", type=Path, help="input DEM (NetCDF or GeoTIFF)")
    src.add_argument("--synthetic", metavar="NYxNX",
                     help="use a synthetic fractal DEM of the given shape (benchmarks)")
    p.add_argument("--outdir", type=Path, default=Path("."))
    p.add_argument("--descriptors", nargs="+", choices=ALL_DESCRIPTORS,
                   default=["tpi", "std", "gradient"])
    p.add_argument("--scales", nargs="+", type=float,
                   default=[100, 300, 500, 1000, 2000, 4000, 6000, 10000],
                   help="scales in meters (reference script defaults, truncated)")
    p.add_argument("--smth-factors", nargs="+", type=float, default=None)
    p.add_argument("--sig-ratios", nargs="+", type=float, default=[1.0])
    p.add_argument("--flat-list", nargs="+", type=float, default=[0, 0.15, 0.3])
    p.add_argument("--sx-azimuths", nargs="+", type=float, default=[0.0])
    p.add_argument("--sx-radius", type=float, default=500.0)
    p.add_argument("--sx-height", type=float, default=10.0)
    p.add_argument("--crop-x", nargs=2, type=float, default=None)
    p.add_argument("--crop-y", nargs=2, type=float, default=None)
    p.add_argument("--skip-existing", action="store_true",
                   help="skip (descriptor, scale) outputs already present in --outdir")
    p.add_argument("--sharded", action="store_true",
                   help="run over all visible devices on a 2-D spatial mesh (with --device "
                   "cpu: gy*gx blocks of --mesh on the CPU)")
    p.add_argument("--tiled", type=int, metavar="ROWS",
                   help="stream the DEM out-of-core in row bands of this height")
    p.add_argument("--stream", type=int, metavar="ROWS",
                   help="fully out-of-core: windowed ingest straight from --dem (GeoTIFF "
                   "strips/tiles or NetCDF hyperslabs), banded compute, and band-streamed "
                   "NetCDF output; host memory stays at a few bands whatever the grid size "
                   "(requires --dem; --crop unsupported)")
    p.add_argument("--mesh", nargs=2, type=int, default=None, metavar=("GY", "GX"),
                   help="mesh shape for --sharded (default: CFG.mesh_shape, else near-square)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _whole_scales(scales):
    """Whole-number scales print as ints in output names (reference style)."""
    return [int(s) if float(s).is_integer() else s for s in scales]


def _sharded_ops(args):
    """The ShardedOps of ``--sharded``: a mesh of every visible CUDA device
    (``--mesh`` must match their count), or with ``--device cpu`` gy*gx
    blocks on the CPU (``--mesh``, else ``CFG.mesh_shape``, else one)."""
    from topo_descriptors_tpu_torch.config import CFG
    from topo_descriptors_tpu_torch.device import resolve_device
    from topo_descriptors_tpu_torch.parallel import ShardedOps, make_mesh

    shape = tuple(args.mesh) if args.mesh else None
    try:
        if resolve_device(args.device).type == "cpu":
            gy, gx = shape or CFG.mesh_shape or (1, 1)
            mesh = make_mesh((gy, gx), ["cpu"] * max(gy * gx, 0))
        else:
            mesh = make_mesh(shape)
    except ValueError as exc:
        raise SystemExit(f"--mesh: {exc}") from exc
    logger.info(f"mesh {mesh.shape} on {sorted(set(map(str, mesh.local_devices())))}")
    return ShardedOps(mesh)


def _main_streamed(args, sops) -> int:
    """Fully out-of-core battery: disk -> banded device compute -> disk.
    With ``--sharded``, each process reads its blocks straight onto the
    mesh and the outputs stream back in bands of ``--stream`` rows."""
    from topo_descriptors_tpu_torch import streaming

    if args.dem is None:
        raise SystemExit("--stream requires --dem (a file to read windowed)")
    if args.tiled:
        raise SystemExit("--stream already implies banded execution; drop --tiled")
    if args.crop_x or args.crop_y:
        raise SystemExit("--crop is not supported with --stream (crop the streamed "
                         "outputs afterwards)")

    scales = _whole_scales(args.scales)
    args.outdir.mkdir(parents=True, exist_ok=True)
    common = dict(outdir=args.outdir, skip_existing=args.skip_existing)
    if sops is None:
        common.update(tile_rows=args.stream, device=args.device)
    else:
        common.update(sops=sops, band_rows=args.stream)
    sig_ratios = args.sig_ratios * len(scales) if len(args.sig_ratios) == 1 else args.sig_ratios
    both = "tpi" in args.descriptors and "std" in args.descriptors

    with streaming.open_dem(args.dem) as dem:
        logger.info(f"streaming DEM {dem.shape}, crs {dem.grid.crs}, "
                    + (f"mesh ingest, bands of {args.stream} rows" if sops else
                       f"bands of {args.stream} rows on {args.device}"))
        written = []
        for name in args.descriptors:
            if name == "dem":
                fn = streaming.compute_dem_sharded if sops else streaming.compute_dem
                written += fn(dem, scales, **common)
            elif name in ("tpi", "std"):
                if both and name != "tpi":
                    continue  # written by the fused pass
                if sops:
                    written += streaming.compute_tpi_std_sharded(
                        dem, scales, kinds=("tpi", "std") if both else (name,),
                        smth_factors=args.smth_factors, **common)
                    continue
                fn = streaming.compute_tpi_std if both else (
                    streaming.compute_tpi if name == "tpi" else streaming.compute_std)
                written += fn(dem, scales, smth_factors=args.smth_factors, **common)
            elif name == "gradient":
                fn = streaming.compute_gradient_sharded if sops else streaming.compute_gradient
                written += fn(dem, scales, sig_ratios=sig_ratios, **common)
            elif name in ("valley", "ridge"):
                fn = (streaming.compute_valley_ridge_sharded if sops
                      else streaming.compute_valley_ridge)
                written += fn(dem, scales, mode=name, flat_list=args.flat_list,
                              smth_factors=args.smth_factors, **common)
            elif name == "sx":
                fn = streaming.compute_sx_sharded if sops else streaming.compute_sx
                written += fn(dem, args.sx_azimuths, args.sx_radius, height=args.sx_height,
                              **common)
    logger.info(f"wrote {len(written)} files to {args.outdir}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(levelname)s:%(name)s: %(message)s")
    if args.sharded and args.tiled:
        raise SystemExit("--sharded and --tiled are mutually exclusive")
    if args.mesh and not args.sharded:
        raise SystemExit("--mesh sets the shape of the --sharded mesh; add --sharded")

    from topo_descriptors_tpu_torch import pipeline
    from topo_descriptors_tpu_torch.device import resolve_device
    from topo_descriptors_tpu_torch.host import basodino_like_dem, fill_na, get_dem_netcdf
    from topo_descriptors_tpu_torch.parallel import TiledRunner

    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"--device {args.device}: {exc}") from exc
    sops = _sharded_ops(args) if args.sharded else None
    if args.stream:
        return _main_streamed(args, sops)

    if args.synthetic:
        ny, nx = (int(v) for v in args.synthetic.lower().split("x"))
        dem_ds = basodino_like_dem(ny=ny, nx=nx, projected=True)
    else:
        dem_ds = get_dem_netcdf(args.dem)
    ind_nans, dem_ds = fill_na(dem_ds)
    logger.info(f"DEM {dem_ds.data.shape}, crs {dem_ds.grid.crs}, "
                f"{len(ind_nans[0])} NaNs filled")

    scales = _whole_scales(args.scales)
    crop = None
    if args.crop_x or args.crop_y:
        crop = {}
        if args.crop_x:
            crop["x"] = slice(*args.crop_x)
        if args.crop_y:
            crop["y"] = slice(*args.crop_y)
    sharded = TiledRunner(tile_rows=args.tiled, device=args.device) if args.tiled else sops

    args.outdir.mkdir(parents=True, exist_ok=True)
    common = dict(crop=crop, outdir=args.outdir, sharded=sharded,
                  skip_existing=args.skip_existing, device=args.device)
    sig_ratios = args.sig_ratios * len(scales) if len(args.sig_ratios) == 1 else args.sig_ratios

    # TPI and STD share their moment fields: asked for together, they run
    # as one fused multi-scale batch
    descriptors = list(args.descriptors)
    if "tpi" in descriptors and "std" in descriptors:
        descriptors[descriptors.index("tpi")] = "tpi+std"
        descriptors.remove("std")

    written = []
    for name in descriptors:
        if name == "dem":
            written += pipeline.compute_dem(dem_ds, scales, ind_nans=ind_nans, **common)
        elif name in ("tpi+std", "tpi", "std"):
            fn = {"tpi+std": pipeline.compute_tpi_std, "tpi": pipeline.compute_tpi,
                  "std": pipeline.compute_std}[name]
            written += fn(dem_ds, scales, smth_factors=args.smth_factors, ind_nans=ind_nans,
                          **common)
        elif name == "gradient":
            written += pipeline.compute_gradient(dem_ds, scales, sig_ratios=sig_ratios,
                                                 ind_nans=ind_nans, **common)
        elif name in ("valley", "ridge"):
            written += pipeline.compute_valley_ridge(
                dem_ds, scales, mode=name, flat_list=args.flat_list,
                smth_factors=args.smth_factors, ind_nans=ind_nans, **common)
        elif name == "sx":
            sx_args = dict(height=args.sx_height, **common)
            if len(args.sx_azimuths) > 1:
                # the whole fan in one sweep (the mesh exchanges the ray
                # halo once for all azimuths, the tiled runner sends each
                # band's window to the device once)
                written += pipeline.compute_sx_sweep(dem_ds, args.sx_azimuths, args.sx_radius,
                                                     **sx_args)
            else:
                written += pipeline.compute_sx(dem_ds, args.sx_azimuths[0], args.sx_radius,
                                               **sx_args)
    logger.info(f"wrote {len(written)} files to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
