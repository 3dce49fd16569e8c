"""Example batch pipeline: every descriptor family over a list of scales.

Counterpart of ``examples/compute_topo_descriptors.py`` (the reference's
``scripts/compute_topo_descriptors.py:12-91``), call for call: ingest ->
NaN fill -> the per-family ``compute_*`` loops -> one NetCDF per output,
over the reference's twelve scales (100 m to 100 km; valley/ridge from
1 km), plus the backends the reference lacks: ``--sharded`` runs on a mesh
of every visible GPU, ``--tiled`` in out-of-core bands of 4096 rows.

Run with a DEM file:    python -m topo_descriptors_tpu_torch.examples.compute_topo_descriptors DEM.nc
Or self-contained demo: python -m topo_descriptors_tpu_torch.examples.compute_topo_descriptors --demo

The descriptors run on the GPU (``--device cuda``, the default) unless
``--device cpu`` asks for the plain PyTorch versions. Writing NetCDF needs
h5py.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Optional, Sequence

from topo_descriptors_tpu_torch import pipeline
from topo_descriptors_tpu_torch.host import basodino_like_dem, fill_na, get_dem_netcdf

logger = logging.getLogger(__name__)

# the reference's full scale list (scripts/compute_topo_descriptors.py:25-38)
SCALES_METERS = (100, 300, 500, 1000, 2000, 4000, 6000, 10000, 20000, 30000, 60000, 100000)
# the reference's Swiss LV03 target domain (scripts line 22)
LV03_DOMAIN = {"x": slice(255000, 965000), "y": slice(480000, -160000)}


def compute_batch(dem_ds, scales_meters: Sequence[float] = SCALES_METERS, device="cuda",
                  outdir=".", crop=None, sharded=None) -> List[Path]:
    """Every family of the reference's batch on ``dem_ds`` (NaNs filled
    here and reassigned in the outputs): the smoothed DEM, TPI without and
    with smoothing, the gradient, STD, valley and ridge on
    ``scales_meters[3:]``, and Sx at azimuth 0, radius 1 km. Returns the
    written files in call order; existing ones are kept."""
    ind_nans, dem_ds = fill_na(dem_ds)
    common = dict(ind_nans=ind_nans, crop=crop, sharded=sharded, skip_existing=True,
                  outdir=outdir, device=device)
    scales = list(scales_meters)
    files = pipeline.compute_dem(dem_ds, scales, **common)
    files += pipeline.compute_tpi(dem_ds, scales, smth_factors=None, **common)
    files += pipeline.compute_tpi(dem_ds, scales, smth_factors=1, **common)
    files += pipeline.compute_gradient(dem_ds, scales, sig_ratios=1, **common)
    files += pipeline.compute_std(dem_ds, scales, **common)
    files += pipeline.compute_valley_ridge(
        dem_ds, scales[3:], mode="valley", flat_list=[0, 0.2, 0.4], smth_factors=0.5, **common,
    )
    files += pipeline.compute_valley_ridge(
        dem_ds, scales[3:], mode="ridge", flat_list=[0, 0.15, 0.3], smth_factors=0.5, **common,
    )
    files += pipeline.compute_sx(dem_ds, 0, 1000, crop=crop, sharded=sharded, outdir=outdir,
                                 device=device)
    return files


def make_backend(kind: Optional[str], device="cuda"):
    """``None``, or the backend of ``--sharded`` (``ShardedOps`` on a mesh
    of every visible GPU; with ``device='cpu'`` the blocks of
    ``CFG.mesh_shape``, else one, on the CPU) or ``--tiled``
    (``TiledRunner`` of 4096-row bands)."""
    from topo_descriptors_tpu_torch.config import CFG
    from topo_descriptors_tpu_torch.device import resolve_device
    from topo_descriptors_tpu_torch.parallel import ShardedOps, TiledRunner, make_mesh

    if kind is None:
        return None
    if kind == "tiled":
        return TiledRunner(tile_rows=4096, device=device)
    if resolve_device(device).type == "cpu":
        gy, gx = CFG.mesh_shape or (1, 1)
        return ShardedOps(make_mesh((gy, gx), ["cpu"] * (gy * gx)))
    return ShardedOps(make_mesh())


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dem", nargs="?", help="DEM NetCDF file (cropped to the LV03 domain)")
    parser.add_argument("--demo", action="store_true",
                        help="run on the synthetic Basodino-sized DEM (the default without a file)")
    backend = parser.add_mutually_exclusive_group()
    backend.add_argument("--sharded", action="store_const", const="sharded", dest="backend",
                         help="run on a mesh of every visible GPU")
    backend.add_argument("--tiled", action="store_const", const="tiled", dest="backend",
                         help="run out of core in bands of 4096 rows")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--outdir", default=".", help="where the NetCDF files go")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    logging.captureWarnings(True)
    if args.demo or args.dem is None:
        dem_ds, domain = basodino_like_dem(projected=True), None  # synthetic Basodino-size
    else:
        dem_ds, domain = get_dem_netcdf(args.dem), LV03_DOMAIN
    compute_batch(dem_ds, SCALES_METERS, args.device, args.outdir, crop=domain,
                  sharded=make_backend(args.backend, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
