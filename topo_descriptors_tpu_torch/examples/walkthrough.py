"""Executable walkthrough: the full descriptor battery, with timings.

Counterpart of ``examples/walkthrough.py``, the runnable form of the
reference's README.ipynb (reference README.md:24-190): build a
Basodino-like ~30 m DEM, run every descriptor family through the public
API, and print the per-op timing log the reference renders in its README.

    python -m topo_descriptors_tpu_torch.examples.walkthrough
    python -m topo_descriptors_tpu_torch.examples.walkthrough --device cpu

It runs on the GPU unless ``--device cpu`` asks for the plain PyTorch
versions, and prints the torch device (and the card's name). Ingest and
output go through NetCDF, which needs h5py. See
:mod:`topo_descriptors_tpu_torch.examples.compute_topo_descriptors` for
the batch-production variant with ``--sharded`` / ``--tiled``.
"""

from __future__ import annotations

import argparse
import logging
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from topo_descriptors_tpu_torch import pipeline
from topo_descriptors_tpu_torch.device import resolve_device
from topo_descriptors_tpu_torch.host import (
    basodino_like_dem,
    fill_na,
    get_dem_netcdf,
    read_raster,
    write_raster,
)


def walkthrough(raster, scales: Sequence[float] = (200, 2000), device="cuda",
                outdir=None) -> List[Path]:
    """The tour on ``raster``: ingest through NetCDF with a low-elevation
    hole, TPI at 500 m, Sx (500 m, azimuth 0), the gradient and fused
    TPI+STD at ``scales``, the valley index at the last of them, and a
    36-azimuth Sx sweep at 500 m; prints every output file with its range
    and returns their paths."""
    dev = resolve_device(device)
    outdir = Path(tempfile.mkdtemp(prefix="topo_walkthrough_") if outdir is None else outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    card = f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""
    print(f"device: {dev}{card}")
    print(f"outputs: {outdir}")

    # --- ingest (reference README.md:33-60) --------------------------------
    data = raster.data.copy()
    data[380:384, 500:520] = -9999.0  # a low-elevation hole, masked at ingest
    dem_path = outdir / "Basodino-30m-DEM.nc"
    write_raster(raster.with_data(data), dem_path)

    dem_ds = get_dem_netcdf(dem_path)
    print(f"ingested {dem_ds.name}: shape {dem_ds.data.shape}, "
          f"NaNs {int(np.isnan(dem_ds.data).sum())}")
    ind_nans, dem_ds = fill_na(dem_ds)

    # --- TPI at 500 m (reference README.md:77-95) --------------------------
    pipeline.compute_tpi(dem_ds, [500], ind_nans=ind_nans, outdir=outdir, device=dev)

    # --- Sx, radius 500 m, azimuth 0 (reference README.md:99-123) ----------
    pipeline.compute_sx(dem_ds, 0.0, 500.0, outdir=outdir, device=dev)

    # --- the multi-scale battery (reference README.md:143-190) -------------
    scales = list(scales)
    pipeline.compute_gradient(dem_ds, scales, ind_nans=ind_nans, outdir=outdir, device=dev)
    # TPI + rolling STD for all scales in one fused batch
    pipeline.compute_tpi_std(dem_ds, scales, ind_nans=ind_nans, outdir=outdir, device=dev)
    pipeline.compute_valley_ridge(
        dem_ds, scales[-1:], mode="valley", ind_nans=ind_nans, outdir=outdir, device=dev
    )
    # a 36-azimuth Sx sweep in one kernel launch (the reference loops
    # compute_sx per azimuth from the host)
    pipeline.compute_sx_sweep(dem_ds, list(range(0, 360, 10)), 500.0, outdir=outdir, device=dev)

    print("\nwritten files:")
    paths = sorted(outdir.glob("topo_*.nc"))
    for path in paths:
        out = read_raster(path)
        print(f"  {path.name:42s} {out.name:28s} "
              f"min {np.nanmin(out.data):9.3f}  max {np.nanmax(out.data):9.3f}")
    return paths


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--outdir", default=None, help="output directory (default: a new temporary one)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s:%(name)s: %(message)s")
    walkthrough(basodino_like_dem(projected=True), device=args.device, outdir=args.outdir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
