"""Synthetic DEM generation for tests and benchmarks.

The port's own copy of ``topo_descriptors_tpu/io/synthetic.py``:
the port imports nothing of the JAX package.

The reference benchmarks on an SRTM1 (~30 m) clip of the Basodino region,
8.2-8.6E / 46.30-46.55N, about 1440x900 pixels (reference README.md:24;
BASELINE.md). No DEM data ships with either repo, so benchmarks use a
spectrally-synthesized fractal terrain with Alpine-like statistics on the
same grid — the descriptor kernels' cost depends only on grid shape and
scale, not on the specific terrain values.
"""

from __future__ import annotations

import numpy as np

from topo_descriptors_tpu_torch.grid import Raster, RasterGrid


def synthetic_dem(
    ny: int,
    nx: int,
    seed: int = 0,
    roughness: float = 2.2,
    relief: float = 1400.0,
    base: float = 1800.0,
) -> np.ndarray:
    """Fractal terrain via spectral synthesis: 1/f^roughness amplitude noise.

    Produces smooth, realistic multi-scale relief (float32) with mean ~base
    and ~relief total vertical range.
    """
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.rfftfreq(nx)[None, :]
    freq = np.sqrt(fy * fy + fx * fx)
    freq[0, 0] = 1.0
    amp = freq ** (-roughness / 2.0)
    amp[0, 0] = 0.0
    phase = rng.uniform(0, 2 * np.pi, size=amp.shape)
    spectrum = amp * np.exp(1j * phase)
    field = np.fft.irfft2(spectrum, s=(ny, nx))
    field = field / np.abs(field).max()
    return (base + relief * field).astype(np.float32)


def basodino_like_dem(
    ny: int = 900, nx: int = 1440, seed: int = 7, projected: bool = True
) -> Raster:
    """A Basodino-benchmark-sized DEM raster (~1.3 Mpixel at ~30 m).

    ``projected=True`` uses a metric CRS with exact 30 m spacing (the
    benchmark's per-pixel work is identical; scale->pixel conversion becomes
    deterministic). ``projected=False`` builds the WGS84 SRTM-like grid with
    UTM-derived resolutions, exercising the geographic path.
    """
    data = synthetic_dem(ny, nx, seed=seed)
    if projected:
        grid = RasterGrid(
            y=(np.arange(ny, dtype=np.float64)[::-1] * 30.0 + 5_100_000.0),
            x=(np.arange(nx, dtype=np.float64) * 30.0 + 680_000.0),
            crs="epsg:32632",
        )
    else:
        step = 1.0 / 3600.0  # 1 arcsec
        grid = RasterGrid(
            y=46.55 - np.arange(ny, dtype=np.float64) * step,
            x=8.2 + np.arange(nx, dtype=np.float64) * step,
            crs="epsg:4326",
        )
    return Raster(data=data, grid=grid, name="DEM", units="m")
