"""The DEM of a configuration, made from the seed.

``spectral_terrain`` is a copy of the program's
``topo_descriptors_tpu_torch/io/synthetic.py::synthetic_dem`` (1/f^roughness
spectral synthesis), moved to PyTorch so that it runs on the device: the
phases come from a ``torch.Generator`` on that device, one call for all of
them, and the field is copied to the host once. Voids are discs of the
configuration's radii, one to a cell of a coarse grid, at places drawn from
the seed: every seed gets the same set of sizes, so the same void share.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def spectral_terrain(phase: torch.Tensor, ny: int, nx: int, roughness: float, relief: float,
                     base: float) -> torch.Tensor:
    """float32 (ny, nx) terrain from the (ny, nx // 2 + 1) spectral phases:
    amplitude ``|f|^(-roughness / 2)``, no mean term, scaled to
    ``base +- relief``."""
    kw = dict(dtype=torch.float64, device=phase.device)
    fy = torch.fft.fftfreq(ny, **kw)[:, None]
    fx = torch.fft.rfftfreq(nx, **kw)[None, :]
    freq = torch.sqrt(fy * fy + fx * fx)
    freq[0, 0] = 1.0
    amp = freq ** (-roughness / 2.0)
    amp[0, 0] = 0.0
    field = torch.fft.irfft2(torch.polar(amp, phase), s=(ny, nx))
    field = field / field.abs().max()
    return (base + relief * field).to(torch.float32)


def void_mask(ny: int, nx: int, radii, seed: int) -> np.ndarray:
    """Boolean (ny, nx) mask of one disc per radius, disc i inside cell i of
    a near-square grid of cells, its centre drawn from ``seed``."""
    radii = [int(r) for r in radii]
    mask = np.zeros((ny, nx), bool)
    if not radii:
        return mask
    rows = max(1, round(math.sqrt(len(radii) * ny / nx)))
    cols = math.ceil(len(radii) / rows)
    ch, cw = ny // rows, nx // cols
    rng = np.random.default_rng(seed)
    for i, r in enumerate(radii):
        if 2 * r + 3 > min(ch, cw):
            raise ValueError(f"a void of radius {r} does not fit a {ch}x{cw} cell")
        y0, x0 = (i // cols) * ch, (i % cols) * cw
        cy = y0 + int(rng.integers(r + 1, ch - r - 1))
        cx = x0 + int(rng.integers(r + 1, cw - r - 1))
        yy, xx = np.ogrid[-r:r + 1, -r:r + 1]
        mask[cy - r:cy + r + 1, cx - r:cx + r + 1] |= yy * yy + xx * xx <= r * r
    return mask


def make_dem(config: dict, seed: int, device) -> tuple:
    """``(dem, x, y)``: the float32 host DEM with voids as NaN, and the
    grid's x (ascending) and y (descending, north up) coordinates: metres
    from ``x0_m``/``y0_m`` at ``res_m``, or, where the grid gives
    ``step_arcsec``, degrees east and north from ``lon0_deg``/``lat0_deg``."""
    g, t = config["grid"], config["terrain"]
    ny, nx = int(g["ny"]), int(g["nx"])
    gen = torch.Generator(device=device).manual_seed(seed)
    phase = torch.rand((ny, nx // 2 + 1), generator=gen, dtype=torch.float64, device=device)
    phase *= 2 * math.pi
    dem = spectral_terrain(phase, ny, nx, t["roughness"], t["relief_m"], t["base_m"]).cpu().numpy()
    dem[void_mask(ny, nx, config["voids"]["radii_px"], seed)] = np.nan
    if "step_arcsec" in g:  # geographic: lat/lon degrees from the north-west pixel
        step = float(g["step_arcsec"]) / 3600.0
        x = g["lon0_deg"] + np.arange(nx, dtype=np.float64) * step
        y = g["lat0_deg"] - np.arange(ny, dtype=np.float64) * step
    else:
        res = float(g["res_m"])
        x = g["x0_m"] + np.arange(nx, dtype=np.float64) * res
        y = g["y0_m"] + np.arange(ny, dtype=np.float64)[::-1] * res
    return dem, x, y
