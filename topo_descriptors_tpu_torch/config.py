"""Configuration for topo_descriptors_tpu_torch.

The port's own copy of ``topo_descriptors_tpu/config.py``, with the fields
the port reads and the same defaults, so that both packages route alike.
The reference loads two knobs from ``config/topo_descriptors.conf`` via
``yaconfigobject`` (reference __init__.py:15, config/topo_descriptors.conf:1-5):

* ``min_elevation = -100`` — elevations <= this are masked to NaN at ingest
  (reference helpers.py:31)
* ``scale_std = 4`` — number of Gaussian standard deviations per unit scale,
  i.e. ``sigma = scale_pxl / 4`` (reference topo.py:49,573; helpers.py:131)

The other fields are the mesh layout, the JAX package's routing thresholds
and valley/ridge memory budgets. Overrides come from a simple ``key:
value`` conf file named by ``TOPO_TPU_CONFIG`` (the variable the JAX
package reads, so one file steers both).
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Optional, Tuple


def parse_mesh_shape(value: str) -> Optional[Tuple[int, int]]:
    """``"2x4"``, ``"2, 4"`` or ``"2 4"`` -> (2, 4); ``"none"`` or ``""`` ->
    None. The JAX package keeps the conf text as a string, which its
    ``make_mesh`` cannot use."""
    if value.strip().lower() in ("", "none"):
        return None
    parts = [p for p in re.split(r"[x,\s()]+", value.strip().lower()) if p]
    if len(parts) != 2:
        raise ValueError(f"mesh_shape {value!r}: expected two integers, e.g. 2x4")
    return int(parts[0]), int(parts[1])


@dataclasses.dataclass
class Config:
    # --- reference-compatible knobs (config/topo_descriptors.conf:1-5) ---
    min_elevation: float = -100.0
    scale_std: float = 4.0

    # --- mesh, routing and memory knobs (no reference analogue) ---
    # Preferred 2-D device mesh layout (gy, gx); None = near-square.
    mesh_shape: Optional[Tuple[int, int]] = None
    # Compute dtype for descriptor math on device.
    compute_dtype: str = "float32"
    # Use FFT convolution when the kernel area exceeds this many taps.
    fft_conv_min_taps: int = 1024
    # Below this tap count, direct convs unroll into shifted multiply-adds.
    shift_acc_max_taps: int = 1024
    # 1-D correlations (separable Gaussian) switch from shifted FMAs to
    # per-axis FFT above this tap count.
    fft_correlate1d_min_taps: int = 88
    # {0,1}-valued kernels (disk stencils) of at least this many taps route
    # through the prefix-sum (summed-area) path.
    sat_conv_min_taps: int = 128
    # valley/ridge: largest precomputed rotated-kernel bank to keep on the
    # device; beyond it the angle loop streams host-rotated chunks.
    valley_bank_max_bytes: int = 192 * 1024 * 1024
    # streamed valley/ridge: target device size of one angle chunk's padded
    # kernel stack (the FFT intermediates are a small multiple of this).
    valley_chunk_bytes: int = 128 * 1024 * 1024
    # streamed valley/ridge: largest rotated+folded quadrant canvas stack to
    # keep device-resident per (size, mode, flats) signature.
    valley_canvas_cache_bytes: int = 1024 * 1024 * 1024
    # Reproduce the reference's int32-truncation quirk in the rolling std
    # (reference topo.py:300). Set False for a cleaner float32 variance.
    std_int32_parity: bool = True

    @classmethod
    def from_file(cls, path: str | os.PathLike) -> "Config":
        """Parse a minimal ``key: value`` conf file (one pair per line,
        ``#`` comments), the same shape as the reference's
        topo_descriptors.conf. Unknown keys (the JAX package's TPU-only
        fields among them) are ignored."""
        cfg = cls()
        text = Path(path).read_text()
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, _, value = line.partition(":")
            key = key.strip()
            value = value.strip()
            if not hasattr(cfg, key):
                continue
            field_type = type(getattr(cfg, key))
            if key == "mesh_shape":
                cfg.mesh_shape = parse_mesh_shape(value)
            elif field_type is bool:
                setattr(cfg, key, value.lower() in ("1", "true", "yes"))
            elif field_type in (int, float):
                setattr(cfg, key, field_type(float(value)))
            else:
                setattr(cfg, key, value)
        return cfg


def _load_default() -> Config:
    path = os.environ.get("TOPO_TPU_CONFIG")
    if path and Path(path).exists():
        return Config.from_file(path)
    default = Path(__file__).with_name("topo_descriptors_tpu.conf")
    if default.exists():
        return Config.from_file(default)
    return Config()


CFG = _load_default()
