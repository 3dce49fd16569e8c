"""Descriptor ops on tensors: counterparts of ``topo_descriptors_tpu.ops``.

Each op takes a DEM (numpy array or tensor) and ``device=`` (default
``"cuda"``), and returns float32 tensors on that device.
"""

from topo_descriptors_tpu_torch.ops.conv import (
    conv2d_bank_rowchan,
    conv2d_same,
    conv2d_same_batch,
    conv2d_valid,
    conv2d_valid_bank,
    convolve_reflect,
    edge_count_plane,
    gaussian_filter,
    gradient_axis,
)
from topo_descriptors_tpu_torch.ops.dem import dem
from topo_descriptors_tpu_torch.ops.gradient import gradient, sobel
from topo_descriptors_tpu_torch.ops.multiscale import disk_descriptors
from topo_descriptors_tpu_torch.ops.std import std
from topo_descriptors_tpu_torch.ops.sx import sx, sx_sweep
from topo_descriptors_tpu_torch.ops.tpi import tpi
from topo_descriptors_tpu_torch.ops.valley_ridge import valley_ridge, valley_ridge_streamed

__all__ = [
    "conv2d_same",
    "conv2d_same_batch",
    "conv2d_valid",
    "conv2d_valid_bank",
    "conv2d_bank_rowchan",
    "convolve_reflect",
    "edge_count_plane",
    "gaussian_filter",
    "gradient_axis",
    "dem",
    "tpi",
    "std",
    "gradient",
    "sobel",
    "valley_ridge",
    "valley_ridge_streamed",
    "sx",
    "sx_sweep",
    "disk_descriptors",
]
