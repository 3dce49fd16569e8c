"""Descriptor ops on tensors: counterparts of ``topo_descriptors_tpu.ops``.

Each op takes a DEM (numpy array or tensor) and ``device=`` (default
``"cuda"``), and returns float32 tensors on that device.
"""

from topo_descriptors_tpu_torch.ops.multiscale import disk_descriptors
from topo_descriptors_tpu_torch.ops.std import std
from topo_descriptors_tpu_torch.ops.sx import sx, sx_sweep
from topo_descriptors_tpu_torch.ops.tpi import tpi

__all__ = ["tpi", "std", "disk_descriptors", "sx", "sx_sweep"]
