"""Host-side kernel-weight library.

The port's own copy of ``topo_descriptors_tpu/kernels/__init__.py``:
the port imports nothing of the JAX package.

Every descriptor op consumes small, deterministic weight arrays (disk masks,
Gaussian taps, Sobel stencils, rotated valley/ridge banks, Sx ray geometry).
These are computed host-side in numpy — they are grid metadata, a few KB at
most — and shipped to the TPU as compile-time constants, so XLA folds them
straight into the convolution lowering.
"""

from topo_descriptors_tpu_torch.kernels.disk import circular_kernel
from topo_descriptors_tpu_torch.kernels.gaussian import gaussian_kernel1d, gaussian_radius
from topo_descriptors_tpu_torch.kernels.sobel import sobel_kernel
from topo_descriptors_tpu_torch.kernels.valley import (
    ridge_kernels,
    rotate_kernels,
    rotated_kernel_bank,
    valley_kernels,
)
from topo_descriptors_tpu_torch.kernels.sx_geometry import (
    sx_bresenhamlines,
    sx_dedupe,
    sx_distance,
    sx_offsets,
    sx_source_idx_delta,
    sx_sweep_dedupe,
    sx_sweep_offsets,
)

__all__ = [
    "circular_kernel",
    "gaussian_kernel1d",
    "gaussian_radius",
    "sobel_kernel",
    "valley_kernels",
    "ridge_kernels",
    "rotate_kernels",
    "rotated_kernel_bank",
    "sx_distance",
    "sx_source_idx_delta",
    "sx_bresenhamlines",
    "sx_offsets",
    "sx_dedupe",
    "sx_sweep_dedupe",
    "sx_sweep_offsets",
]
