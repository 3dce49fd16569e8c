"""topo_descriptors_tpu_torch — the terrain-descriptor engine on PyTorch and CUDA.

The port of :mod:`topo_descriptors_tpu` from JAX on a TPU to PyTorch on an
NVIDIA H100. The JAX package stays the reference. The port imports nothing
of it: it keeps its own copy of the host layer (``config``, ``geo``,
``grid``, ``io``, ``kernels``, ``utils.timing``), in the same layout, so
both read the same DEMs, conf files and numpy geometry tables.

* :mod:`topo_descriptors_tpu_torch.pipeline` — ``compute_*`` drivers
* :mod:`topo_descriptors_tpu_torch.ops` — tensor ops (TPI, STD, Sx, ...)
* :mod:`topo_descriptors_tpu_torch.ops.cuda` — the hand-written CUDA kernels
  (sources in ``csrc/``) beside their plain PyTorch twins
* :mod:`topo_descriptors_tpu_torch.utils.profiling` — device traces,
  throughput and the H100 roofline
* :mod:`topo_descriptors_tpu_torch.examples` — the reference's batch and
  the README walkthrough

Drivers and ops take ``device=`` (default ``"cuda"``). CUDA tensors go
through the kernels; CPU tensors through the plain twins.
"""

from topo_descriptors_tpu_torch.config import CFG, Config

__version__ = "0.1.0"
__all__ = ["CFG", "Config", "__version__"]
