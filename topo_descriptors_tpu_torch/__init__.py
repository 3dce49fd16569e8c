"""topo_descriptors_tpu_torch — the terrain-descriptor engine on PyTorch and CUDA.

The port of :mod:`topo_descriptors_tpu` from JAX on a TPU to PyTorch on an
NVIDIA H100. The JAX package stays the reference; both share its jax-free
host layer (``kernels``, ``geo``, ``grid``, ``io``, ``config``), so they
consume the same numpy geometry tables and the same DEMs.

* :mod:`topo_descriptors_tpu_torch.pipeline` — ``compute_*`` drivers
* :mod:`topo_descriptors_tpu_torch.ops` — tensor ops (TPI, STD, Sx)
* :mod:`topo_descriptors_tpu_torch.ops.cuda` — the hand-written CUDA kernels
  (sources in ``csrc/``) beside their plain PyTorch twins

Drivers and ops take ``device=`` (default ``"cuda"``). CUDA tensors go
through the kernels; CPU tensors through the plain twins.
"""

__version__ = "0.1.0"
