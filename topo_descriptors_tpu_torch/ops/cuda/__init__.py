"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

* :mod:`.disk_sat` — ``csrc/disk_sat.cu``, replaces
  ``topo_descriptors_tpu/ops/pallas/disk_sat.py::_sat_kernel``
* :mod:`.sx_block` — ``csrc/sx_block.cu``, replaces
  ``topo_descriptors_tpu/ops/pallas/sx_block.py::_sx_kernel``
* :mod:`.sx_sweep` — ``csrc/sx_sweep.cu``, replaces ``_sx_sweep_kernel``
  and ``_sx_fan_kernel`` of the same file

Importing these modules builds nothing: the library is compiled by
:mod:`._build` the first time a CUDA tensor reaches a wrapper.
"""
