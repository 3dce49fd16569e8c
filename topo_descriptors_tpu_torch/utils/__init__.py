"""Cross-cutting utilities: timing."""

from topo_descriptors_tpu_torch.utils.timing import Timings, timer

__all__ = ["timer", "Timings"]
