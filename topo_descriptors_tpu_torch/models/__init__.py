"""Descriptor-suite models: several descriptors in one module call."""

from topo_descriptors_tpu_torch.models.suite import SuiteConfig, TerrainSuite

__all__ = ["SuiteConfig", "TerrainSuite"]
