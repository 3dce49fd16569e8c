"""Out-of-core execution on one device: :class:`TiledRunner` streams a grid
through the card in halo-overlapped row bands.

Counterpart of the single-device half of ``topo_descriptors_tpu.parallel``
(``tiles.py``). The mesh half (``mesh.py``, ``halo.py``, ``sharded.py``,
``runtime.py``) is ROADMAP item A13.
"""

from topo_descriptors_tpu_torch.parallel.tiles import LockedReader, TiledRunner

__all__ = ["LockedReader", "TiledRunner"]
