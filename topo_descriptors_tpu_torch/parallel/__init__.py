"""Parallel and out-of-core execution.

Counterpart of ``topo_descriptors_tpu.parallel``:

* :class:`TiledRunner` streams a grid through one device in
  halo-overlapped row bands (``tiles.py``);
* :class:`ShardedOps` runs every descriptor on the blocks of a (gy, gx)
  :class:`Mesh` of ``(rank, device)`` entries, with halo exchange
  (``mesh.py``, ``halo.py``, ``sharded.py``), one process or several
  (``runtime.py``).
"""

from topo_descriptors_tpu_torch.parallel import runtime
from topo_descriptors_tpu_torch.parallel.halo import exchange_halo, halo_pad_1d
from topo_descriptors_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedArray,
    make_mesh,
    pad_to_mesh,
    shard_raster,
)
from topo_descriptors_tpu_torch.parallel.sharded import ShardedOps
from topo_descriptors_tpu_torch.parallel.tiles import LockedReader, TiledRunner

__all__ = [
    "LockedReader",
    "Mesh",
    "ShardedArray",
    "ShardedOps",
    "TiledRunner",
    "exchange_halo",
    "halo_pad_1d",
    "make_mesh",
    "pad_to_mesh",
    "runtime",
    "shard_raster",
]
