"""Multi-process runtime: the process group, and ingest onto the mesh.

Counterpart of ``topo_descriptors_tpu/parallel/runtime.py``. A job of
several processes (one per GPU, or one per host) joins one
``torch.distributed`` group; :func:`~.mesh.make_mesh` then gathers every
rank's devices and the :class:`~.sharded.ShardedOps` methods run
unchanged, with halos crossing processes point to point and the global
statistics summed with ``all_reduce``. Typical launch, one process per
GPU::

    torchrun --nproc-per-node 4 job.py

    from topo_descriptors_tpu_torch.parallel import ShardedOps, make_mesh, runtime

    runtime.initialize()               # env:// from torchrun's variables
    mesh = make_mesh((2, 2))           # each rank contributes cuda:{LOCAL_RANK}
    sops = ShardedOps(mesh)
    dem, valid = runtime.ingest_sharded(reader, mesh)
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from topo_descriptors_tpu_torch.device import as_field
from topo_descriptors_tpu_torch.parallel.mesh import Mesh, ShardedArray

logger = logging.getLogger(__name__)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Join the default process group (idempotent); True once joined.

    With no argument, a process that torchrun started (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` set) joins through
    ``env://``; a single process with none of them set has nothing to join
    and returns False. Otherwise pass ``init_method`` (e.g.
    ``tcp://localhost:29500``), ``world_size`` and ``rank``. The backend is
    NCCL where CUDA is available and gloo otherwise; under NCCL the
    process's device (``LOCAL_RANK``, else ``rank`` modulo the visible
    devices) is made current before the group is made. Any failure to join
    raises: unlike the JAX package, nothing is swallowed.
    """
    if dist.is_initialized():
        return True
    explicit = (init_method, world_size, rank) != (None, None, None)
    if not explicit and not any(v in os.environ for v in _ENV):
        logger.debug("single process: no process group to join")
        return False
    if not explicit and not all(v in os.environ for v in _ENV):
        missing = [v for v in _ENV if v not in os.environ]
        raise RuntimeError(f"a partial torchrun environment: {missing} unset")
    if explicit and (init_method is None or world_size is None or rank is None):
        raise ValueError("pass init_method, world_size and rank together")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        fallback = rank if explicit else int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", fallback % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if explicit:
        dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                                rank=int(rank))
    else:
        dist.init_process_group(backend, init_method="env://")
    logger.info(f"process group: rank {dist.get_rank()}/{dist.get_world_size()} over {backend}")
    return True


def ingest_sharded(reader, mesh: Mesh, fill: float = 0.0):
    """Windowed ingest straight onto the mesh: ``(ShardedArray,
    valid_shape)``.

    ``reader`` is any window reader (``.shape`` and contiguous row
    slicing, e.g. :class:`~topo_descriptors_tpu_torch.io.windowed.
    DemWindowReader`). A process reads only the mesh rows that hold one of
    its blocks, one row band at a time (the reader's x-fill needs whole
    rows), and cuts that band into its blocks, so its peak host memory is
    one band of the mesh's rows. A grid that does not divide the mesh is
    padded bottom/right with ``fill`` (the sharded ops' ``valid_shape``
    handles the rest).
    """
    h, w = reader.shape
    gy, gx = mesh.shape
    bh, bw = -(-h // gy), -(-w // gx)
    local = mesh.local_blocks()
    blocks = {}
    for i in sorted({b[0] for b in local}):
        rows = np.asarray(reader[i * bh : min((i + 1) * bh, h)], dtype=np.float32)
        if rows.shape != (bh, gx * bw):
            rows = np.pad(rows, ((0, bh - rows.shape[0]), (0, gx * bw - w)),
                          constant_values=fill)
        for b in (b for b in local if b[0] == i):
            blocks[b] = as_field(rows[:, b[1] * bw : (b[1] + 1) * bw], mesh.device(b))
        del rows
    return ShardedArray(mesh, (gy * bh, gx * bw), blocks), (h, w)


def host_local_to_global(mesh: Mesh, local_blocks: Sequence[np.ndarray]) -> ShardedArray:
    """A :class:`ShardedArray` from this process's blocks, given row-major
    (one equal-shape 2-D array per local block), without any process
    holding the whole grid."""
    local = mesh.local_blocks()
    if len(local_blocks) != len(local):
        raise ValueError(f"{len(local_blocks)} blocks for {len(local)} local devices")
    gy, gx = mesh.shape
    bh, bw = np.asarray(local_blocks[0]).shape
    blocks = {b: as_field(a, mesh.device(b)) for b, a in zip(local, local_blocks)}
    return ShardedArray(mesh, (gy * bh, gx * bw), blocks)
