"""The device mesh and arrays blocked over it.

Counterpart of ``topo_descriptors_tpu/parallel/mesh.py``. A JAX mesh is a
grid of devices, each owned by a process (``process_index``), and one
process may own all of them (the JAX tests run 8 virtual CPU devices in
one process). :class:`Mesh` keeps that shape: a (gy, gx) grid of
``(rank, torch.device)`` entries. A process holds the blocks of its own
entries; the halo exchange (:mod:`.halo`) copies between two blocks of one
process device to device and goes through ``torch.distributed`` between
processes. One process per GPU is the case where every rank owns one
entry; a list that repeats a device (``["cpu"] * 8``, ``["cuda:0"] * 4``)
gives one device several blocks, the counterpart of the JAX tests'
virtual devices.

:class:`ShardedArray` is the counterpart of an array with
``NamedSharding(mesh, P('gy', 'gx'))`` (or ``P(None, 'gy', 'gx')`` with a
leading dimension): the global shape and this process's blocks.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.device import as_field

Block = Tuple[int, int]


def _near_square_factors(n: int) -> Tuple[int, int]:
    """Factor n into (gy, gx) as close to square as possible."""
    best = (1, n)
    for gy in range(1, int(np.sqrt(n)) + 1):
        if n % gy == 0:
            best = (gy, n // gy)
    return best


def process_rank() -> int:
    """This process's rank in the default group, 0 outside one."""
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """A (gy, gx) grid of ``(rank, torch.device)`` entries, row-major.

    ``rank`` is the process that holds the entry's block (the rank of the
    default ``torch.distributed`` group, 0 in a single process).
    ``grouped``: the mesh was made inside a process group (of any size,
    one rank included), so its global sums go through the group's
    ``all_reduce``.
    """

    def __init__(self, entries: Sequence[Tuple[int, torch.device]], shape: Tuple[int, int]):
        gy, gx = (int(s) for s in shape)
        if gy < 1 or gx < 1 or gy * gx != len(entries):
            raise ValueError(f"mesh shape {tuple(shape)} != {len(entries)} devices")
        self.shape = (gy, gx)
        self.entries = [(int(r), torch.device(d)) for r, d in entries]
        self.rank = process_rank()
        self.grouped = dist.is_initialized()

    def entry(self, block: Block) -> Tuple[int, torch.device]:
        i, j = block
        return self.entries[i * self.shape[1] + j]

    def owner(self, block: Block) -> int:
        return self.entry(block)[0]

    def device(self, block: Block) -> torch.device:
        return self.entry(block)[1]

    def blocks(self) -> List[Block]:
        """Every block of the mesh, row-major."""
        gy, gx = self.shape
        return [(i, j) for i in range(gy) for j in range(gx)]

    def local_blocks(self) -> List[Block]:
        """This process's blocks, row-major."""
        return [b for b in self.blocks() if self.owner(b) == self.rank]

    def local_devices(self) -> List[torch.device]:
        return [self.device(b) for b in self.local_blocks()]

    @property
    def multi_process(self) -> bool:
        return any(r != self.rank for r, _ in self.entries)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, entries={self.entries})"


def _gather_entries(local: Sequence[torch.device]) -> List[Tuple[int, torch.device]]:
    """Every process's ``(rank, device)`` entries in rank order: this
    process's ``local`` devices, gathered with ``all_gather_object`` inside
    a process group."""
    mine = [(process_rank(), str(torch.device(d))) for d in local]
    if not dist.is_initialized():
        return [(r, torch.device(d)) for r, d in mine]
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, mine)
    return [(r, torch.device(d)) for part in gathered for r, d in part]


def make_mesh(shape: Optional[Tuple[int, int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A (gy, gx) :class:`Mesh`, the spatial decomposition grid.

    ``devices`` lists this process's devices and may repeat one
    (``["cpu"] * 8``). Without it a single process takes every visible CUDA
    device, and a rank of a process group contributes its
    ``cuda:{LOCAL_RANK}`` (the device :func:`~.runtime.initialize` made
    current); both raise where CUDA is missing, so pass ``devices=`` to run
    on the CPU. Inside a process group the lists of all ranks are gathered
    in rank order. The shape comes from ``shape``, then
    ``CFG.mesh_shape``, then the near-square factors of the device count.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes the visible CUDA devices, but torch.cuda.is_available() "
                "is False; pass devices=['cpu'] * n to place n blocks on the CPU"
            )
        if dist.is_initialized():
            local_rank = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
            devices = [torch.device("cuda", local_rank)]
        else:
            devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    entries = _gather_entries(list(devices))
    if shape is None:
        shape = CFG.mesh_shape or _near_square_factors(len(entries))
    return Mesh(entries, tuple(shape))


class ShardedArray:
    """A global (H, W) array, or (L, H, W) with a leading dimension that is
    not split, blocked (gy, gx) over a :class:`Mesh`.

    ``blocks`` maps this process's blocks ``(i, j)`` to tensors of shape
    ``lead + (H // gy, W // gx)`` on their entry's device. Indexing an int
    on the leading dimension gives an (H, W) array; a row and column slice
    (``arr[r0:r1, :w]``) and :meth:`numpy` assemble a host array from the
    blocks and raise, naming them, when a block they need lives in another
    process.
    """

    def __init__(self, mesh: Mesh, shape, blocks: Dict[Block, torch.Tensor]):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        gy, gx = mesh.shape
        h, w = self.shape[-2:]
        if h % gy or w % gx:
            raise ValueError(f"global shape {self.shape} must divide the mesh {mesh.shape}")
        self.block_shape = (h // gy, w // gx)
        want = self.shape[:-2] + self.block_shape
        missing = [b for b in mesh.local_blocks() if b not in blocks]
        if missing or len(blocks) != len(mesh.local_blocks()):
            raise ValueError(f"blocks {sorted(blocks)} for the local blocks {mesh.local_blocks()}")
        for b, t in blocks.items():
            if tuple(t.shape) != want or t.device != mesh.device(b):
                raise ValueError(f"block {b}: {tuple(t.shape)} on {t.device}, expected {want} "
                                 f"on {mesh.device(b)}")
        self.blocks = dict(blocks)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            if self.ndim != 3:
                raise IndexError("an int index selects a plane of a (L, H, W) array")
            idx = int(key)
            return ShardedArray(self.mesh, self.shape[1:],
                                {b: t[idx] for b, t in self.blocks.items()})
        rows, cols = key if isinstance(key, tuple) else (key, slice(None))
        return self._assemble(rows, cols)

    def _assemble(self, rows: slice, cols: slice) -> np.ndarray:
        h, w = self.shape[-2:]
        r0, r1, rs = rows.indices(h)
        c0, c1, cs = cols.indices(w)
        if rs != 1 or cs != 1:
            raise ValueError("a ShardedArray is read in contiguous row and column slices")
        bh, bw = self.block_shape
        need = [(i, j) for i in range(r0 // bh, -(-r1 // bh)) for j in range(c0 // bw, -(-c1 // bw))]
        missing = [b for b in need if b not in self.blocks]
        if missing:
            raise RuntimeError(
                f"rows {r0}:{r1}, columns {c0}:{c1} need the blocks {missing}, which live in "
                "other processes: read each process's own blocks (ShardedArray.blocks)")
        out = np.empty(self.shape[:-2] + (max(r1 - r0, 0), max(c1 - c0, 0)), np.float32)
        for i, j in need:
            y0, y1 = max(r0, i * bh), min(r1, (i + 1) * bh)
            x0, x1 = max(c0, j * bw), min(c1, (j + 1) * bw)
            part = self.blocks[(i, j)][..., y0 - i * bh : y1 - i * bh, x0 - j * bw : x1 - j * bw]
            out[..., y0 - r0 : y1 - r0, x0 - c0 : x1 - c0] = part.cpu().numpy()
        return out

    def numpy(self) -> np.ndarray:
        """The whole array on the host."""
        return self._assemble(slice(None), slice(None))

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def _check_divides(shape, mesh: Mesh) -> None:
    gy, gx = mesh.shape
    if shape[-2] % gy or shape[-1] % gx:
        raise ValueError(f"global shape {tuple(shape)} must divide mesh ({gy}, {gx}); pad with "
                         "mesh.pad_to_mesh first")


def shard_raster(mesh: Mesh, array) -> ShardedArray:
    """Slice a (possibly padded) global 2-D host array into this process's
    blocks, each on its entry's device. The shape must divide the mesh:
    use :func:`pad_to_mesh` first for arbitrary shapes."""
    array = np.asarray(array, dtype=np.float32)
    _check_divides(array.shape, mesh)
    gy, gx = mesh.shape
    bh, bw = array.shape[0] // gy, array.shape[1] // gx
    blocks = {(i, j): as_field(array[i * bh : (i + 1) * bh, j * bw : (j + 1) * bw],
                               mesh.device((i, j)))
              for i, j in mesh.local_blocks()}
    return ShardedArray(mesh, array.shape, blocks)


def pad_to_mesh(array: np.ndarray, mesh: Mesh, fill=np.nan):
    """Pad a global array on the bottom/right so each dim divides the mesh.

    Returns (padded, (orig_h, orig_w)). The fill is NaN by default so that
    stray padding is loud if it ever leaks into a result (the drivers crop
    outputs back to the original shape).
    """
    gy, gx = mesh.shape
    h, w = array.shape
    ph, pw = (-h) % gy, (-w) % gx
    if ph or pw:
        array = np.pad(array, ((0, ph), (0, pw)), mode="constant", constant_values=fill)
    return array, (h, w)
