"""Halo exchange over a :class:`~.mesh.Mesh`.

Counterpart of ``topo_descriptors_tpu/parallel/halo.py``. Each stencil op
needs a rim of neighbour data around its block: the kernel's 'same'
anchor for disk and valley/ridge convolutions, ``int(4*sigma+0.5)`` for
the Gaussian, one row for ``np.gradient``, the ray border for Sx. A halo
wider than a block gathers from neighbours of neighbours (multi-hop):
chunk k comes from the block k steps away. At the true domain edge a block
takes the fill instead, never a wrapped block:

* ``'zero'`` — ``scipy.signal.convolve`` 'same' zero boundary (TPI, STD,
  valley/ridge);
* ``'nan'`` — Sx (the border is zeroed afterwards);
* ``'reflect'`` — ``scipy.ndimage`` 'reflect' (Gaussian, Sobel);
* ``'linear_extrap'`` — one row of linear extrapolation; central
  differences over it give ``np.gradient``'s one-sided edge formula.

The functions take and return ``{(i, j): tensor}`` dicts of this process's
blocks; ``axis`` is the mesh axis (0: rows, gy; 1: columns, gx) and ``dim``
the tensor dimension it splits (default -2 and -1).

How a chunk moves: between two blocks of one process it is a
``.to(dst.device, non_blocking=True)`` (a slice copy on one device, a peer
copy between two GPUs, never through the host). Between processes the
chunks of one exchange go in one ``dist.batch_isend_irecv``, every rank
listing its sends and receives in the same global order (rows of the mesh
in order, hop by hop, the low side first), so the pairs match. The
transport follows ``dist.get_backend()``, a fixed rule: under NCCL the
tensors travel as they are; under gloo, whose send and recv take CPU
tensors only, a CUDA chunk is copied into a pinned host buffer and the
received chunk copied back to its device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch
import torch.distributed as dist

from topo_descriptors_tpu_torch.parallel.mesh import Block, Mesh

HaloSpec = Union[int, Tuple[int, int]]
Blocks = Dict[Block, torch.Tensor]
FILLS = ("zero", "nan", "reflect", "linear_extrap")


def _norm_halo(h: HaloSpec) -> Tuple[int, int]:
    if isinstance(h, tuple):
        return int(h[0]), int(h[1])
    return int(h), int(h)


def _edge_fill(x: torch.Tensor, dim: int, size: int, side: str, fill: str) -> torch.Tensor:
    """The fill chunk of ``size`` rows or columns at the true domain edge."""
    if fill in ("zero", "nan"):
        shape = list(x.shape)
        shape[dim] = size
        return torch.full(shape, 0.0 if fill == "zero" else float("nan"), dtype=x.dtype,
                          device=x.device)
    n = x.shape[dim]
    if fill == "reflect":  # symmetric about the edge: d c b a | a b c d
        start = 0 if side == "lo" else n - size
        return torch.flip(x.narrow(dim, start, size), dims=(dim,))
    if fill == "linear_extrap":
        if size != 1:
            raise ValueError("linear_extrap fill supports halo width 1 only")
        if side == "lo":
            return 2.0 * x.narrow(dim, 0, 1) - x.narrow(dim, 1, 1)
        return 2.0 * x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    raise ValueError(f"unknown fill {fill!r}: expected one of {FILLS}")


def global_index(index: int, local_len: int, device) -> torch.Tensor:
    """Global index of each element of a block along one axis: the block
    is ``index`` blocks from the start, each ``local_len`` long."""
    return index * local_len + torch.arange(local_len, device=device)


def _reflect_oob(ext: torch.Tensor, dim: int, lo: int, index: int, n: int,
                 total: int) -> torch.Tensor:
    """Overwrite the out-of-domain positions of a halo-extended block with
    the symmetric reflection of the in-domain data.

    ``ext`` was extended by a zero-fill exchange, so every position whose
    global index lies in ``[0, total)`` holds true data. The reflection
    source of global row ``g`` is ``-1-g`` (top) or ``2*total-1-g``
    (bottom), scipy.ndimage's 'reflect', and the caller's limits keep that
    source inside ``ext``; interior blocks gather the identity."""
    base = index * n - lo
    g = base + torch.arange(ext.shape[dim], device=ext.device)
    r = torch.where(g < 0, -1 - g, torch.where(g >= total, 2 * total - 1 - g, g))
    return ext.index_select(dim, r - base)


def _send_buffer(chunk: torch.Tensor, gloo: bool) -> torch.Tensor:
    if gloo and chunk.is_cuda:
        buf = torch.empty(chunk.shape, dtype=chunk.dtype, pin_memory=True)
        return buf.copy_(chunk)
    return chunk.contiguous()


def _recv_buffer(shape, dtype, device: torch.device, gloo: bool) -> torch.Tensor:
    if gloo:
        return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")
    return torch.empty(shape, dtype=dtype, device=device)


def _move(blocks: Blocks, mesh: Mesh, transfers: List[tuple]) -> Dict[int, torch.Tensor]:
    """Carry out ``transfers`` = ``[(src block, dst block, dim, start,
    size), ...]``, the same list on every rank: chunk ``t`` is ``size``
    rows of ``src`` along ``dim`` from ``start``, delivered on ``dst``'s
    device. Returns ``{t: chunk}`` for this process's destinations."""
    got: Dict[int, torch.Tensor] = {}
    ops, pending = [], []
    gloo = mesh.multi_process and dist.get_backend() == "gloo"
    for t, (src, dst, dim, start, size) in enumerate(transfers):
        mine_src, mine_dst = mesh.owner(src) == mesh.rank, mesh.owner(dst) == mesh.rank
        if mine_src and mine_dst:
            got[t] = blocks[src].narrow(dim, start, size).to(mesh.device(dst), non_blocking=True)
        elif mine_src:
            chunk = _send_buffer(blocks[src].narrow(dim, start, size), gloo)
            ops.append(dist.P2POp(dist.isend, chunk, mesh.owner(dst), tag=t))
        elif mine_dst:
            like = blocks[dst]
            shape = list(like.shape)
            shape[dim] = size
            buf = _recv_buffer(shape, like.dtype, like.device, gloo)
            ops.append(dist.P2POp(dist.irecv, buf, mesh.owner(src), tag=t))
            pending.append((t, buf, like.device))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for t, buf, device in pending:
            got[t] = buf.to(device, non_blocking=True)
    return got


def halo_pad_1d(blocks: Blocks, mesh: Mesh, axis: int, halo: HaloSpec, fill: str = "zero",
                dim: int = None) -> Blocks:
    """Extend every block along mesh ``axis`` by (lo, hi) halo rows.

    Multi-hop: a halo wider than the block gathers from neighbours of
    neighbours. ``reflect`` also serves halos wider than a block (a large
    Gaussian on a fine mesh): a zero-fill exchange first, then the
    out-of-domain positions reflect the gathered in-domain data
    (:func:`_reflect_oob`); the source must fit in the block and its
    opposite halo, ``lo <= n + hi``. ``linear_extrap`` is one row by
    contract.
    """
    if fill not in FILLS:
        raise ValueError(f"unknown fill {fill!r}: expected one of {FILLS}")
    dim = axis - 2 if dim is None else dim
    lo, hi = _norm_halo(halo)
    axis_size = mesh.shape[axis]
    n = next(iter(blocks.values())).shape[dim] if blocks else 0
    name = ("gy", "gx")[axis]
    if (lo > n or hi > n) and fill == "linear_extrap":
        raise ValueError(f"{fill} fill needs halo <= block ({(lo, hi)} vs {n})")
    if (lo > n or hi > n) and fill == "reflect":
        total = axis_size * n
        if lo > n + hi or hi > n + lo or lo >= total or hi >= total:
            raise ValueError(
                f"reflect halo {(lo, hi)} too wide for mesh axis {name} (block {n}, domain "
                f"{total}): the reflection source must fit in block + opposite halo; use fewer "
                "devices along this axis or the tiled runner")
        ext = halo_pad_1d(blocks, mesh, axis, (lo, hi), "zero", dim)
        return {b: _reflect_oob(t, dim, lo, b[axis], n, total) for b, t in ext.items()}
    if lo == 0 and hi == 0:
        return dict(blocks)

    # every chunk of every block, in one order on every rank
    chunks = []  # (dst, side, k, c, src or None)
    transfers = []
    for side, width in (("lo", lo), ("hi", hi)):
        k, remaining = 1, width
        while remaining > 0:
            c = min(n, remaining)
            for dst in mesh.blocks():
                idx = dst[axis]
                src_idx = idx - k if side == "lo" else idx + k
                src = None
                if 0 <= src_idx < axis_size:
                    src = (src_idx, dst[1]) if axis == 0 else (dst[0], src_idx)
                    start = n - c if side == "lo" else 0  # the tail above, the head below
                    transfers.append((src, dst, dim, start, c))
                chunks.append((dst, side, c, len(transfers) - 1 if src else None))
            remaining -= c
            k += 1
    got = _move(blocks, mesh, transfers)

    out = {}
    for b, x in blocks.items():
        lo_parts, hi_parts = [], []
        for dst, side, c, t in chunks:
            if dst != b:
                continue
            part = _edge_fill(x, dim, c, side, fill) if t is None else got[t]
            if side == "lo":
                lo_parts.insert(0, part)
            else:
                hi_parts.append(part)
        out[b] = torch.cat(lo_parts + [x] + hi_parts, dim=dim)
    return out


def exchange_halo(blocks: Blocks, mesh: Mesh, halo_y: HaloSpec, halo_x: HaloSpec,
                  fill: str = "zero", y_dim: int = -2, x_dim: int = -1) -> Blocks:
    """2-D halo exchange: rows first, then columns over the row-extended
    blocks, so corner regions carry true diagonal-neighbour data."""
    blocks = halo_pad_1d(blocks, mesh, 0, halo_y, fill, y_dim)
    return halo_pad_1d(blocks, mesh, 1, halo_x, fill, x_dim)
