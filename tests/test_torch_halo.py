"""The port's mesh layer on the CPU: halo exchange against an independent
numpy oracle, the mesh and its blocked arrays, and the conf key of the
mesh shape.

The oracle pads the whole grid with ``np.pad`` (``constant`` 0 or NaN,
``symmetric`` for scipy's 'reflect', the linear extrapolation written out
rows first) and slices each block's window out of it; the exchange only
copies, so every block must equal its window bit for bit. Meshes of
eight CPU blocks in one process: (2, 4), and (8, 1) / (1, 8), whose 8-row
and 12-column blocks make a 20-wide halo take three hops.
"""

import numpy as np
import pytest
import torch

from topo_descriptors_tpu_torch.config import Config, parse_mesh_shape
from topo_descriptors_tpu_torch.parallel import (
    Mesh,
    ShardedArray,
    exchange_halo,
    halo_pad_1d,
    make_mesh,
    pad_to_mesh,
    shard_raster,
)
from topo_descriptors_tpu_torch.parallel.mesh import _near_square_factors

H, W = 64, 96


@pytest.fixture(scope="module")
def grid():
    return np.random.default_rng(21).standard_normal((3, H, W)).astype(np.float32) * 100.0


def _linear_extrap(a, axis):
    """One row (column) of linear extrapolation on each side along ``axis``."""
    n = a.shape[axis]
    first = 2.0 * np.take(a, [0], axis) - np.take(a, [1], axis)
    last = 2.0 * np.take(a, [n - 1], axis) - np.take(a, [n - 2], axis)
    return np.concatenate([first, a, last], axis=axis)


def _oracle(g, halo_y, halo_x, fill):
    """The grid padded as the exchange fills the domain edge; (..., H, W)."""
    lead = [(0, 0)] * (g.ndim - 2)
    pads = lead + [halo_y, halo_x]
    if fill == "zero":
        return np.pad(g, pads, mode="constant", constant_values=0.0)
    if fill == "nan":
        return np.pad(g, pads, mode="constant", constant_values=np.nan)
    if fill == "reflect":
        return np.pad(g, pads, mode="symmetric")
    assert halo_y == halo_x == (1, 1)
    return _linear_extrap(_linear_extrap(g, g.ndim - 2), g.ndim - 1)


def _blocks(g, mesh):
    gy, gx = mesh.shape
    bh, bw = g.shape[-2] // gy, g.shape[-1] // gx
    return {(i, j): torch.from_numpy(np.ascontiguousarray(g[..., i * bh:(i + 1) * bh,
                                                            j * bw:(j + 1) * bw]))
            for i, j in mesh.local_blocks()}


CASES = {
    # (mesh, halo_y, halo_x, fill, stacked)
    "2x4-zero-asym": ((2, 4), (3, 5), (2, 7), "zero", False),
    "2x4-nan-stack": ((2, 4), (4, 4), (6, 6), "nan", True),
    "2x4-reflect": ((2, 4), (5, 5), (9, 9), "reflect", False),
    "2x4-linear": ((2, 4), (1, 1), (1, 1), "linear_extrap", True),
    "8x1-zero-multihop": ((8, 1), (20, 20), (2, 2), "zero", False),
    "8x1-nan-multihop-asym": ((8, 1), (17, 5), (0, 3), "nan", True),
    "8x1-reflect-multihop": ((8, 1), (20, 20), (3, 3), "reflect", False),
    "8x1-linear": ((8, 1), (1, 1), (1, 1), "linear_extrap", False),
    "1x8-zero-multihop": ((1, 8), (2, 2), (20, 20), "zero", True),
    "1x8-reflect-multihop": ((1, 8), (4, 4), (20, 20), "reflect", False),
    "1x8-nan-multihop": ((1, 8), (0, 0), (25, 13), "nan", False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_exchange_halo_matches_padded_grid(grid, case):
    shape, hy, hx, fill, stacked = CASES[case]
    g = grid if stacked else grid[0]
    mesh = make_mesh(shape, ["cpu"] * 8)
    out = exchange_halo(_blocks(g, mesh), mesh, hy, hx, fill)
    padded = _oracle(g, hy, hx, fill)
    gy, gx = shape
    bh, bw = H // gy, W // gx
    for (i, j), block in out.items():
        want = padded[..., i * bh:(i + 1) * bh + sum(hy), j * bw:(j + 1) * bw + sum(hx)]
        np.testing.assert_array_equal(block.numpy(), want, err_msg=f"block {(i, j)}")


@pytest.mark.parametrize("axis", [0, 1])
def test_halo_pad_1d_one_axis(grid, axis):
    """One axis only: the other keeps the block's own extent."""
    mesh = make_mesh((2, 4), ["cpu"] * 8)
    out = halo_pad_1d(_blocks(grid[0], mesh), mesh, axis, (6, 2), "reflect")
    hy, hx = ((6, 2), (0, 0)) if axis == 0 else ((0, 0), (6, 2))
    padded = _oracle(grid[0], hy, hx, "reflect")
    for (i, j), block in out.items():
        np.testing.assert_array_equal(
            block.numpy(), padded[i * 32:(i + 1) * 32 + sum(hy), j * 24:(j + 1) * 24 + sum(hx)])


@pytest.mark.parametrize("shape,halo,fill,match", [
    ((8, 1), (80, 80), "reflect", "reflect halo"),  # wider than the whole domain
    ((8, 1), (20, 4), "reflect", "reflect halo"),   # source beyond block + opposite halo
    ((8, 1), (9, 9), "linear_extrap", "linear_extrap"),
    ((2, 4), (2, 2), "linear_extrap", "width 1"),
    ((2, 4), (1, 1), "wrap", "unknown fill"),
], ids=["reflect-beyond-domain", "reflect-beyond-source", "linear-multihop", "linear-wide",
        "unknown-fill"])
def test_halo_refuses(grid, shape, halo, fill, match):
    mesh = make_mesh(shape, ["cpu"] * 8)
    with pytest.raises(ValueError, match=match):
        halo_pad_1d(_blocks(grid[0], mesh), mesh, 0, halo, fill)


def test_mesh_entries_and_shapes(monkeypatch):
    mesh = make_mesh((2, 4), ["cpu"] * 8)
    assert mesh.shape == (2, 4) and mesh.device((1, 3)) == torch.device("cpu")
    assert mesh.local_blocks() == [(i, j) for i in range(2) for j in range(4)]
    assert not mesh.multi_process and mesh.rank == 0
    assert make_mesh(devices=["cpu"] * 6).shape == _near_square_factors(6) == (2, 3)
    from topo_descriptors_tpu_torch import config

    monkeypatch.setattr(config.CFG, "mesh_shape", (1, 6))
    assert make_mesh(devices=["cpu"] * 6).shape == (1, 6)
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((2, 2), ["cpu"] * 6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh((1, 1))


def test_sharded_array_assembles_and_names_foreign_blocks(grid):
    g = grid[0]
    mesh = make_mesh((2, 4), ["cpu"] * 8)
    arr = shard_raster(mesh, g)
    np.testing.assert_array_equal(arr.numpy(), g)
    np.testing.assert_array_equal(arr[5:40, 10:77], g[5:40, 10:77])
    stacked = ShardedArray(mesh, (3, H, W), {b: torch.from_numpy(np.ascontiguousarray(
        grid[:, b[0] * 32:(b[0] + 1) * 32, b[1] * 24:(b[1] + 1) * 24])) for b in mesh.blocks()})
    np.testing.assert_array_equal(np.asarray(stacked[2]), grid[2])
    # the second row of blocks belongs to another process
    foreign = Mesh([(0 if k < 4 else 1, "cpu") for k in range(8)], (2, 4))
    assert foreign.local_blocks() == [(0, j) for j in range(4)] and foreign.multi_process
    part = ShardedArray(foreign, (H, W), {b: arr.blocks[b] for b in foreign.local_blocks()})
    np.testing.assert_array_equal(part[0:32, :], g[:32])
    with pytest.raises(RuntimeError, match=r"\(1, 0\)"):
        part.numpy()
    with pytest.raises(ValueError, match="divide"):
        shard_raster(mesh, g[:63])


def test_pad_to_mesh_and_conf_key(tmp_path):
    mesh = make_mesh((2, 4), ["cpu"] * 8)
    padded, hw = pad_to_mesh(np.ones((63, 97), np.float32), mesh, fill=0.0)
    assert hw == (63, 97) and padded.shape == (64, 100) and padded[63:].sum() == 0
    assert parse_mesh_shape("2x4") == parse_mesh_shape("2, 4") == parse_mesh_shape("(2 4)") == (2, 4)
    assert parse_mesh_shape("none") is None
    with pytest.raises(ValueError, match="two integers"):
        parse_mesh_shape("8")
    conf = tmp_path / "topo.conf"
    conf.write_text("mesh_shape: 4x2\n")
    assert Config.from_file(conf).mesh_shape == (4, 2) and Config().mesh_shape is None
