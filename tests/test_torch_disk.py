"""``kernels.Disk``, the disk described by its diameter, on the CPU.

Its runs, tap count and shape against the dense mask of
``circular_kernel`` and the scan the ops made of it
(``ops.conv._binary_kernel_runs``); the count plane built from its runs
against the exact float64 plane and the earlier rank-1 form (a dense
indicator times a one-hot matrix, kept below as the oracle); the disk ops
against the same ops fed the dense mask; and ``ops.conv.DISK_RUNS``, which
says where each run list came from.
"""

import importlib

import numpy as np
import pytest
import torch

from topo_descriptors_tpu_torch import ops
from topo_descriptors_tpu_torch.config import CFG
from topo_descriptors_tpu_torch.kernels import disk as disk_module
from topo_descriptors_tpu_torch.kernels.disk import Disk, circular_kernel
from topo_descriptors_tpu_torch.ops import conv
from topo_descriptors_tpu_torch.ops.conv import _binary_kernel_runs, edge_count_plane_device
from topo_descriptors_tpu_torch.ops.cuda import disk_sat

# the diameters of the reference batch's twelve scales on the Basodino
# arcsecond grid, 100 m to 100 km
BATCH_SIZES = (3, 11, 19, 39, 77, 153, 229, 383, 767, 1149, 2299, 3831)
OP_MODULES = ("tpi", "std", "multiscale")


@pytest.mark.parametrize("exclude_center", [False, True])
@pytest.mark.parametrize("sizes", [range(1, 65), range(65, 129), range(129, 193),
                                   range(193, 258), BATCH_SIZES],
                         ids=["1-64", "65-128", "129-192", "193-257", "batch"])
def test_disk_is_the_mask(sizes, exclude_center):
    for size in sizes:
        mask = circular_kernel(size, exclude_center)
        disk = Disk(size, exclude_center)
        assert disk.runs == _binary_kernel_runs(mask[::-1, ::-1]), size
        assert disk.taps == int(mask.sum()) and isinstance(disk.taps, int), size
        assert disk.shape == mask.shape, size
        dense = disk.dense()
        assert dense.dtype == np.float32 and np.array_equal(dense, mask), size
        assert np.array_equal(np.asarray(disk), mask), size


def _one_hot_plane(shape, kernel, device, window=None):
    """The count plane as the rank-1 form built it from a dense {0,1} mask:
    the (H, runs) indicator of in-bounds rows times a one-hot (runs, G)
    matrix, then the same (G, W) column factor and product."""
    h, w = shape
    (r0, r1), (c0, c1) = ((0, h), (0, w)) if window is None else window
    kh, kw = kernel.shape
    ly, lx = kh - 1 - (kh - 1) // 2, kw - 1 - (kw - 1) // 2
    groups = disk_sat.group_runs(_binary_kernel_runs(kernel[::-1, ::-1]))
    rows = np.array([r for _, _, grows in groups for r in grows])
    owner = np.repeat(np.arange(len(groups)), [len(grows) for _, _, grows in groups])
    y = np.arange(r0, r1)[:, None] + rows[None, :]
    inside = ((y >= ly) & (y < ly + h)).astype(np.float32)
    rvecs = inside @ np.eye(len(groups), dtype=np.float32)[owner]
    x = np.arange(c0, c1)[None, :]
    a = np.array([g[0] for g in groups])[:, None]
    b = np.array([g[1] for g in groups])[:, None]
    cvecs = np.maximum(np.minimum(x + b + 1, lx + w) - np.maximum(x + a + 1, lx + 1) + 1, 0)
    return torch.from_numpy(rvecs).to(device) @ torch.from_numpy(cvecs.astype(np.float32))


# (diameter, exclude_center, grid, window): the 67 px disk is wider than the
# grid, as test_torch_count_plane.py's "disk67"; the windows are blocks of a
# sharded grid, as ShardedOps._counts asks for them
COUNT_CASES = {
    "disk9": (9, False, (72, 96), None),
    "disk9_no_centre": (9, True, (72, 96), None),
    "even8": (8, False, (72, 96), None),
    "even10_no_centre": (10, True, (40, 48), None),
    "disk67": (67, False, (72, 96), None),
    "disk3_quirk": (3, True, (40, 48), None),
    "disk1_no_centre": (1, True, (40, 48), None),
    "disk17_block": (17, False, (72, 96), ((36, 72), (0, 48))),
    "disk67_block": (67, True, (72, 96), ((0, 36), (48, 96))),
    "even12_ragged_block": (12, False, (70, 90), ((36, 70), (48, 90))),
}


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_count_plane_from_a_disk_is_exact(case):
    size, exclude_center, shape, window = COUNT_CASES[case]
    disk = Disk(size, exclude_center)
    mask = circular_kernel(size, exclude_center)
    plane = edge_count_plane_device(shape, disk, "cpu", window)
    exact = ops.edge_count_plane(shape, mask)
    if window is not None:
        (r0, r1), (c0, c1) = window
        exact = exact[r0:r1, c0:c1]
    assert plane.dtype == torch.float32
    np.testing.assert_array_equal(plane.numpy().astype(np.float64), exact)
    if disk.taps:  # an empty disk has no runs: the plane is zeros
        assert torch.equal(plane, _one_hot_plane(shape, mask, "cpu", window))
    assert torch.equal(plane, edge_count_plane_device(shape, mask, "cpu", window))


def _fed_the_mask(monkeypatch):
    """The disk ops as they ran on the dense mask: each convolution and
    count plane gets ``circular_kernel``'s array, the runs are scanned from
    it and the count plane is the one-hot rank-1 form."""
    for name in OP_MODULES:
        module = importlib.import_module(f"topo_descriptors_tpu_torch.ops.{name}")
        for fn in ("conv2d_same", "conv2d_same_multi"):
            if hasattr(module, fn):
                original = getattr(module, fn)
                monkeypatch.setattr(module, fn, lambda x, k, *a, _f=original, **kw:
                                    _f(x, np.asarray(k), *a, **kw))
        monkeypatch.setattr(module, "edge_count_plane_device",
                            lambda shape, k, device, window=None:
                            _one_hot_plane(shape, np.asarray(k), device, window))


OP_CASES = {
    "tpi": lambda dem: ops.tpi(dem, 25, device="cpu"),
    "tpi_small_smoothed": lambda dem: ops.tpi(dem, 5, sigma=1.125, device="cpu"),
    "std": lambda dem: ops.std(dem, 13, device="cpu"),
    "std_even_wide": lambda dem: ops.std(dem, 80, device="cpu"),
    "disk_descriptors": lambda dem: ops.disk_descriptors(dem, [3, 11, 13, 31, 67],
                                                         device="cpu"),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_disk_ops_return_what_the_mask_gave(dem_small, monkeypatch, case):
    ours = OP_CASES[case](dem_small)
    with monkeypatch.context() as m:
        _fed_the_mask(m)
        theirs = OP_CASES[case](dem_small)
    if isinstance(ours, dict):
        assert ours.keys() == theirs.keys()
        ours, theirs = [torch.stack([d[k] for k in sorted(d)]) for d in (ours, theirs)]
    assert torch.equal(ours, theirs)


# (op, diameters, run lists it takes from the diameters): each disk of at
# least sat_conv_min_taps cells takes its runs twice (the prefix-sum
# convolution and the count plane), a smaller one once (the count plane; its
# convolution takes the direct route on the mask)
COUNTER_CASES = {
    "tpi": (lambda dem: ops.tpi(dem, 25, device="cpu"), [25], 2),
    "std": (lambda dem: ops.std(dem, 67, device="cpu"), [67], 2),
    "disk_descriptors": (lambda dem, s=(5, 13, 25, 67): ops.disk_descriptors(dem, s,
                                                                            device="cpu"),
                         [5, 13, 25, 67], 7),
}


@pytest.mark.parametrize("case", list(COUNTER_CASES))
def test_disk_ops_scan_nothing_and_build_no_large_mask(dem_small, monkeypatch, case):
    call, sizes, expected = COUNTER_CASES[case]
    built = []
    original = disk_module.circular_kernel

    def recording(size, exclude_center=False):
        built.append(size)
        return original(size, exclude_center)

    monkeypatch.setattr(disk_module, "circular_kernel", recording)
    before = dict(conv.DISK_RUNS)
    call(dem_small)
    assert conv.DISK_RUNS["scanned"] == before["scanned"]
    assert conv.DISK_RUNS["closed_form"] - before["closed_form"] == expected
    assert all(s * s < CFG.sat_conv_min_taps for s in built)
    assert sorted(built) == [s for s in sizes if s * s < CFG.sat_conv_min_taps]
