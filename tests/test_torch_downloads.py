"""``device.to_host``: downloads into torch's pinned host pool.

A CUDA tensor comes back through a block of the caching host allocator,
viewed by the returned array; ``device.DOWNLOAD_COUNTS`` counts those
downloads and the blocks the pool had to allocate for them, apart from
``device.COPIED_BYTES``. The ``cuda``-marked tests skip off the card.
"""

import gc

import numpy as np
import pytest
import torch

from topo_descriptors_tpu_torch import device, pipeline
from topo_descriptors_tpu_torch.grid import fill_na
from topo_descriptors_tpu_torch.host import basodino_like_dem


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned pool is the card's")


def _plane(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32))


# (tensor built on the given device) for every layout a driver downloads
LAYOUTS = {
    "plane": lambda dev: _plane((90, 144)).to(dev),
    "stack": lambda dev: _plane((3, 40, 60)).to(dev),
    "transposed": lambda dev: _plane((40, 60)).to(dev).t(),
    "int16": lambda dev: torch.arange(-600, 600, dtype=torch.int16).reshape(30, 40).to(dev),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cpu_tensor_downloads_nothing(layout):
    t = LAYOUTS[layout]("cpu")
    copied, downloads = dict(device.COPIED_BYTES), dict(device.DOWNLOAD_COUNTS)
    out = device.to_host(t)
    assert device.COPIED_BYTES == copied and device.DOWNLOAD_COUNTS == downloads
    want = t.cpu().numpy()
    assert out.dtype == want.dtype and out.shape == want.shape and out.strides == want.strides
    assert np.array_equal(out, want)


def test_counters_keep_their_keys():
    # portbench's copy_gbps sums every value of COPIED_BYTES as bytes moved:
    # a count kept there would be added to them
    assert set(device.COPIED_BYTES) == {"h2d", "d2h"}
    assert set(device.DOWNLOAD_COUNTS) == {"pinned", "pinned_bytes", "pool_grew"}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cuda_download_equals_the_pageable_one(layout):
    _needs_card()
    t = LAYOUTS[layout]("cuda")
    copied, downloads = dict(device.COPIED_BYTES), dict(device.DOWNLOAD_COUNTS)
    out = device.to_host(t)
    want = t.cpu().numpy()
    assert out.dtype == want.dtype and out.shape == want.shape and out.strides == want.strides
    assert np.array_equal(out, want)
    assert out.flags.writeable
    out[(0,) * out.ndim] += 1  # the caller's own array: the tensor keeps its value
    assert np.array_equal(t.cpu().numpy(), want)
    assert device.COPIED_BYTES["d2h"] - copied["d2h"] == t.nbytes
    assert device.DOWNLOAD_COUNTS["pinned"] - downloads["pinned"] == 1
    assert device.DOWNLOAD_COUNTS["pinned_bytes"] - downloads["pinned_bytes"] == t.nbytes


@pytest.mark.cuda
def test_cuda_held_array_is_never_overwritten():
    _needs_card()
    first_t, second_t = _plane((900, 1440), 1).cuda(), _plane((900, 1440), 2).cuda()
    first = device.to_host(first_t)
    kept = first.copy()
    second = device.to_host(second_t)
    assert not np.shares_memory(first, second)
    assert np.array_equal(first, kept)
    assert np.array_equal(second, second_t.cpu().numpy())


@pytest.mark.cuda
def test_cuda_dropped_block_goes_back_to_the_pool():
    _needs_card()
    t = _plane((900, 1440), 3).cuda()
    first = device.to_host(t)
    del first
    gc.collect()
    before = dict(device.DOWNLOAD_COUNTS)
    second = device.to_host(t)
    assert device.DOWNLOAD_COUNTS["pinned"] - before["pinned"] == 1
    assert device.DOWNLOAD_COUNTS["pool_grew"] - before["pool_grew"] == 0
    assert np.array_equal(second, t.cpu().numpy())


@pytest.fixture
def in_memory(monkeypatch):
    """The drivers' NetCDF writer replaced by one that keeps the planes."""
    planes = []

    def to_netcdf(array, dem, name, crop=None, outdir=".", units=None):
        planes.append(np.asarray(array))
        return name

    monkeypatch.setattr(pipeline, "to_netcdf", to_netcdf)
    return planes


# (driver, arguments, downloads): a fused batch comes back as one stack per
# kind, every other plane on its own
DRIVERS = {
    "tpi_fused": ("compute_tpi", dict(scales=[100, 300]), 1),
    "tpi_std_fused": ("compute_tpi_std", dict(scales=[100, 300]), 2),
    "tpi_single": ("compute_tpi", dict(scales=[300], smth_factors=1), 1),
    "sx": ("compute_sx", dict(azimuth=0, radius=300), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DRIVERS))
def test_cuda_driver_downloads_each_plane_pinned(in_memory, case):
    _needs_card()
    driver, args, downloads_made = DRIVERS[case]
    dem = basodino_like_dem(200, 300, projected=False)
    data = dem.data.copy()
    data[5:8, 10:14] = np.nan
    ind_nans, dem = fill_na(dem.with_data(data))
    kwargs = dict(args, device="cuda")
    if driver != "compute_sx":
        kwargs["ind_nans"] = ind_nans
    plane = dem.data.astype(np.float32).nbytes
    copied, downloads = dict(device.COPIED_BYTES), dict(device.DOWNLOAD_COUNTS)
    files = getattr(pipeline, driver)(dem, **kwargs)
    down = device.COPIED_BYTES["d2h"] - copied["d2h"]
    assert down == len(files) * plane == len(in_memory) * plane
    assert device.DOWNLOAD_COUNTS["pinned"] - downloads["pinned"] == downloads_made
    assert device.DOWNLOAD_COUNTS["pinned_bytes"] - downloads["pinned_bytes"] == down
