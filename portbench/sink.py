"""The drivers' output sink: planes kept in memory instead of NetCDF files.

``MemorySink.to_netcdf`` takes the place of ``pipeline.to_netcdf``, as
``chip_smoke.py::memory_writer`` does (copied from there, with the Raster
wrapper and the crop dropped: the cells crop nothing). It counts every plane
and keeps only what the check needs, so that host memory stays bounded at
any grid: every plane of the window's first job, and a sample of
``extra`` planes of the later ones, drawn from the seed (reservoir
sampling, so the sample is uniform over however many planes the window
holds).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np


class MemorySink:
    def __init__(self, extra: int, seed: int):
        self.extra = int(extra)
        self.rng = np.random.default_rng(seed)
        self.recording = False
        self.first_job = True
        self.call_id = None
        self.names: list = []  # the current call's planes, in the order written
        self.pixels = 0  # of the current call's planes
        self.kept: list = []  # (call id, name, array) of the first job
        self.sample: list = []  # (call id, name, array), the reservoir
        self.seen = 0  # planes offered to the reservoir

    def begin(self, call_id) -> None:
        self.call_id, self.names, self.pixels = call_id, [], 0

    def to_netcdf(self, array, dem, name, crop=None, outdir=".", units=None):
        name = str.upper(name)
        array = np.asarray(array)
        self.names.append(name)
        self.pixels += array.size
        if self.recording:
            item = (self.call_id, name, array)
            if self.first_job:
                self.kept.append(item)
            elif len(self.sample) < self.extra:
                self.sample.append(item)
                self.seen += 1
            else:
                j = int(self.rng.integers(0, self.seen + 1))
                self.seen += 1
                if j < self.extra:
                    self.sample[j] = item
        return Path(outdir) / f"topo_{name}.nc"

    def planes(self) -> list:
        return self.kept + self.sample

    @contextlib.contextmanager
    def installed(self, pipeline):
        saved = pipeline.to_netcdf
        pipeline.to_netcdf = self.to_netcdf
        try:
            yield self
        finally:
            pipeline.to_netcdf = saved
