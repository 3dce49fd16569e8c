"""Shared fixtures of the benchmark's tests: tiny versions of the cells,
run on the CPU through the program's plain PyTorch paths."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import run as runner

FULL_LOAD = runner.load
TINY_GRID = {"ny": 120, "nx": 160}
TINY_SCALES = [100, 300, 1000, 2000]
TINY_VOIDS = [2, 3, 4, 2]
CELLS = ("basodino_30m.batch_disk", "alps_tile_8192_30m.tpi_sx")
VALLEY_CELL = "basodino_30m.valley_bank"
# ~107 x 154 m pixels: 1 km is a 7 px kernel, 2 km 15 px
TINY_VALLEY_GRID = {"ny": 60, "nx": 80, "step_arcsec": 5.0}
TINY_VALLEY_SCALES = [1000, 2000]


def tiny_load(kind: str, name: str) -> dict:
    """The cell's files with the grid, the scales and the voids cut down."""
    d = copy.deepcopy(FULL_LOAD(kind, name))
    if kind == "configs":
        d["grid"].update(TINY_GRID)
        if "scales_m" in d:
            d["scales_m"] = list(TINY_SCALES)
        d["voids"]["radii_px"] = list(TINY_VOIDS)
    return d


def tiny_valley_load(kind: str, name: str) -> dict:
    """The valley cell's files at a coarse grid and 1-2 km."""
    d = copy.deepcopy(FULL_LOAD(kind, name))
    if kind == "configs":
        d["grid"].update(TINY_VALLEY_GRID)
        d["voids"]["radii_px"] = list(TINY_VOIDS)
    elif kind == "workloads":
        for step in d["job"]:
            step.get("args", {}).update(scales=list(TINY_VALLEY_SCALES))
    return d


@pytest.fixture
def tiny_valley(monkeypatch):
    """Make the harness load the valley cell at a coarse grid, on one
    intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(runner, "load", tiny_valley_load)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(monkeypatch):
    """Make the harness load tiny cells, on one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(runner, "load", tiny_load)
    yield
    torch.set_num_threads(threads)
