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


def tiny_load(kind: str, name: str) -> dict:
    """The cell's files with the grid, the scales and the voids cut down."""
    d = copy.deepcopy(FULL_LOAD(kind, name))
    if kind == "configs":
        d["grid"].update(TINY_GRID)
        if "scales_m" in d:
            d["scales_m"] = list(TINY_SCALES)
        d["voids"]["radii_px"] = list(TINY_VOIDS)
    return d


@pytest.fixture
def tiny(monkeypatch):
    """Make the harness load tiny cells, on one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(runner, "load", tiny_load)
    yield
    torch.set_num_threads(threads)
