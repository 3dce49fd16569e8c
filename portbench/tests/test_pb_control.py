"""The check that decides ``correct`` fails what it must: its control (the
plain reference in TF32 in the program's place) and a run whose timed
path is broken underneath, once per fault a cell can have. Tiny grids on
the CPU; the readings at the cells' own sizes, of the control and of
each fault, come from ``python3 -m portbench.control`` on the card
(PERF.md)."""

from __future__ import annotations

import importlib
import io

import pytest
import torch

from portbench import control, faults
from portbench import run as runner
from portbench.tests.conftest import CELLS, VALLEY_CELL


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(tiny, monkeypatch, cell):
    monkeypatch.setattr(control, "load", runner.load)
    numbers = control.readings(cell, 2**31 + 3, "cpu")
    limits = runner.load("workloads", cell)["limits"]
    assert set(limits) <= set(numbers)
    assert any(v > limits[n] for n, v in numbers.items() if n in limits), numbers


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    with faults.planted(fault):
        result = runner.run(cell, 2**31 + 11, 0.2, False, "cpu", log=io.StringIO())
    assert not result["correct"]
    assert result["failed"] > 0


def test_the_valley_control_fails(tiny_valley, monkeypatch):
    monkeypatch.setattr(control, "load", runner.load)
    numbers = control.readings(VALLEY_CELL, 2**31 + 3, "cpu")
    limits = runner.load("workloads", VALLEY_CELL)["limits"]
    assert set(limits) <= set(numbers)
    assert any(v > limits[n] for n, v in numbers.items() if n in limits), numbers


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_valley_engine_is_not_correct(tiny_valley, fault):
    with faults.planted(fault):
        result = runner.run(VALLEY_CELL, 2**31 + 11, 0.2, False, "cpu", log=io.StringIO())
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_taken_out_again(tiny, fault):
    names = ("ops", "pipeline", "ops.tpi", "ops.std", "ops.multiscale")
    owners = [importlib.import_module(f"topo_descriptors_tpu_torch.{n}") for n in names]
    before = [dict(vars(m)) for m in owners]
    with faults.planted(fault):
        assert [dict(vars(m)) for m in owners] != before
    assert [dict(vars(m)) for m in owners] == before


@pytest.mark.parametrize("cell", CELLS)
def test_the_cpu_witness_reads_within_the_limits(tiny, monkeypatch, cell):
    monkeypatch.setattr(control, "load", runner.load)
    numbers = control.witness(cell, 2**31 + 5, "cpu", "cpu")
    limits = runner.load("workloads", cell)["limits"]
    assert {n: v for n, v in numbers.items() if n in limits and v > limits[n]} == {}


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_a_small_grid(tiny, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(control, "load", runner.load)
    for cell in CELLS:
        numbers = control.readings(cell, 4, "cuda")
        limits = runner.load("workloads", cell)["limits"]
        assert any(v > limits[n] for n, v in numbers.items() if n in limits), numbers
