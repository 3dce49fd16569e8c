"""Nothing of JAX in the benchmark: its sources import neither jax nor the
JAX package, its reference nothing of the program either, and a finished
run's process has none of them loaded. Names are compared by their top
level, whole: the program's name begins with the JAX package's."""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from portbench import importcheck

PORTBENCH = Path(importcheck.__file__).resolve().parent


def sources(sub=""):
    return sorted(p for p in (PORTBENCH / sub).rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_harness_imports_nothing_of_jax(path):
    assert not importcheck.imports_of(path) & importcheck.FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = importcheck.imports_of(path)
    assert not names & (importcheck.FORBIDDEN | {importcheck.PROGRAM})
    assert names <= {"__future__", "numpy", "scipy", "torch", "portbench"}


def test_top_level_names_are_compared_whole():
    found = importcheck.forbidden_loaded(["topo_descriptors_tpu_torch", "topo_descriptors_tpu_torch.ops",
                                          "jaxtyping", "flaxen.x", "topo_descriptors_tpu.ops",
                                          "jax.numpy", "jaxlib", "flax"])
    assert found == ["flax", "jax.numpy", "jaxlib", "topo_descriptors_tpu.ops"]


def test_a_finished_run_loaded_nothing_of_jax():
    code = textwrap.dedent("""
        import sys, torch
        torch.set_num_threads(1)
        from portbench import importcheck, run
        from portbench.tests.conftest import tiny_load
        run.load = tiny_load
        result = run.run("alps_tile_8192_30m.tpi_sx", 9, 0.1, False, "cpu")
        assert result["correct"], result
        assert any(n.startswith("topo_descriptors_tpu_torch") for n in sys.modules)
        print(importcheck.forbidden_loaded(sys.modules))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=PORTBENCH.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
