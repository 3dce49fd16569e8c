"""The port stands apart from JAX, loads no h5py (the GPU machine has
none) and builds nothing when it is imported."""

import ast
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import topo_descriptors_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(topo_descriptors_tpu_torch.__file__).parent


def _submodules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT)], "topo_descriptors_tpu_torch.")
    )


def test_port_imports_without_jax():
    # a fresh interpreter: this pytest process already imported jax (conftest)
    names = ["topo_descriptors_tpu_torch"] + _submodules()
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'h5py', 'topo_descriptors_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert {"topo_descriptors_tpu_torch.pipeline",
            "topo_descriptors_tpu_torch.ops.cuda.disk_sat",
            "topo_descriptors_tpu_torch.ops.cuda.sx_block",
            "topo_descriptors_tpu_torch.ops.cuda.sx_sweep",
            "topo_descriptors_tpu_torch.ops.dem",
            "topo_descriptors_tpu_torch.ops.gradient",
            "topo_descriptors_tpu_torch.ops.dft_conv",
            "topo_descriptors_tpu_torch.ops.spline_rotate",
            "topo_descriptors_tpu_torch.ops.valley_ridge",
            "topo_descriptors_tpu_torch.models",
            "topo_descriptors_tpu_torch.models.suite",
            "topo_descriptors_tpu_torch.parallel",
            "topo_descriptors_tpu_torch.parallel.tiles",
            "topo_descriptors_tpu_torch.streaming",
            "topo_descriptors_tpu_torch.cli",
            "topo_descriptors_tpu_torch.__main__",
            "topo_descriptors_tpu_torch.config",
            "topo_descriptors_tpu_torch.geo",
            "topo_descriptors_tpu_torch.grid",
            "topo_descriptors_tpu_torch.io.geotiff",
            "topo_descriptors_tpu_torch.io.netcdf",
            "topo_descriptors_tpu_torch.io.synthetic",
            "topo_descriptors_tpu_torch.io.windowed",
            "topo_descriptors_tpu_torch.kernels.disk",
            "topo_descriptors_tpu_torch.kernels.gaussian",
            "topo_descriptors_tpu_torch.kernels.sobel",
            "topo_descriptors_tpu_torch.kernels.sx_geometry",
            "topo_descriptors_tpu_torch.kernels.valley",
            "topo_descriptors_tpu_torch.utils.timing"} <= set(names)


def _imported_packages(path):
    """Top-level package of every ``import`` and ``from ... import`` in
    ``path``, at any depth (function-local imports included)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("scope", ["package", "chip_smoke"])
def test_no_import_of_the_jax_package(scope):
    """The port keeps its own host layer: no module of the port and no line
    of chip_smoke.py imports ``topo_descriptors_tpu`` or jax."""
    paths = sorted(PORT.rglob("*.py")) if scope == "package" else [ROOT / "chip_smoke.py"]
    bad = [f"{path.relative_to(ROOT)}:{line} imports {name}"
           for path in paths for name, line in _imported_packages(path)
           if name in ("topo_descriptors_tpu", "jax", "jaxlib")]
    assert paths and not bad, bad


def test_no_port_file_imports_jax():
    for path in PORT.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] == ["import"] and words[1].startswith("jax")), path
            assert not (words[:1] == ["from"] and words[1].split(".")[0] == "jax"), path


def test_kernel_sources_ship_with_the_package():
    from topo_descriptors_tpu_torch.ops.cuda import _build

    names = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert {"disk_sat.cu", "sx_block.cu", "sx_sweep.cu"} <= set(names)
    assert (_build.CSRC / "sx_rays.cuh").exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-shared" in _build.LINK_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS + _build.LINK_FLAGS
    # the library name follows the sources
    assert _build.library_path().name.startswith("libtopo_kernels_")


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    from topo_descriptors_tpu_torch.ops.cuda import _build

    for src in _build.CSRC.iterdir():
        shutil.copy(src, tmp_path)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "sx_rays.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build.library_path() != before


@pytest.mark.cuda
def test_kernels_build_and_load():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels build only there")
    from topo_descriptors_tpu_torch.ops.cuda import _build

    lib = _build.library()
    assert _build.library_path().exists()
    assert lib.kernels_error_string(0).decode()
