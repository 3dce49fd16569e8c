"""The port stands apart from JAX and builds nothing when it is imported."""

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
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
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
            "topo_descriptors_tpu_torch.models.suite"} <= set(names)


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
