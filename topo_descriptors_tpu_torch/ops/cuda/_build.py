"""Build the port's CUDA kernels at first use and bind them through ctypes.

Every ``csrc/*.cu`` file of the package is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source and all at once, and the objects are
linked into one shared library with a plain C interface. The library
is named by a hash of its sources, headers (``csrc/*.cuh``) and flags, so
an edit rebuilds it, and it
lives in ``build/kernels/`` beside the package (listed in ``.gitignore``;
``TOPO_TORCH_BUILD_DIR`` moves it). There is deliberately no
``--use_fast_math``: the kernels rely on IEEE NaN/inf behaviour in
``fmaxf``, ``0 * inf`` and ``atanf``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel: build_log
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# the most dynamic shared memory one block may use on sm_90 (227 KB); the
# tiled kernels' wrappers route by it
SMEM_PER_BLOCK = 232_448

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, p, out, table, n_groups, n_fields, h, w, ly, lx, hp, wq, h_out,
    # w_out, stream
    "disk_sat_forward": (_P, _P, _P, _P) + (_I,) * 10 + (_P,),
    # x, carry, out, table, n_groups, table_len, n_fields, h, w, ly, lx, hp,
    # wq, kh, kw, h_out, w_out, smem_bytes, stream
    "disk_sat_fused_forward": (_P, _P, _P, _P) + (_I,) * 14 + (_P,),
    # dem, offsets, group_ptr, inv, n_groups, out, h, w, border, height,
    # zero_border, stream
    "sx_block_forward": (_P, _P, _P, _P, _I, _P, _I, _I, _I,
                         ctypes.c_float, _I, _P),
    # dem, offsets, group_ptr, inv, n_rays, n_groups, out, h, w, oy0, ox0,
    # sh, sw, border, height, zero_border, smem_bytes, vec, stream
    "sx_block_tile_forward": (_P, _P, _P, _P, _I, _I, _P) + (_I,) * 7
                             + (ctypes.c_float, _I, _I, _I, _P),
    # dem, offsets, group_ptr, inv, az_ptr, n_az, out, h, w, border, height,
    # zero_border, stream
    "sx_sweep_forward": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                         ctypes.c_float, _I, _P),
    "sx_fan_forward": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                       ctypes.c_float, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any
build_log = ""  # what nvcc printed in that build (ptxas resource usage)


def build_dir() -> Path:
    return Path(
        os.environ.get("TOPO_TORCH_BUILD_DIR", _PACKAGE.parent / "build" / "kernels")
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "topo_descriptors_tpu_torch cannot be built"
    )


def _sources():
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return build_dir() / f"libtopo_kernels_{digest.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    global build_seconds, build_log
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objects = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(_sources(), objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        failed, log = [], []
        try:
            for cmd, proc in zip(cmds, procs):
                out, _ = proc.communicate()
                log.append(out)
                if proc.returncode != 0:
                    failed.append(f"{' '.join(cmd)} ({proc.returncode})\n{out}")
        finally:
            for proc in procs:  # only after an interrupt: stop what still runs
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        library = Path(tmp) / target.name
        cmd = [nvcc, *LINK_FLAGS, "-o", str(library), *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(library, target)  # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - start
    build_log = "".join(log)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = (ctypes.c_int,)
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise when a kernel's C entry point reported a CUDA error."""
    if err:
        text = library().kernels_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({text})")
