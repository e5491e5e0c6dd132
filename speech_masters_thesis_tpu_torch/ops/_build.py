"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Every ``csrc/*.cu`` goes into one shared library with a plain C interface,
compiled for ``sm_90a`` into ``build/kernels/`` at the repository root on
first use. The library's name carries a hash of the sources and flags, so a
changed source builds anew and an unchanged one loads from the cache. A
missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# compile-time shape limits of csrc/gated_hifi_fwd.cu
GATED_HIFI_WIDTH = 64
GATED_HIFI_MAX_DEPTH = 8
MAX_SMEM_BYTES = 232448  # dynamic shared memory one H100 block may use
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default install


def find_nvcc() -> str:
    """Path of nvcc: on PATH, under $CUDA_HOME, or in the default toolkit."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(DEFAULT_NVCC)
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        f"nvcc not found (looked on PATH, in $CUDA_HOME/bin and at {DEFAULT_NVCC}): "
        "the port's CUDA kernels need the CUDA toolkit to build")


def _sources() -> list[Path]:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"


def compile_library(lib_path: Path) -> str:
    """Runs nvcc into ``lib_path``; returns nvcc's output (ptxas register report)."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return proc.stdout + proc.stderr


@functools.cache
def build() -> ctypes.CDLL:
    """Builds (or loads from the cache) the kernel library and binds its C API."""
    lib_path = library_path()
    if not lib_path.exists():
        compile_library(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gated_hifi_fwd.argtypes = [p] * 11 + [i] * 4 + [ctypes.POINTER(i)] * 2 + [ctypes.c_float, p]
    lib.gated_hifi_fwd.restype = i
    lib.gated_hifi_fwd_smem_bytes.argtypes = [i]
    lib.gated_hifi_fwd_smem_bytes.restype = ctypes.c_long
    return lib
