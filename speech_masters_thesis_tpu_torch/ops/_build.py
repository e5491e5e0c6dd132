"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own nvcc process, all
started together, and the objects are linked into one shared library with a
plain C interface, under ``build/kernels/`` at the repository root, on first
use. The library's name carries a hash of the sources, headers and flags, so
a changed source builds anew and an unchanged one loads from the cache. A
missing ``nvcc`` or a failed build raises; nothing falls back. The build
holds a file lock, so the ranks of a data-parallel run that start together
build once and the others load what it built.
"""

from __future__ import annotations

import ctypes
import fcntl
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# compile-time shape limits of csrc/gated_hifi_common.cuh and csrc/attention_common.cuh
GATED_HIFI_WIDTH = 64
GATED_HIFI_MAX_DEPTH = 8
MAX_SMEM_BYTES = 232448  # dynamic shared memory one H100 block may use
ATTENTION_HEAD_DIM = 32
# compile-time limits of csrc/enc_layer_common.cuh and csrc/enc_layer_bf16.cu
ENC_HEAD_DIM = 96
ENC_MAX_WINDOW = 8
ENC_CHANNELS = 192  # the LayerNorm epilogue's tile holds a whole row of this width
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
    for src in sorted([*_sources(), *CSRC_DIR.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"


def compile_library(lib_path: Path) -> str:
    """Runs nvcc into ``lib_path``; returns nvcc's output (ptxas register report)."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            objects.append(obj)
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports = [(src.name, proc.communicate()[0], proc.returncode)
                   for src, proc in zip(_sources(), procs)]
        failed = [f"{name} ({rc}):\n{out}" for name, out, rc in reports if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib_tmp = os.path.join(tmp, lib_path.name)
        link = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objects], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(lib_tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return "".join(out for _, out, _ in reports)


@functools.cache
def build() -> ctypes.CDLL:
    """Builds (or loads from the cache) the kernel library and binds its C API."""
    lib_path = library_path()
    if not lib_path.exists():
        find_nvcc()  # raises before anything is written
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w", encoding="utf-8") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not lib_path.exists():
                compile_library(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    ints = ctypes.POINTER(i)
    lib.gated_hifi_fwd.argtypes = [p] * 13 + [i] * 4 + [ints] * 2 + [f, u, u, f, p]
    lib.gated_hifi_fwd.restype = i
    ptrs = ctypes.POINTER(p)
    lib.gated_hifi_fwd_bf16.argtypes = [p] * 4 + [ptrs] + [p] * 7 + [i] * 4 + [ints] * 2 + [f, u, u, f, p]
    lib.gated_hifi_fwd_bf16.restype = i
    lib.gated_hifi_fwd_blocks_per_sm.argtypes = [ints]
    lib.gated_hifi_fwd_blocks_per_sm.restype = i
    lib.gated_hifi_fwd_bf16_blocks_per_sm.argtypes = [ints]
    lib.gated_hifi_fwd_bf16_blocks_per_sm.restype = i
    lib.bf16_mma_probe.argtypes = [p, p]
    lib.bf16_mma_probe.restype = i
    lib.gated_hifi_bwd.argtypes = [p] * 21 + [i] * 4 + [ints] * 2 + [f, u, u, f, p]
    lib.gated_hifi_bwd.restype = i
    lib.gated_hifi_bwd_bf16.argtypes = [p] * 24 + [i] * 4 + [ints] * 2 + [f, u, u, f, p]
    lib.gated_hifi_bwd_bf16.restype = i
    lib.gated_hifi_wgrad_partial_floats.argtypes = [i, ints, i]
    lib.gated_hifi_wgrad_partial_floats.restype = ctypes.c_long
    lib.gated_hifi_wgrad.argtypes = [p] * 10 + [i] * 4 + [ints] * 2 + [f, i, p]
    lib.gated_hifi_wgrad.restype = i
    lib.gated_hifi_wgrad_bf16.argtypes = [p] * 11 + [i] * 4 + [ints] * 2 + [f, p]
    lib.gated_hifi_wgrad_bf16.restype = i
    lib.gated_hifi_wgrad_bf16_partial_floats.argtypes = [i, i, i, ints]
    lib.gated_hifi_wgrad_bf16_partial_floats.restype = ctypes.c_long
    lib.gated_hifi_wgrad_splits.argtypes = [ctypes.c_longlong, i, ints]
    lib.gated_hifi_wgrad_splits.restype = i
    lib.gated_hifi_bwd_blocks_per_sm.argtypes = [ints]
    lib.gated_hifi_bwd_blocks_per_sm.restype = i
    lib.gated_hifi_bwd_bf16_blocks_per_sm.argtypes = [ints]
    lib.gated_hifi_bwd_bf16_blocks_per_sm.restype = i
    lib.wgmma_probe.argtypes = [p, p]
    lib.wgmma_probe.restype = i
    lib.attention_fwd.argtypes = [p] * 3 + [i] + [p] * 4 + [i] * 4 + [f, i, u, f, p]
    lib.attention_fwd.restype = i
    lib.attention_bwd.argtypes = [p] * 3 + [i] + [p] * 9 + [i] * 4 + [f, i, u, f, p]
    lib.attention_bwd.restype = i
    lib.attention_fwd_bf16.argtypes = lib.attention_fwd.argtypes
    lib.attention_fwd_bf16.restype = i
    lib.attention_bwd_bf16.argtypes = [p] * 3 + [i] + [p] * 8 + [i] * 4 + [f, i, u, f, p]
    lib.attention_bwd_bf16.restype = i
    lib.mas_forward.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.mas_forward.restype = i
    lib.mas_smem_bytes.argtypes = [i, i]
    lib.mas_smem_bytes.restype = ctypes.c_long
    lib.wn_coupling_fwd.argtypes = [p, i, p, p, p, p] + [ptrs] * 4 + [p] * 7 + [i] * 8 + [u, f, p]
    lib.wn_coupling_fwd.restype = i
    lib.wn_coupling_fwd_bf16.argtypes = [p, i, p, p, p, p] + [ptrs] * 4 + [p] * 3 + [ptrs] + [i] * 8 + [u, f, p]
    lib.wn_coupling_fwd_bf16.restype = i
    lib.wn_coupling_fwd_workspace_floats.argtypes = [i] * 8
    lib.wn_coupling_fwd_workspace_floats.restype = ctypes.c_long
    lib.wn_coupling_bwd.argtypes = ([p, i, p, p, p, p, ptrs, ptrs, p, p, ptrs, ptrs, p, p, p] + [ptrs] * 4
                                    + [p] * 10 + [i] * 8 + [u, f, p])
    lib.wn_coupling_bwd.restype = i
    lib.wn_coupling_bwd_bf16.argtypes = ([p, i, p, p, p, p, ptrs, ptrs, p, p, ptrs, ptrs, p, p, p] + [ptrs] * 4
                                         + [p, p, ptrs] + [i] * 8 + [u, f, p])
    lib.wn_coupling_bwd_bf16.restype = i
    lib.wn16_wsum_part_floats.argtypes = [i] * 9
    lib.wn16_wsum_part_floats.restype = ctypes.c_long
    lib.wn_coupling_bwd_workspace_floats.argtypes = [i] * 8
    lib.wn_coupling_bwd_workspace_floats.restype = ctypes.c_long
    lib.wn_coupling_bwd_blocks_per_sm.argtypes = [ints, ctypes.POINTER(ctypes.c_longlong)]
    lib.wn_coupling_bwd_blocks_per_sm.restype = i
    lib.flow_step_fwd.argtypes = [p] * 8 + [ptrs] * 4 + [p] * 8 + [i] * 8 + [u, f, p]
    lib.flow_step_fwd.restype = i
    lib.flow_step_fwd_bf16.argtypes = [p] * 8 + [ptrs] * 4 + [p] * 4 + [ptrs] + [i] * 8 + [u, f, p]
    lib.flow_step_fwd_bf16.restype = i
    lib.flow_step_fwd_workspace_floats.argtypes = [i] * 8
    lib.flow_step_fwd_workspace_floats.restype = ctypes.c_long
    lib.flow_step_bwd.argtypes = ([p] * 9 + [ptrs] * 2 + [p] * 2 + [ptrs] * 2 + [p] * 6 + [ptrs] * 4 + [p] * 14
                                  + [i] * 8 + [u, f, p])
    lib.flow_step_bwd.restype = i
    lib.flow_step_bwd_bf16.argtypes = ([p] * 9 + [ptrs] * 2 + [p] * 2 + [ptrs] * 2 + [p] * 6 + [ptrs] * 4 + [p] * 2
                                       + [ptrs] + [i] * 8 + [u, f, p])
    lib.flow_step_bwd_bf16.restype = i
    lib.flow_step_bwd_workspace_floats.argtypes = [i] * 8
    lib.flow_step_bwd_workspace_floats.restype = ctypes.c_long
    lib.enc_layer_fwd.argtypes = [p] * 27 + [i] * 7 + [f, u, f, p]
    lib.enc_layer_fwd.restype = i
    lib.enc_layer_fwd_bf16.argtypes = [p] * 3 + [ptrs, p, ptrs] + [i] * 7 + [f, u, f, i, p]
    lib.enc_layer_fwd_bf16.restype = i
    lib.enc_layer_fwd_workspace_floats.argtypes = [i] * 7
    lib.enc_layer_fwd_workspace_floats.restype = ctypes.c_long
    lib.enc_layer_bwd.argtypes = [p] * 4 + [ptrs, p, ptrs, ptrs, p] + [i] * 7 + [f, u, f, p]
    lib.enc_layer_bwd.restype = i
    lib.enc_layer_bwd_bf16.argtypes = [p] * 4 + [ptrs, p, ptrs, ptrs] + [i] * 7 + [f, u, f, i, p]
    lib.enc_layer_bwd_bf16.restype = i
    lib.enc16_wsum_part_floats.argtypes = [i] * 7
    lib.enc16_wsum_part_floats.restype = ctypes.c_long
    lib.enc_layer_bwd_workspace_floats.argtypes = [i] * 7
    lib.enc_layer_bwd_workspace_floats.restype = ctypes.c_long
    lib.enc_layer_bwd_blocks_per_sm.argtypes = [ints, ctypes.POINTER(ctypes.c_longlong)]
    lib.enc_layer_bwd_blocks_per_sm.restype = i
    return lib
