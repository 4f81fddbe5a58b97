"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` into a shared library with a plain C
interface at first use (never at import), and loaded with ``ctypes``.  The
library lands in ``ptq4vit_tpu_torch/_build/`` (git-ignored), named by a
hash of its source and flags, so an edited source rebuilds and a rebuilt
checkout reuses nothing stale.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every C entry point (pointers and the stream as c_void_p, so
# ctypes never narrows them to 32 bits)
_SIGNATURES = {
    "ptq_num_tiles": [_I, _I],
    "ptq_k_pad": [_I],
    "ptq_linear_w_sims": [_P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I,
                          _I, _I, _P, _P, _P, _P, _P, _P],
    "ptq_linear_a_sims": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I,
                          _I, _P, _P, _P, _P, _P, _P],
    "ptq_matmul_sims": [_P, _P, _P, _I, _P, _P, _F, _F, _F, _F, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
}


def nvcc_path() -> str:
    """``nvcc`` from $CUDA_HOME, the PATH, or the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.sep, "usr", "local", "cuda", "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _library_path(source: str) -> str:
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build(source: str = os.path.join(CSRC, "search_kernels.cu")):
    """Compile ``source`` if its library is missing; returns (path,
    seconds spent compiling, 0.0 when it was already built)."""
    lib = _library_path(source)
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, lib)   # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, time.time() - t0


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the search-kernel library."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
