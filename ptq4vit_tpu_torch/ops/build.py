"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source (``search_kernels.cu``: the calibration scorers;
``serve_kernels.cu``: the fused serving kernels) is compiled with ``nvcc``
into a shared library with a plain C interface at first use (never at
import), and loaded with ``ctypes``.  Both include ``hopper.cuh``, the
Hopper building blocks they share (mbarriers, TMA, wgmma).  The libraries
land in ``ptq4vit_tpu_torch/_build/`` (git-ignored), named by a hash of
their source, the shared headers and the flags, so an edited source or
header rebuilds and a rebuilt checkout reuses nothing stale.  ``build_all``
starts one ``nvcc`` per source, all at once.
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
LINK_FLAGS = ["-ldl"]     # dlopen of libcuda for its tensor-map encoder

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# argtypes of every C entry point, by library (pointers and the stream as
# c_void_p, so ctypes never narrows them to 32 bits)
_SEARCH = {
    "ptq_k_pad": [_I],
    "ptq_linear_num_partials": [_I, _I],
    "ptq_linear_smem_bytes": [_I] * 6,
    "ptq_linear_w_sims": [_P, _P, _P, _P, _P, _P, _F, _F] + [_I] * 10
                         + [_P] * 6,
    "ptq_linear_a_sims": [_P, _P, _P, _P, _P, _P, _F] + [_I] * 9 + [_P] * 6,
    "ptq_mm_width": [_I],
    "ptq_mm_num_partials": [_I] * 3,
    "ptq_mm_smem_bytes": [_I] * 4,
    "ptq_matmul_sims": [_P, _P, _P, _I, _P, _P] + [_F] * 4 + [_I] * 10
                       + [_P] * 6,
    "ptq_fp32_num_partials": [_I, _I],
    "ptq_fp32_smem_bytes": [_I, _I],
    "ptq_linear_w_sims_f32": [_P] * 5 + [_I] * 8 + [_P] * 4,
    "ptq_linear_a_sims_f32": [_P] * 5 + [_F] + [_I] * 8 + [_P] * 5,
}
_SERVE = {
    "ptq_attn_plan": [_I, _I, _P],
    "ptq_q8_smem_bytes": [_I] * 3,
    "ptq_q8_linear": [_P, _I, _P, _I] + [_P] * 7 + [_I, _P, _F, _P]
                     + [_I] * 13 + [_P],
    "ptq_fused_attention": [_P, _P, _P, _I, _L, _L, _L, _P, _I, _L, _L, _L,
                            _P, _P, _F] + [_I] * 11 + [_P],
    "ptq_window_attention": [_P, _P, _P, _I, _L, _L, _L, _P, _I, _L, _L, _L,
                             _P, _P, _F, _P, _I] + [_I] * 11 + [_P],
    "ptq_q8_win_qkv": [_P, _I, _P, _I] + [_P] * 7 + [_F, _P] + [_I] * 11
                      + [_P],
    "ptq_q8_win_proj": [_P, _P, _I] + [_P] * 4 + [_I, _P, _P] + [_I] * 10
                       + [_P],
    "ptq_q8_epilogue": [_P, _I] + [_P] * 4 + [_I, _P] + [_I] * 5 + [_P],
    "ptq_q8_postnorm": [_P, _I] + [_P] * 6 + [_I, _P, _F] + [_I] * 4
                       + [_P],
}
LIBRARIES = {"search_kernels": _SEARCH, "serve_kernels": _SERVE}


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


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


def headers() -> list:
    """The shared headers under ``csrc/`` every library includes."""
    return sorted(os.path.join(CSRC, n) for n in os.listdir(CSRC)
                  if n.endswith(".cuh"))


def _library_path(source: str) -> str:
    h = hashlib.sha256()
    for path in [source] + headers():
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _start(source: str):
    """Start ``nvcc`` on ``source`` into a temporary file; returns (lib
    path, temporary path, process), or None when the library is built."""
    lib = _library_path(source)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, source,
                             *LINK_FLAGS],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return lib, tmp, proc


def _finish(source: str, started) -> None:
    lib, tmp, proc = started
    try:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{err}")
        os.replace(tmp, lib)   # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_all(names=tuple(LIBRARIES)):
    """Compile every missing library of ``names``, one ``nvcc`` per source
    started together; returns ({name: library path}, seconds spent)."""
    t0 = time.time()
    started = {n: _start(source_path(n)) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(source_path(n), s)
    return ({n: _library_path(source_path(n)) for n in names},
            time.time() - t0)


@functools.lru_cache(maxsize=None)
def load(name: str = "search_kernels") -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    paths, _ = build_all((name,))
    lib = ctypes.CDLL(paths[name])
    for fn_name, argtypes in LIBRARIES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
