"""Native (C++) data plane: JPEG decode + Pillow-bit-exact bicubic resize +
crop + normalize, bound through ctypes.

The counterpart of ``ptq4vit_tpu/native`` (the same ``preprocess.cpp``).
The library is compiled at first use with g++ against the system libjpeg
into ``ptq4vit_tpu_torch/_build/`` (git-ignored), named by a hash of the
source, the flags and the host CPU's feature flags (it is built with
``-march=native``, so a build from another CPU is never loaded).  When the
toolchain or libjpeg is missing, ``available()`` is False and the loaders
take the PIL path.  ctypes calls release the GIL, so the loader's thread
pool scales across cores.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "preprocess.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
         "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False


def _cpu_features() -> str:
    """The host CPU's feature flags (Linux), else its platform name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path() -> str:
    h = hashlib.sha1()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_cpu_features().encode())
    return os.path.join(BUILD_DIR, f"libptq4vitpp.{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    """g++ into a temporary file beside ``so``, then an atomic rename, so
    processes that build at once never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *FLAGS, _SRC, "-ljpeg", "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.pp_decode_preprocess.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, f32p, f32p,
            f32p]
        lib.pp_decode_preprocess.restype = ctypes.c_int
        lib.pp_preprocess_rgb.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p]
        lib.pp_preprocess_rgb.restype = ctypes.c_int
        lib.pp_resize.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, u8p]
        lib.pp_resize.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError("native preprocess unavailable")
    return lib


def _mean_std(mean, std):
    return (np.ascontiguousarray(mean, np.float32).reshape(3),
            np.ascontiguousarray(std, np.float32).reshape(3))


def decode_preprocess(jpeg_bytes: bytes, scale_size: int, crop: int,
                      mean, std) -> np.ndarray:
    """JPEG bytes -> normalized float32 CHW (crop x crop)."""
    lib = _lib_or_raise()
    buf = np.frombuffer(jpeg_bytes, np.uint8)
    out = np.empty((3, crop, crop), np.float32)
    m, s = _mean_std(mean, std)
    rc = lib.pp_decode_preprocess(_u8ptr(buf), buf.size, scale_size, crop,
                                  _fptr(m), _fptr(s), _fptr(out))
    if rc != 0:
        raise ValueError(f"native preprocess failed (rc={rc})")
    return out


def preprocess_rgb(rgb: np.ndarray, scale_size: int, crop: int,
                   mean, std) -> np.ndarray:
    """HWC uint8 RGB -> normalized float32 CHW (crop x crop)."""
    lib = _lib_or_raise()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((3, crop, crop), np.float32)
    m, s = _mean_std(mean, std)
    rc = lib.pp_preprocess_rgb(_u8ptr(rgb), w, h, scale_size, crop,
                               _fptr(m), _fptr(s), _fptr(out))
    if rc != 0:
        raise ValueError(f"native preprocess failed (rc={rc})")
    return out


def resize_bicubic(rgb: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Pillow-bit-exact bicubic resize of an HWC uint8 RGB image."""
    lib = _lib_or_raise()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    out = np.empty((out_h, out_w, 3), np.uint8)
    lib.pp_resize(_u8ptr(rgb), w, h, out_w, out_h, _u8ptr(out))
    return out
