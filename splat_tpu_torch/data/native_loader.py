"""ctypes bindings for the native C++ image cache (port of
`splat_tpu/data/native_loader.py`; the source is this package's own copy,
`splat_tpu_torch/native/imgcache.cpp`).

Builds the shared library on first use (g++ + system zlib; ~1 s) and caches it
under `splat_tpu_torch/native/build/`. This is a host decoder, not a device
kernel: when the toolchain, zlib, or a supported PNG subset is unavailable,
`load_images` returns None and `data.dataset` uses a Python decoder.
"""
from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_BUILD_DIR = _NATIVE_DIR / "build"
_LIB_PATH = _BUILD_DIR / "libimgcache.so"
_SRC = _NATIVE_DIR / "imgcache.cpp"

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build() -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
        str(_SRC), "-lz", "-o", str(_LIB_PATH),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.png_probe.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
            ]
            lib.png_probe.restype = ctypes.c_int
            lib.load_images_f32.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.load_images_f32.restype = ctypes.c_int
            _lib = lib
        except OSError:
            _lib_failed = True
    return _lib


def probe(path: str) -> tuple[int, int] | None:
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.png_probe(str(path).encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def load_images(paths: list[str], downscale: int = 1, n_threads: int = 0) -> np.ndarray | None:
    """Decode PNGs in parallel into (N, H/d, W/d, 3) float32, or None to
    signal the caller to use the Python fallback."""
    if not paths:
        return None
    lib = get_lib()
    if lib is None:
        return None
    dims = probe(paths[0])
    if dims is None:
        return None
    w, h = dims
    import os

    n_threads = n_threads or min(os.cpu_count() or 2, 16)
    out = np.empty((len(paths), h // downscale, w // downscale, 3), dtype=np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    rc = lib.load_images_f32(
        arr, len(paths), w, h, downscale, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        return None  # unsupported PNG subset -> fall back
    return out
