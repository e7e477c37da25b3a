"""ctypes bindings of the native frame loader (``native/frameio.cpp``).

Port of ``orbslam_in_practice_tpu/io/native_loader.py``: a PGM/PPM decoder
(binary and ASCII netpbm, RGB converted to grayscale) and a prefetch queue
that decodes ahead of the SLAM loop on a native thread pool.

At first use the library is built from the checkout's
``native/frameio.cpp`` with ``g++`` and ``native/Makefile``'s flags into
``orbslam_in_practice_tpu_torch/build/libframeio.so`` (gitignored); nothing
is written into ``native/`` and its prebuilt library is not loaded. A
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "frameio.cpp"
_LIB_PATH = Path(__file__).resolve().parents[1] / "build" / "libframeio.so"
# native/Makefile's CXXFLAGS and LDFLAGS
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread"]
_lock = threading.Lock()
_lib = None

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_INT_P = ctypes.POINTER(ctypes.c_int)


def build() -> Path:
    """Compile ``libframeio.so`` into the package's build directory unless
    it is newer than its source; returns its path."""
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return _LIB_PATH
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"libframeio.{os.getpid()}.{threading.get_ident()}.so")
    cmd = [os.environ.get("CXX", "g++"), *_FLAGS[:5], str(_SOURCE), "-o", str(tmp), *_FLAGS[5:]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building libframeio.so failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, _LIB_PATH)  # atomic: concurrent builders each install a whole library
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.fio_read_image.restype = ctypes.c_int
            lib.fio_read_image.argtypes = [ctypes.c_char_p, _FLOAT_P, _INT_P, _INT_P, ctypes.c_int, ctypes.c_int]
            lib.fio_open_queue.restype = ctypes.c_void_p
            lib.fio_open_queue.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.fio_next.restype = ctypes.c_int
            lib.fio_next.argtypes = [ctypes.c_void_p, _FLOAT_P, _INT_P, _INT_P, ctypes.c_int, ctypes.c_int]
            lib.fio_close.restype = None
            lib.fio_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether a C++ compiler is there to build the library."""
    return shutil.which(os.environ.get("CXX", "g++")) is not None


def read_image(path: str, max_h: int = 4096, max_w: int = 4096) -> np.ndarray | None:
    """Decode one PGM/PPM to float32 grayscale [0, 255]; None when the file
    is missing or not a netpbm image of at most max_h x max_w."""
    lib = _load()
    buf = np.empty(max_h * max_w, np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.fio_read_image(str(path).encode(), buf.ctypes.data_as(_FLOAT_P), ctypes.byref(h), ctypes.byref(w),
                            max_h, max_w)
    if rc != 0:
        return None
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


class PrefetchQueue:
    """Threaded read-ahead over an image sequence: iterating yields (index,
    image) in order."""

    def __init__(self, paths: list, prefetch: int = 8, n_threads: int = 2, max_h: int = 4096, max_w: int = 4096):
        self._lib = _load()
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._q = self._lib.fio_open_queue(arr, len(self._paths), prefetch, n_threads)
        self._max_h, self._max_w = max_h, max_w
        self._buf = np.empty(max_h * max_w, np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> tuple:
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.fio_next(self._q, self._buf.ctypes.data_as(_FLOAT_P), ctypes.byref(h), ctypes.byref(w),
                                self._max_h, self._max_w)
        if rc == -1:
            raise StopIteration
        if rc == -2:
            raise IOError("frame decode failed")
        return rc, self._buf[: h.value * w.value].reshape(h.value, w.value).copy()

    def close(self):
        if getattr(self, "_q", None):
            self._lib.fio_close(self._q)
            self._q = None

    def __del__(self):
        self.close()
