"""ctypes bindings of ``framepump.cpp``: libjpeg encode/decode and a frame ring.

Port of ``live2diff_tpu/serve/framepump.py``, with the same API. The
library is built with ``g++`` at first use into ``build/framepump/`` at the
repository root, named by a hash of the source and the flags (as
``ops/_build.py`` names the kernels), so an edited source is rebuilt and an
unchanged one reused. Where ``g++`` or the libjpeg headers are missing,
``available()`` is False, ``encode_jpeg``/``decode_jpeg`` return None and
callers encode with Pillow. This is host-side JPEG only: nothing here runs
on the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "framepump.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "framepump")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_failed = False
_build_lock = threading.Lock()


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libframepump-{h.hexdigest()[:12]}.so")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fp_encode_jpeg.restype = ctypes.c_long
    lib.fp_encode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.fp_decode_jpeg.restype = ctypes.c_long
    lib.fp_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.fp_free.argtypes = [ctypes.c_void_p]
    lib.fp_ring_create.restype = ctypes.c_void_p
    lib.fp_ring_create.argtypes = [ctypes.c_int]
    lib.fp_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.fp_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.fp_ring_pop.restype = ctypes.c_long
    lib.fp_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int]
    lib.fp_ring_size.restype = ctypes.c_long
    lib.fp_ring_size.argtypes = [ctypes.c_void_p]
    lib.fp_ring_dropped.restype = ctypes.c_long
    lib.fp_ring_dropped.argtypes = [ctypes.c_void_p]
    return lib


def _build() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be
    built or loaded (tried once a process)."""
    global _lib, _failed
    with _build_lock:
        if _lib is not None or _failed:
            return _lib
        path = _lib_path()
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp, *_LIBS], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, path)
            except (OSError, subprocess.SubprocessError):
                _failed = True
                return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError:
            _failed = True
        return _lib


def available() -> bool:
    return _build() is not None


def encode_jpeg(rgb: np.ndarray, quality: int = 80) -> Optional[bytes]:
    """uint8 [H, W, 3] -> JPEG bytes, or None if the library is unavailable."""
    lib = _build()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    out = ctypes.c_void_p()
    size = lib.fp_encode_jpeg(rgb.ctypes.data_as(ctypes.c_char_p), h, w, quality,
                              ctypes.byref(out))
    if size <= 0:
        return None
    data = ctypes.string_at(out, size)
    lib.fp_free(out)
    return data


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 [H, W, 3], or None if unavailable."""
    lib = _build()
    if lib is None:
        return None
    out = ctypes.c_void_p()
    h, w = ctypes.c_int(), ctypes.c_int()
    size = lib.fp_decode_jpeg(data, len(data), ctypes.byref(out), ctypes.byref(h),
                              ctypes.byref(w))
    if size <= 0:
        return None
    arr = np.frombuffer(ctypes.string_at(out, size), dtype=np.uint8).copy()
    lib.fp_free(out)
    return arr.reshape(h.value, w.value, 3)


class FrameRing:
    """Native drop-oldest frame queue shared across threads."""

    def __init__(self, capacity: int = 4):
        lib = _build()
        if lib is None:
            raise RuntimeError("framepump native library unavailable")
        self._lib = lib
        self._ring = lib.fp_ring_create(capacity)

    def push(self, data: bytes) -> None:
        self._lib.fp_ring_push(self._ring, data, len(data))

    def pop(self, timeout_ms: int = 100, max_size: int = 16 << 20) -> Optional[bytes]:
        buf = ctypes.create_string_buffer(max_size)
        size = self._lib.fp_ring_pop(self._ring, buf, max_size, timeout_ms)
        if size <= 0:
            return None
        return buf.raw[:size]

    def __len__(self) -> int:
        return self._lib.fp_ring_size(self._ring)

    @property
    def dropped(self) -> int:
        return self._lib.fp_ring_dropped(self._ring)

    def __del__(self):
        ring, self._ring = getattr(self, "_ring", None), None
        if ring:
            self._lib.fp_ring_destroy(ring)
