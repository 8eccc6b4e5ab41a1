"""ctypes binding of the repository's native EXR decoder and decode pool.

The C++ sources are the repository's ``native/exr.cpp`` and
``native/pool.cpp`` (a scanline EXR decoder for FLOAT/HALF channels with
NONE, ZIPS or ZIP compression, and a worker pool around it). The port
builds them itself, read-only, with ``g++ ... -lz -lpthread`` into
``build/native/`` (``io/native_build.py``); it never touches
``native/libniceslam_native.so`` or the ``native/Makefile`` target. A failed
build raises with the compiler's output. A file the decoder refuses raises
``IOError`` with the decoder's code.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import native_build

_NATIVE = Path(__file__).resolve().parents[2] / "native"
_SOURCES = (_NATIVE / "exr.cpp", _NATIVE / "pool.cpp")


def _lib():
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    pi = ctypes.POINTER(ctypes.c_int)
    return native_build.load("niceslam_native", _SOURCES, {
        "exr_decode_file": (i, [s, s, p, pi, pi]),
        "pool_create": (p, [i]),
        "pool_destroy": (None, [p]),
        "pool_submit": (None, [p, i, s, s, p, i, i]),
        "pool_wait": (i, [p, i]),
    }, libs=("-lz", "-lpthread"))


def read_exr(path: str, channel: str = "") -> np.ndarray:
    """Decode one channel of a scanline EXR into float32 ``[H, W]`` (the
    first channel, or ``channel`` by name)."""
    lib = _lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    want = channel.encode() or None
    rc = lib.exr_decode_file(path.encode(), want, None, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"EXR header decode failed ({rc}): {path}")
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.exr_decode_file(path.encode(), want, out.ctypes.data,
                             ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"EXR decode failed ({rc}): {path}")
    return out


class NativeDecodePool:
    """Asynchronous multi-worker EXR decode: submit paths, collect arrays."""

    def __init__(self, n_workers: int = 4):
        self._lib = _lib()
        self._pool = self._lib.pool_create(n_workers)
        self._bufs = {}
        self._ticket = 0

    def submit(self, path: str, shape, channel: str = "") -> int:
        h, w = shape
        buf = np.empty((h, w), np.float32)
        self._ticket += 1
        t = self._ticket
        self._bufs[t] = buf
        self._lib.pool_submit(self._pool, t, path.encode(), channel.encode() or None,
                              buf.ctypes.data, w, h)
        return t

    def wait(self, ticket: int) -> np.ndarray:
        rc = self._lib.pool_wait(self._pool, ticket)
        buf = self._bufs.pop(ticket)
        if rc != 0:
            raise IOError(f"native decode failed ({rc})")
        return buf

    def close(self):
        if self._pool:
            self._lib.pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        if getattr(self, "_pool", None):
            self.close()
