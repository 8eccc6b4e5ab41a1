"""Host C++ built at first use and bound with ``ctypes``.

The port's host-side native code (the PNG unfilter in ``native/``, and the
repository's EXR decoder and decode pool in ``<repo>/native/``) is compiled
with ``g++ -O3 -shared -fPIC`` into ``<repo>/build/native/``, one library
per digest of its sources and flags, and loaded with ``ctypes.CDLL``, whose
calls release the interpreter lock. A missing compiler or a failed build
raises with the compiler's output: nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LOADED: Dict[Path, ctypes.CDLL] = {}


def find_cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(
            "no C++ compiler (g++ or $CXX) on PATH: the host native code cannot be built"
        )
    return cxx


def build(name: str, sources: Sequence[Path], libs: Sequence[str] = ()) -> Path:
    """Compile ``sources`` into ``build/native/lib<name>_<digest>.so`` unless
    it is built already; returns its path. Raises when the build fails."""
    sources = [Path(s) for s in sources]
    flags = (*CXX_FLAGS, *libs)
    digest = hashlib.sha1(
        b"".join(s.read_bytes() for s in sources) + " ".join(flags).encode()
    ).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_cxx(), *CXX_FLAGS, "-o", str(tmp), *map(str, sources), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load(name: str, sources: Sequence[Path], signatures, libs: Sequence[str] = ()):
    """Build and bind: ``signatures`` maps each C entry point to
    ``(restype, argtypes)``. One ``CDLL`` per built library and process."""
    with _LOCK:
        path = build(name, sources, libs)
        lib = _LOADED.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            for fn_name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _LOADED[path] = lib
        return lib
