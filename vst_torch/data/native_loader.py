"""ctypes binding for the native threaded .npy batch loader, port of
``vst/data/native_loader.py``.

Builds ``vst_torch/native/loader.cc`` with g++ at first use into the
gitignored ``vst_torch/_build/`` (tagged by the source's hash, written under
a temporary name and renamed, so concurrent first uses do not collide). A
file the native reader does not support, or a failed build, falls back to
``np.load`` per file, as vst's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "loader.cc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    tag = hashlib.sha1(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libvstloader_{tag}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(_SRC), "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    so = library_path()
    try:
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (subprocess.CalledProcessError, OSError):
        _build_failed = True
        return None
    lib.vst_load_npy_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
    ]
    lib.vst_load_npy_batch.restype = None
    _lib = lib
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def load_npy_batch(paths: List[str], shape, n_threads: int = 8) -> np.ndarray:
    """len(paths) float32 .npy files of one ``shape`` as one (N, *shape)
    array, the file I/O parallel in C++ (the GIL released); np.load per file
    where the native reader returns short."""
    n = len(paths)
    slot = int(np.prod(shape))
    out = np.empty((n, slot), np.float32)

    lib = _get_lib()
    if lib is not None:
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        counts = (ctypes.c_size_t * n)()
        lib.vst_load_npy_batch(c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               slot, counts, n_threads)
        for i in range(n):
            if counts[i] != slot:  # unsupported file → numpy fallback
                out[i] = np.load(paths[i]).astype(np.float32).reshape(-1)
    else:
        for i in range(n):
            out[i] = np.load(paths[i]).astype(np.float32).reshape(-1)
    return out.reshape((n,) + tuple(shape))
