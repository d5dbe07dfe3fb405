"""ctypes bindings for the port's JPEG decoder (``decode.cc``).

The library is built with ``make`` at first use into
``svit_tpu_torch/_build/native/`` (git-ignored), one process at a time
(a file lock: loader processes would race to build it).  Without ``make``,
``g++`` or libjpeg the build fails once, and every call returns None: the
caller decodes with PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(os.path.dirname(_DIR), "_build", "native")
_SO = os.path.join(_OUT, "libsvit_jpeg.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    import fcntl

    try:
        os.makedirs(_OUT, exist_ok=True)
        with open(os.path.join(_OUT, ".build.lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            if os.path.isfile(_SO):
                return True
            subprocess.run(["make", "-s", "-C", _DIR, f"OUT={_OUT}", _SO],
                           check=True, capture_output=True, timeout=120)
            return os.path.isfile(_SO)
    except Exception:
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.isfile(_SO) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.svit_decode_jpeg_file.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.svit_decode_jpeg_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.svit_decode_jpeg_batch.restype = ctypes.c_int
        lib.svit_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.svit_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_file(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG to uint8 RGB [H, W, 3]; None if unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    ptr = lib.svit_decode_jpeg_file(path.encode(), ctypes.byref(w),
                                    ctypes.byref(h))
    if not ptr:
        return None
    try:
        n = w.value * h.value * 3
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        return arr.reshape(h.value, w.value, 3)
    finally:
        lib.svit_free(ptr)


def decode_batch(paths: List[str]) -> Optional[List[Optional[np.ndarray]]]:
    """Decode many JPEGs on native threads (the GIL released once); None
    where the library is unavailable, a None entry where a file failed."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    lib.svit_decode_jpeg_batch(c_paths, n, outs, ws, hs)
    results: List[Optional[np.ndarray]] = []
    for i in range(n):
        if not outs[i]:
            results.append(None)
            continue
        size = ws[i] * hs[i] * 3
        arr = np.ctypeslib.as_array(outs[i], shape=(size,)).copy()
        results.append(arr.reshape(hs[i], ws[i], 3))
        lib.svit_free(outs[i])
    return results
