"""ctypes bindings for the port's JPEG decoder (``decode.cc``).

The library is built with ``make`` at first use (``_shim.py``).  Without
``make``, ``g++`` or libjpeg the build fails once, and every call returns
None: the caller decodes with PIL.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from svit_tpu_torch.native._shim import Shim


def _bind(lib) -> None:
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


SHIM = Shim("libsvit_jpeg.so", _bind)


def available() -> bool:
    return SHIM.load() is not None


def decode_file(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG to uint8 RGB [H, W, 3]; None if unavailable/failed."""
    lib = SHIM.load()
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
    lib = SHIM.load()
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
