"""ctypes bindings for the port's libav video decoder (``video_decode.cc``;
counterpart of ``svit_tpu/native/video.py``).

The role PyAV plays in the reference decode path
(``slowfast/datasets/decoder.py:148-233``); here the system libav* is bound
directly.  All clip-window math stays in ``data/decoder.py``: this module
only exposes probe, decode-window and encoding.  The library is built with
``make`` at first use (``_shim.py``) and fails alone where libav is absent:
``probe`` and ``decode_window`` then return None, and the writers raise
with the build's error.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from svit_tpu_torch.native._shim import Shim


def _bind(lib) -> None:
    lib.svit_video_probe.restype = ctypes.c_int
    lib.svit_video_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.svit_video_decode_window.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.svit_video_decode_window.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ]
    lib.svit_video_encode_gray_ramp.restype = ctypes.c_int
    lib.svit_video_encode_gray_ramp.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.svit_video_encoder_open.restype = ctypes.c_void_p
    lib.svit_video_encoder_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ]
    lib.svit_video_encoder_write.restype = ctypes.c_int
    lib.svit_video_encoder_write.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int,
    ]
    lib.svit_video_encoder_close.restype = ctypes.c_int
    lib.svit_video_encoder_close.argtypes = [ctypes.c_void_p]
    lib.svit_video_free.argtypes = [ctypes.c_void_p]


SHIM = Shim("libsvit_video.so", _bind)


def available() -> bool:
    return SHIM.load() is not None


def probe(path: str) -> Optional[Tuple[float, int, Optional[int]]]:
    """(average_fps, nb_frames, duration_pts): nb_frames may be 0 and
    duration None when the container does not record them (PyAV parity)."""
    lib = SHIM.load()
    if lib is None:
        return None
    fps = ctypes.c_double()
    nb = ctypes.c_int64()
    dur = ctypes.c_int64()
    if lib.svit_video_probe(path.encode(), ctypes.byref(fps),
                            ctypes.byref(nb), ctypes.byref(dur)) != 0:
        return None
    return fps.value, int(nb.value), (None if dur.value < 0 else int(dur.value))


def decode_window(
    path: str, start_pts: int = 0, end_pts: Optional[int] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Frames with pts in [start_pts, end_pts] as uint8 RGB [N, H, W, 3]
    plus their pts [N]; ``end_pts=None`` decodes the whole stream."""
    lib = SHIM.load()
    if lib is None:
        return None
    n = ctypes.c_int()
    w = ctypes.c_int()
    h = ctypes.c_int()
    pts_ptr = ctypes.POINTER(ctypes.c_int64)()
    buf = lib.svit_video_decode_window(
        path.encode(), start_pts, -1 if end_pts is None else end_pts,
        ctypes.byref(n), ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(pts_ptr),
    )
    if not buf or n.value == 0:
        if pts_ptr:
            lib.svit_video_free(pts_ptr)
        return None
    try:
        shape = (n.value, h.value, w.value, 3)
        video = np.ctypeslib.as_array(buf, shape=shape).copy()
        if pts_ptr:
            pts = np.ctypeslib.as_array(pts_ptr, shape=(n.value,)).copy()
        else:  # the pts allocation failed in C: ordinals (frames are sorted)
            pts = np.arange(n.value, dtype=np.int64)
    finally:
        lib.svit_video_free(buf)
        if pts_ptr:
            lib.svit_video_free(pts_ptr)
    return video, pts


def encode_gray_ramp(path: str, w: int = 64, h: int = 48, n: int = 120,
                     fps: int = 30) -> bool:
    """Test fixture writer: an mpeg4 container of gray frames with luma
    16 + 3*i (invertible back to the source frame index).  Raises when the
    library is missing; False when the encode fails."""
    lib = SHIM.require()
    return lib.svit_video_encode_gray_ramp(path.encode(), w, h, n, fps) == 0


class VideoEncoder:
    """Streaming RGB24 -> mpeg4 writer (the role of cv2.VideoWriter in the
    reference demo, ``slowfast/visualization/demo_loader.py``).

    Usage: ``enc = VideoEncoder(path, w, h, fps); enc.write(frame)...;
    enc.close()``.  Frames are uint8 RGB [H, W, 3] at the open dimensions.
    Raises RuntimeError when the library is missing or cannot open the
    output.
    """

    def __init__(self, path: str, w: int, h: int, fps: float):
        lib = SHIM.require()
        self._lib = lib
        self._w, self._h = w, h
        self._handle = lib.svit_video_encoder_open(
            path.encode(), w, h, float(fps))
        if not self._handle:
            raise RuntimeError(f"cannot open video encoder for {path}")

    def write(self, frame: np.ndarray) -> None:
        assert frame.shape == (self._h, self._w, 3), (
            f"frame {frame.shape} != open dims ({self._h}, {self._w}, 3)")
        buf = np.ascontiguousarray(frame, dtype=np.uint8)
        rc = self._lib.svit_video_encoder_write(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._w, self._h)
        if rc != 0:
            raise RuntimeError(f"video encode failed (rc={rc})")

    def close(self) -> None:
        if self._handle:
            rc = self._lib.svit_video_encoder_close(self._handle)
            self._handle = None
            if rc != 0:
                raise RuntimeError(f"video finalize failed (rc={rc})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def encoder_available() -> bool:
    return SHIM.load() is not None
