"""ctypes bindings for the port's V4L2 webcam shim (``camera_v4l2.cc``;
counterpart of ``svit_tpu/native/camera.py``).

The role cv2.VideoCapture plays in the reference demo
(``slowfast/visualization/demo_loader.py:28-47``); here the kernel V4L2
API is used directly, so the webcam path needs no OpenCV.  The YUV
conversion is exposed apart (``yuyv_to_rgb``), so its numerics are
testable without a camera.  The library is built with ``make`` at first
use (``_shim.py``); where it cannot be, every call raises with the build's
error.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional

import numpy as np

from svit_tpu_torch.native._shim import Shim


def _bind(lib) -> None:
    lib.svit_yuyv_to_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.svit_camera_open.restype = ctypes.c_void_p
    lib.svit_camera_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.svit_camera_read.restype = ctypes.c_int
    lib.svit_camera_read.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.svit_camera_close.argtypes = [ctypes.c_void_p]


SHIM = Shim("libsvit_camera.so", _bind)


def available() -> bool:
    return SHIM.load() is not None


def yuyv_to_rgb(yuyv: np.ndarray, w: int, h: int) -> np.ndarray:
    """BT.601 YUYV -> RGB through the shim; ``yuyv`` is [h*w*2] uint8."""
    lib = SHIM.require()
    yuyv = np.ascontiguousarray(yuyv, np.uint8)
    out = np.empty(h * w * 3, np.uint8)
    lib.svit_yuyv_to_rgb(
        yuyv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.reshape(h, w, 3)


class CameraSource:
    """Streaming RGB frames from /dev/video<index> (a context manager): the
    reference ``VideoManager``'s webcam branch
    (``slowfast/visualization/demo_loader.py:28-47``).  Opens the device,
    then yields uint8 RGB [H, W, 3] frames until closed or stalled."""

    def __init__(self, index: int, width: int = 0, height: int = 0):
        lib = SHIM.require()
        dev = f"/dev/video{index}"
        w = ctypes.c_int()
        h = ctypes.c_int()
        self._lib = lib
        self._cam = lib.svit_camera_open(
            dev.encode(), width, height, ctypes.byref(w), ctypes.byref(h))
        if not self._cam:
            raise RuntimeError(
                f"could not open {dev} for V4L2 streaming capture")
        self.width = w.value
        self.height = h.value

    def read(self) -> Optional[np.ndarray]:
        """The next frame, or None on a timeout (the camera stalled > 2 s)."""
        out = np.empty(self.height * self.width * 3, np.uint8)
        rc = self._lib.svit_camera_read(
            self._cam, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == -1:
            return None
        if rc < 0:
            raise RuntimeError("V4L2 device error during capture")
        return out.reshape(self.height, self.width, 3)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def close(self) -> None:
        if getattr(self, "_cam", None):
            self._lib.svit_camera_close(self._cam)
            self._cam = None

    def __enter__(self) -> "CameraSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # close() is the API; this only tidies up
        try:
            self.close()
        except Exception:
            pass
