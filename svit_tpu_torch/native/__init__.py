"""Native (C++) host-side data code of the port, bound with ctypes and
built with ``make`` at first use (``_shim.py``).

- ``jpeg``: the libjpeg decoder of ``decode.cc``; without a toolchain or
  libjpeg the data layer decodes with PIL.
- ``video``: the libav container decoder and encoder of
  ``video_decode.cc`` (Kinetics, the demo's video files and outputs).
- ``camera``: V4L2 capture of ``camera_v4l2.cc`` (the demo's webcam).
"""
