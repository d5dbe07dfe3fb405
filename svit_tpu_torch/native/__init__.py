"""Native (C++) host-side data code of the port, bound with ctypes.

``jpeg``: the libjpeg decoder of ``decode.cc``, built with ``make`` at
first use; without a toolchain or libjpeg the data layer decodes with PIL.
"""
