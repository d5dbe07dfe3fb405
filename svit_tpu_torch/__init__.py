"""svit_tpu_torch: the SViT serving forward on PyTorch and CUDA.

A port of the JAX package ``svit_tpu`` (which stays the reference) to one
NVIDIA H100: the same config tree and parameter names, channels-last streams,
and the TPU's Pallas kernels rewritten by hand in CUDA C++ (``csrc/``).  It
imports neither JAX nor any module of ``svit_tpu``.
"""

__version__ = "0.1.0"
