"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The kernels have a plain C interface and are bound with ``ctypes``: each
source is compiled by its own ``nvcc`` process (all started together) for
``sm_90a`` and the objects are linked into one shared library under
``svit_tpu_torch/_build/``.  The library name carries a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing is built or loaded at import time: the first launch does it.

Every kernel wrapper counts its launches in ``LAUNCHES`` (one count per
launch, nowhere else), so a caller can show that a run went through the
kernels.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# name -> number of kernel launches since the last reset
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu (every function returns cudaGetLastError()).
_SIGNATURES = {
    "svit_ln_linear": [
        _P, _P, _P, _P, _P, _F,            # x, x_add, s_out, ln_g, ln_b, eps
        _P, _P, _I, _I, _P,                # w, bias, bias_mode, gelu, residual
        _P, _P, _P, _I,                    # out0, out1, out_f32, n_split
        _I, _I, _I,                        # M, N, K
        _P, _P, _F, _I,                    # mask_add, mask_out, keep, rows
        _I, _I, _I, _I, _P,                # bm, ncw, stages, splits, stream
    ],
    "svit_ln_rows": [
        _P, _P, _P, _F, _I,                # x, x_add, mask_add, keep, rows
        _P, _P, _F, _P, _P,                # ln_g, ln_b, eps, s_out, xn
        _I, _I, _I, _I, _I, _P,            # M, K, parts, R, smem, stream
    ],
    "svit_pool_ln": [
        _P, _P, _P, _P, _P,                # x, w, ln_g, ln_b, out
        _I, _I, _I, _I, _I,                # B, T, H, W, C
        _I, _I, _I, _I, _I, _I,            # kT, kH, kW, sT, sH, sW
        _I, _I, _I, _I, _F, _I,            # To, Ho, Wo, head_dim, eps, apply_ln
        _I, _I,                            # gen, slab
        _I, _I, _I, _I, _I, _I, _P,        # rows, cols, frames, ring, grid, smem, stream
    ],
    "svit_conv_dx": [
        _P, _P, _P,                        # g, w, dx
        _I, _I, _I, _I, _I,                # B, T, H, W, C
        _I, _I, _I, _I, _I, _I,            # kT, kH, kW, sT, sH, sW
        _I, _I, _I, _I, _I,                # To, Ho, Wo, gen, slab
        _I, _I, _I, _I, _I, _I, _P,        # rows, cols, frames, ring, grid, smem, stream
    ],
    "svit_conv_dk": [
        _P, _P, _P, _P,                    # x, g, partial, dk
        _I, _I, _I, _I, _I,                # B, T, H, W, C
        _I, _I, _I, _I, _I, _I,            # kT, kH, kW, sT, sH, sW
        _I, _I, _I, _I, _I,                # To, Ho, Wo, gen, slab
        _I, _I, _I, _I, _I, _I, _P,        # rows, cols, frames, ring, grid, smem, stream
    ],
    "svit_pool_max": [
        _P, _P, _P,                        # x, out, argmax taps (or null)
        _I, _I, _I, _I, _I,                # B, T, H, W, C
        _I, _I, _I, _I, _I, _I,            # kT, kH, kW, sT, sH, sW
        _I, _I, _I, _P,                    # To, Ho, Wo, stream
    ],
    "svit_pool_max_bwd": [
        _P, _P, _P,                        # g, argmax taps, dx
        _I, _I, _I, _I, _I,                # B, T, H, W, C
        _I, _I, _I, _I, _I, _I,            # kT, kH, kW, sT, sH, sW
        _I, _I, _I,                        # To, Ho, Wo
        _I, _I, _I, _I, _I, _I, _P,        # tile, rows, cols, ring, grid, smem, stream
    ],
    "svit_pooled_attention": [
        _P, _P, _P, _P, _P,                # q, kv, bias_src, onehot tiles, out
        _I, _I, _I, _I, _I, _I,            # B, Nq, Nk, C, heads, R
        _F, _I,                            # scale, q_residual
        _I, _I, _P,                        # stages, rk, stream
    ],
    "svit_pooled_attention_bwd": [
        _P, _P, _P, _P, _P,                # q, kv, bias_src, dout, onehot tiles
        _P, _P, _P, _P, _P, _P, _P,        # dq, dkv, dbias, stats, q*scale, bias tiles, partial
        _I, _I, _I, _I, _I, _I,            # B, Nq, Nk, C, heads, R
        _F, _I,                            # scale, q_residual
        _I, _I, _I, _I, _P,                # q_stages, kv_stages, rk, splits, stream
    ],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD / f"libsvit_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (no-op when built).

    The compilers' output (``ptxas`` registers, shared memory and spills)
    is kept in ``_build/build.log``."""
    so = library_path()
    BUILD.mkdir(exist_ok=True)
    with open(BUILD / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if so.exists():
            return so
        nvcc = _nvcc()
        srcs, _ = _sources()
        objdir = BUILD / (so.stem + ".obj")
        objdir.mkdir(exist_ok=True)
        jobs = []
        for src in srcs:
            obj = objdir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, obj, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        (BUILD / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)[-8000:])
        tmp = so.with_suffix(".tmp")
        subprocess.run(
            [nvcc, "-shared", *(str(o) for _, o, _ in jobs), "-o", str(tmp)],
            check=True, capture_output=True, text=True)
        os.replace(tmp, so)
        return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.svit_error_string.argtypes = [ctypes.c_int]
            lib.svit_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, counter: str, *args) -> None:
    """Call ``name`` in the library, count it under ``counter`` and raise if
    the launch was refused or a previous asynchronous error surfaced."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.svit_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")
    LAUNCHES[counter] += 1


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``: the kernels that split their
    work (K1's N sweep, K5's query splits, K2's and K7's tile walkers) size
    their grids to fill them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype=None, shape=None,
          device=None) -> None:
    """Validate a kernel operand: CUDA, dtype, shape, contiguity, alignment."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} "
                         f"(got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
