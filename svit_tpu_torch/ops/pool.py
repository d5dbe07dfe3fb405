"""Pooling kernels K2 and K3 (counterpart of ``svit_tpu/ops/pallas_pool.py``).

- ``fused_pool_ln`` (K2): depthwise 3D conv with zero padding k//2 at any
  strides, accumulated in f32, then LayerNorm over each ``head_dim`` group of
  channels.  The LN scale/bias may be ``head_dim`` wide (shared by the heads)
  or full channel width, which lets the fused k|v pool (``pool_k | pool_v``
  params tiled over heads) run as one launch.
- ``fused_pool_max`` (K3): MaxPool3d with -inf padding k//2.

Streams are channels-last ``[B, T, H, W, C]`` at their exact widths; filters
keep the PyTorch depthwise layout ``[C, 1, kT, kH, kW]``.  On a CPU tensor
each wrapper runs its plain version; on a CUDA tensor it launches the kernel
(``csrc/pool.cu``) or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from svit_tpu_torch.ops import _lib
from svit_tpu_torch.ops.pooling import max_pool3d, out_size

Triple = Tuple[int, int, int]
EPS = 1e-6


def _full_width(p: torch.Tensor, C: int) -> torch.Tensor:
    return p if p.shape[0] == C else p.repeat(C // p.shape[0])


def group_layer_norm(x, ln_w, ln_b, head_dim: int, out_dtype=None):
    """LayerNorm in f32 over each ``head_dim`` group of the last axis;
    ``ln_w``/``ln_b`` are head_dim or full width.  Returns ``out_dtype``
    (default: ``x``'s dtype)."""
    C = x.shape[-1]
    h = C // head_dim
    xf = x.float().reshape(*x.shape[:-1], h, head_dim)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    g = _full_width(ln_w, C).float().view(h, head_dim)
    b = _full_width(ln_b, C).float().view(h, head_dim)
    o = (xf - mean) * torch.rsqrt(var + EPS) * g + b
    return o.reshape(x.shape).to(out_dtype or x.dtype).contiguous()


def pool_ln_reference(x, weight, ln_w, ln_b, stride: Triple, head_dim: int):
    """Plain twin of ``fused_pool_ln``: the conv in f32 on the IO-dtype input,
    per-head LN in f32, one rounding to the IO dtype."""
    pad = tuple(k // 2 for k in weight.shape[2:])
    y = torch.nn.functional.conv3d(
        x.float().permute(0, 4, 1, 2, 3), weight.float(), stride=tuple(stride),
        padding=pad, groups=x.shape[-1],
    ).permute(0, 2, 3, 4, 1)
    return group_layer_norm(y, ln_w, ln_b, head_dim, x.dtype)


def fused_pool_ln(x, weight, ln_w, ln_b, stride: Triple, head_dim: int):
    """Kernel K2.  x: [B, T, H, W, C] bf16; weight: [C, 1, kT, kH, kW] f32;
    ln_w/ln_b: f32 of size head_dim or C.  Returns [B, To, Ho, Wo, C]."""
    if x.device.type == "cpu":
        return pool_ln_reference(x, weight, ln_w, ln_b, stride, head_dim)
    B, T, H, W, C = x.shape
    kT, kH, kW = weight.shape[2:]
    sT, sH, sW = stride
    _lib.check(x, "x", torch.bfloat16)
    _lib.check(weight, "weight", torch.float32, (C, 1, kT, kH, kW), x.device)
    if C % head_dim or head_dim > 128:
        raise ValueError(f"pool_ln needs head_dim <= 128 dividing C "
                         f"(C={C}, head_dim={head_dim})")
    g = _full_width(ln_w, C).contiguous()
    b = _full_width(ln_b, C).contiguous()
    _lib.check(g, "ln weight", torch.float32, (C,), x.device)
    _lib.check(b, "ln bias", torch.float32, (C,), x.device)
    # tap-major [kT*kH*kW, C] filter: lanes read neighbouring channels
    taps = weight.reshape(C, kT * kH * kW).t().contiguous()
    To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                  zip((T, H, W), (kT, kH, kW), stride))
    out = torch.empty((B, To, Ho, Wo, C), dtype=x.dtype, device=x.device)
    if out.numel():
        _lib.launch(
            "svit_pool_ln", "pool_ln",
            _lib.ptr(x), _lib.ptr(taps), _lib.ptr(g), _lib.ptr(b),
            _lib.ptr(out), B, T, H, W, C, kT, kH, kW, sT, sH, sW,
            To, Ho, Wo, head_dim, EPS, _lib.stream())
    return out


def pool_max_reference(x, kernel: Triple, stride: Triple):
    """Plain twin of ``fused_pool_max``."""
    return max_pool3d(x, kernel, stride)


def fused_pool_max(x, kernel: Triple, stride: Triple):
    """Kernel K3: MaxPool3d of a channels-last bf16 grid, -inf padding k//2."""
    if x.device.type == "cpu":
        return pool_max_reference(x, kernel, stride)
    B, T, H, W, C = x.shape
    _lib.check(x, "x", torch.bfloat16)
    if C % 8:
        raise ValueError(f"pool_max needs C a multiple of 8 (C={C})")
    To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                  zip((T, H, W), kernel, stride))
    out = torch.empty((B, To, Ho, Wo, C), dtype=x.dtype, device=x.device)
    if out.numel():
        _lib.launch(
            "svit_pool_max", "pool_max",
            _lib.ptr(x), _lib.ptr(out), B, T, H, W, C, *kernel, *stride,
            To, Ho, Wo, _lib.stream())
    return out
