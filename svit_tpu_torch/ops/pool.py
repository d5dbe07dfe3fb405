"""Pooling kernels K2, K3, K6 and K7 (counterpart of
``svit_tpu/ops/pallas_pool.py``).

- ``fused_pool_ln`` (K2): depthwise 3D conv with zero padding k//2 at any
  strides, accumulated in f32, then LayerNorm over each ``head_dim`` group of
  channels.  The LN scale/bias may be ``head_dim`` wide (shared by the heads)
  or full channel width, which lets the fused k|v pool (``pool_k | pool_v``
  params tiled over heads) run as one launch.
- ``fused_pool_max`` (K3): MaxPool3d with -inf padding k//2.  Its gradient
  is the plain twin's autograd (JAX ``_pool_max_bwd`` is XLA's): ties go to
  the first maximum in window order, as ``reduce_window``'s VJP routes them.
- ``depthwise_conv`` (K2 in bare mode): the conv alone, rounded to the IO
  dtype (JAX ``pallas_depthwise_conv``'s forward).
- ``depthwise_conv_dx`` (K6) and ``depthwise_conv_dk`` (K7): its input and
  filter gradients (JAX ``_pdc_bwd`` and ``_dk_pallas``).

``fused_pool_ln`` is differentiable.  Its backward follows JAX ``_fpl_bwd``
-> ``_pool_ln_recompute``: the conv is recomputed by K2's bare mode and
rounded (the forward does not round before the LN; the recompute does), the
per-head LN goes through autograd, then K6 gives dx and K7 the filter
gradient.

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
from svit_tpu_torch.ops.vjp import needs_grad, plain_vjp

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


def _pool_ln(x, weight, ln_w, ln_b, stride: Triple, head_dim: int,
             apply_ln: bool = True):
    """Kernel K2 (plain version on a CPU tensor)."""
    if x.device.type == "cpu":
        if not apply_ln:
            return depthwise_conv_reference(x, weight, stride)
        return pool_ln_reference(x, weight, ln_w, ln_b, stride, head_dim)
    B, T, H, W, C = x.shape
    kT, kH, kW = weight.shape[2:]
    sT, sH, sW = stride
    _lib.check(x, "x", torch.bfloat16)
    _lib.check(weight, "weight", torch.float32, (C, 1, kT, kH, kW), x.device)
    if C % head_dim or head_dim > 128:
        raise ValueError(f"pool_ln needs head_dim <= 128 dividing C "
                         f"(C={C}, head_dim={head_dim})")
    g = b = None
    if apply_ln:
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
            "svit_pool_ln", "pool_ln" if apply_ln else "pool_conv",
            _lib.ptr(x), _lib.ptr(taps), _lib.ptr(g), _lib.ptr(b),
            _lib.ptr(out), B, T, H, W, C, kT, kH, kW, sT, sH, sW,
            To, Ho, Wo, head_dim, EPS, int(apply_ln), _lib.stream())
    return out


def depthwise_conv_reference(x, weight, stride: Triple):
    """Plain twin of ``depthwise_conv``: the conv in f32 on the IO-dtype
    input, one rounding to the IO dtype."""
    pad = tuple(k // 2 for k in weight.shape[2:])
    y = torch.nn.functional.conv3d(
        x.float().permute(0, 4, 1, 2, 3), weight.float(), stride=tuple(stride),
        padding=pad, groups=x.shape[-1])
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def depthwise_conv(x, weight, stride: Triple, head_dim: int):
    """K2 in bare mode: the depthwise conv rounded to bf16, no LN."""
    return _pool_ln(x, weight, None, None, stride, head_dim, apply_ln=False)


def depthwise_conv_dx_reference(g, weight, stride: Triple, in_shape):
    """Plain twin of ``depthwise_conv_dx``, step by step as JAX ``_pdc_bwd``:
    the f32 cotangent zero-stuffed to the strided positions, right-padded to
    the input extent, convolved at stride 1 with the flipped filters (same
    padding), rounded to ``g``'s dtype."""
    B, T, H, W, C = in_shape
    st, sh, sw = stride
    gf = g.float()
    To, Ho, Wo = gf.shape[1:4]
    stuffed = gf.new_zeros((B, (To - 1) * st + 1, (Ho - 1) * sh + 1,
                            (Wo - 1) * sw + 1, C))
    stuffed[:, ::st, ::sh, ::sw] = gf
    stuffed = torch.nn.functional.pad(
        stuffed, (0, 0, 0, W - stuffed.shape[3], 0, H - stuffed.shape[2],
                  0, T - stuffed.shape[1]))
    flipped = weight.float().flip(2, 3, 4)
    return depthwise_conv_reference(stuffed, flipped, (1, 1, 1)).to(g.dtype)


def depthwise_conv_dx(g, weight, stride: Triple, in_shape):
    """Kernel K6: the input gradient of the depthwise conv (padding k//2,
    ``stride``) as a transposed conv by gather.  g: [B, To, Ho, Wo, C]
    bf16; weight: [C, 1, kT, kH, kW] f32; returns bf16 ``in_shape``."""
    if g.device.type == "cpu":
        return depthwise_conv_dx_reference(g, weight, stride, in_shape)
    B, T, H, W, C = in_shape
    kT, kH, kW = weight.shape[2:]
    To, Ho, Wo = g.shape[1:4]
    _lib.check(g, "g", torch.bfloat16)
    _lib.check(weight, "weight", torch.float32, (C, 1, kT, kH, kW), g.device)
    if C % 8 or tuple(g.shape) != (B, To, Ho, Wo, C):
        raise ValueError(f"conv_dx: g {tuple(g.shape)} against input {in_shape}")
    taps = weight.reshape(C, kT * kH * kW).t().contiguous()
    dx = torch.empty(tuple(in_shape), dtype=g.dtype, device=g.device)
    if dx.numel():
        _lib.launch("svit_conv_dx", "pool_conv_dx", _lib.ptr(g),
                    _lib.ptr(taps), _lib.ptr(dx), B, T, H, W, C, kT, kH, kW,
                    *stride, To, Ho, Wo, _lib.stream())
    return dx


def depthwise_conv_dk_reference(x, g, kernel: Triple, stride: Triple):
    """Plain twin of ``depthwise_conv_dk``: the tap formulation of JAX
    ``_dk_pallas`` (x and g in f32, one strided slice of the zero-padded x
    per tap, multiplied by g and summed over batch and positions).
    Returns [C, 1, kT, kH, kW] f32."""
    kT, kH, kW = kernel
    st, sh, sw = stride
    To, Ho, Wo = g.shape[1:4]
    xp = torch.nn.functional.pad(
        x.float(), (0, 0, kW // 2, kW // 2, kH // 2, kH // 2, kT // 2, kT // 2))
    gf = g.float()
    taps = []
    for dt in range(kT):
        for dh in range(kH):
            for dw in range(kW):
                sl = xp[:, dt:dt + (To - 1) * st + 1:st,
                        dh:dh + (Ho - 1) * sh + 1:sh,
                        dw:dw + (Wo - 1) * sw + 1:sw]
                taps.append((sl * gf).sum(dim=(0, 1, 2, 3)))
    return torch.stack(taps, dim=1).view(-1, 1, kT, kH, kW)


def depthwise_conv_dk(x, g, kernel: Triple, stride: Triple):
    """Kernel K7: the filter gradient ``dk[tap, c] = sum over batch and
    output positions of x_pad[out * s + tap, c] * g[out, c]`` in f32 (x and
    g bf16).  Returns [C, 1, kT, kH, kW] f32."""
    if x.device.type == "cpu":
        return depthwise_conv_dk_reference(x, g, kernel, stride)
    B, T, H, W, C = x.shape
    kT, kH, kW = kernel
    To, Ho, Wo = g.shape[1:4]
    _lib.check(x, "x", torch.bfloat16)
    _lib.check(g, "g", torch.bfloat16, (B, To, Ho, Wo, C), x.device)
    if kT not in (1, 3) or (kH, kW) != (3, 3):
        raise ValueError(f"conv_dk takes kernels (1|3, 3, 3), not {kernel}")
    groups = -(-C // 32)
    positions = B * To * Ho * Wo
    chunks = max(1, min(-(-4 * _lib.sm_count(x.device) // groups),
                        -(-positions // 64)))
    partial = torch.empty((chunks, kT * kH * kW, C), dtype=torch.float32,
                          device=x.device)
    dk = torch.empty((kT * kH * kW, C), dtype=torch.float32, device=x.device)
    if positions:
        _lib.launch("svit_conv_dk", "pool_conv_dk", _lib.ptr(x), _lib.ptr(g),
                    _lib.ptr(partial), _lib.ptr(dk), B, T, H, W, C, kT,
                    *stride, To, Ho, Wo, chunks, _lib.stream())
    else:
        dk.zero_()
    return dk.t().reshape(C, 1, kT, kH, kW)


class _PoolLnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, ln_w, ln_b, stride, head_dim):
        ctx.stride, ctx.head_dim = tuple(stride), head_dim
        ctx.save_for_backward(x, weight, ln_w, ln_b)
        return _pool_ln(x, weight, ln_w, ln_b, stride, head_dim)

    @staticmethod
    def backward(ctx, g):
        x, weight, ln_w, ln_b = ctx.saved_tensors
        stride, hd = ctx.stride, ctx.head_dim
        y = depthwise_conv(x, weight, stride, hd)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (y, ln_w, ln_b)]
            out = group_layer_norm(*leaves, hd)
            gy, glw, glb = torch.autograd.grad(out, leaves, g)
        gy = gy.contiguous()
        dx = depthwise_conv_dx(gy, weight, stride, x.shape)
        dk = depthwise_conv_dk(x, gy, tuple(weight.shape[2:]), stride)
        return dx, dk, glw, glb, None, None


def fused_pool_ln(x, weight, ln_w, ln_b, stride: Triple, head_dim: int):
    """Kernel K2.  x: [B, T, H, W, C] bf16; weight: [C, 1, kT, kH, kW] f32;
    ln_w/ln_b: f32 of size head_dim or C.  Returns [B, To, Ho, Wo, C].
    Differentiable: K2 bare, K6 and K7 in the backward."""
    if not needs_grad(x, weight, ln_w, ln_b):
        return _pool_ln(x, weight, ln_w, ln_b, stride, head_dim)
    return _PoolLnFn.apply(x, weight, ln_w, ln_b, tuple(stride), head_dim)


def pool_max_reference(x, kernel: Triple, stride: Triple):
    """Plain twin of ``fused_pool_max``."""
    return max_pool3d(x, kernel, stride)


def fused_pool_max(x, kernel: Triple, stride: Triple):
    """Kernel K3: MaxPool3d of a channels-last bf16 grid, -inf padding k//2.
    Differentiable through the plain twin's autograd."""
    return plain_vjp(_pool_max, pool_max_reference, (x,), tuple(kernel),
                     tuple(stride))


def _pool_max(x, kernel: Triple, stride: Triple):
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
