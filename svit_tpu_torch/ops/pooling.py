"""Token-grid pooling primitives as plain PyTorch (counterpart of
``svit_tpu/ops/pooling.py``).

Streams are channels-last ``[B, T, H, W, C]``; depthwise filters keep the
PyTorch layout ``[C, 1, kT, kH, kW]``.  Padding is ``k // 2`` on every axis
and the output size floors, as ``torch.nn.Conv3d`` / ``MaxPool3d`` do.

Object tokens never pass through the conv: the reference broadcasts each
token over the kernel window, applies the depthwise conv and means the
result, which for a constant-per-channel input is exactly a per-channel
multiplier (``conv_obj_multiplier``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Triple = Tuple[int, int, int]


def out_size(d: int, k: int, s: int) -> int:
    """Output length of one axis of a pool/conv with padding k//2."""
    return (d + 2 * (k // 2) - k) // s + 1


def _cf(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


def depthwise_conv3d(x: torch.Tensor, weight: torch.Tensor,
                     stride: Triple) -> torch.Tensor:
    """Depthwise 3D conv of a channels-last grid, padding k//2 each side.

    x: [B, T, H, W, C]; weight: [C, 1, kT, kH, kW] (one filter per channel).
    """
    pad = tuple(k // 2 for k in weight.shape[2:])
    y = F.conv3d(_cf(x), weight.to(x.dtype), stride=tuple(stride),
                 padding=pad, groups=x.shape[-1])
    return _cl(y)


def max_pool3d(x: torch.Tensor, kernel: Triple, stride: Triple) -> torch.Tensor:
    """MaxPool3d of a channels-last grid; padding k//2 never wins (-inf).

    Its gradient goes to the first maximum of each window in (t, h, w)
    order, which is where the VJP of JAX's ``reduce_window`` max (select
    ``ge``) sends it when values tie (pinned in bf16 by
    ``tests/test_torch_divergence.py``)."""
    pad = tuple(k // 2 for k in kernel)
    return _cl(F.max_pool3d(_cf(x), tuple(kernel), tuple(stride), pad))


def avg_pool3d(x: torch.Tensor, kernel: Triple, stride: Triple) -> torch.Tensor:
    """AvgPool3d of a channels-last grid, padding k//2, the zeros of the
    padding counted (``count_include_pad``, as the JAX package's sum over
    the window divided by its size)."""
    pad = [k // 2 for k in reversed(kernel) for _ in (0, 1)]
    # the zeros padded first: torch refuses a window larger than the
    # unpadded input (a 2-frame clip under kT 3)
    return _cl(F.avg_pool3d(F.pad(_cf(x), pad), tuple(kernel), tuple(stride)))


def conv_obj_multiplier(weight: torch.Tensor, stride: Triple) -> torch.Tensor:
    """Per-channel multiplier equivalent to the reference's object-token conv.

    A depthwise conv (padding k//2, stride s) applied to a constant-per-channel
    input of spatial size (kT, kH, kW), then meaned over its outputs, scales
    each channel by ``mean_p(sum of the weights overlapping position p)``.
    Returns shape [C] in ``weight``'s dtype.
    """
    C = weight.shape[0]
    ones = torch.ones((1,) + tuple(weight.shape[2:]) + (C,),
                      dtype=weight.dtype, device=weight.device)
    return depthwise_conv3d(ones, weight, stride).mean(dim=(1, 2, 3))[0]
