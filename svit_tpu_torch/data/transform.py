"""Spatial transforms the serving path uses (counterpart of the matching
functions of ``svit_tpu/data/transform.py``).

numpy, channels-last ``[T, H, W, C]`` float32.  ``bilinear_resize``
reproduces ``F.interpolate(mode='bilinear', align_corners=False)`` (half-pixel
sampling, edge clamp), so the deterministic test path (short-side resize +
uniform crop) is bit-comparable to the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _axis_weights(in_size: int, out_size: int):
    """Half-pixel linear sampling indices/weights for one axis."""
    if in_size == out_size:
        idx = np.arange(out_size)
        return idx, idx, np.zeros(out_size, np.float32)
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    lo = np.clip(np.floor(src), 0, in_size - 1).astype(np.int64)
    hi = np.clip(lo + 1, 0, in_size - 1)
    w = np.clip(src - lo, 0.0, 1.0).astype(np.float32)
    return lo, hi, w


def bilinear_resize(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable bilinear resize of [T, H, W, C] (or [H, W, C]) float images."""
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    T, H, W, C = images.shape
    if (H, W) == (out_h, out_w):
        return images[0] if squeeze else images
    ylo, yhi, wy = _axis_weights(H, out_h)
    xlo, xhi, wx = _axis_weights(W, out_w)
    rows = images[:, ylo] * (1 - wy)[None, :, None, None] + images[:, yhi] * wy[None, :, None, None]
    out = (
        rows[:, :, xlo] * (1 - wx)[None, None, :, None]
        + rows[:, :, xhi] * wx[None, None, :, None]
    )
    out = out.astype(images.dtype, copy=False)
    return out[0] if squeeze else out


def short_side_scale(
    images: np.ndarray, size: int, boxes: Optional[np.ndarray] = None
):
    """Resize so the short side equals ``size`` (reference :47-107)."""
    H, W = images.shape[1:3]
    if (W <= H and W == size) or (H <= W and H == size):
        return images, boxes
    if W < H:
        new_w, new_h = size, int(math.floor(H / W * size))
        scale = new_h / H
    else:
        new_h, new_w = size, int(math.floor(W / H * size))
        scale = new_w / W
    if boxes is not None:
        boxes = boxes * scale
    return bilinear_resize(images, new_h, new_w), boxes


def crop_boxes(boxes, x_offset, y_offset):
    out = boxes.copy()
    out[..., [0, 2]] = boxes[..., [0, 2]] - x_offset
    out[..., [1, 3]] = boxes[..., [1, 3]] - y_offset
    return out


def uniform_crop(
    images: np.ndarray,
    size: int,
    spatial_idx: int,
    boxes: Optional[np.ndarray] = None,
):
    """Deterministic 3-position crop (reference :288-340): 0/1/2 = left/center/
    right for landscape, top/center/bottom for portrait."""
    assert spatial_idx in (0, 1, 2)
    H, W = images.shape[1:3]
    y_offset = int(math.ceil((H - size) / 2))
    x_offset = int(math.ceil((W - size) / 2))
    if H > W:
        if spatial_idx == 0:
            y_offset = 0
        elif spatial_idx == 2:
            y_offset = H - size
    else:
        if spatial_idx == 0:
            x_offset = 0
        elif spatial_idx == 2:
            x_offset = W - size
    cropped = images[:, y_offset : y_offset + size, x_offset : x_offset + size]
    if boxes is not None:
        boxes = crop_boxes(boxes, x_offset, y_offset)
        boxes[..., [0, 2]] = np.clip(boxes[..., [0, 2]], 0, size)
        boxes[..., [1, 3]] = np.clip(boxes[..., [1, 3]], 0, size)
    return cropped, boxes


def tensor_normalize(images: np.ndarray, mean, std) -> np.ndarray:
    """uint8 [0,255] -> normalized float32 (reference utils.py:287-304)."""
    images = images.astype(np.float32)
    if images.max() > 1.0:
        images = images / 255.0
    return (images - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
