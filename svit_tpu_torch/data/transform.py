"""Spatial transforms of the port's data layer (counterpart of
``svit_tpu/data/transform.py``; reference ``slowfast/datasets/transform.py``
and ``datasets/utils.py``).

numpy, channels-last ``[T, H, W, C]`` float32.  ``bilinear_resize``
reproduces ``F.interpolate(mode='bilinear', align_corners=False)`` (half-pixel
sampling, edge clamp), so the deterministic test path (short-side resize +
uniform crop) is bit-comparable to the reference.  All randomness flows
through an explicit ``np.random.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def random_short_side_scale_jitter(
    images: np.ndarray,
    min_size: int,
    max_size: int,
    rng: np.random.Generator,
    boxes: Optional[np.ndarray] = None,
    inverse_uniform_sampling: bool = False,
):
    if inverse_uniform_sampling:
        size = int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(rng.uniform(min_size, max_size)))
    return short_side_scale(images, size, boxes)


def crop_boxes(boxes, x_offset, y_offset):
    out = boxes.copy()
    out[..., [0, 2]] = boxes[..., [0, 2]] - x_offset
    out[..., [1, 3]] = boxes[..., [1, 3]] - y_offset
    return out


def random_crop(
    images: np.ndarray,
    size: int,
    rng: np.random.Generator,
    boxes: Optional[np.ndarray] = None,
):
    """Random spatial crop (reference :154-193)."""
    H, W = images.shape[1:3]
    if H == size and W == size:
        return images, boxes
    y = int(rng.integers(0, H - size + 1))
    x = int(rng.integers(0, W - size + 1))
    cropped = images[:, y : y + size, x : x + size]
    if boxes is not None:
        boxes = crop_boxes(boxes, x, y)
        boxes[..., [0, 2]] = np.clip(boxes[..., [0, 2]], 0, size)
        boxes[..., [1, 3]] = np.clip(boxes[..., [1, 3]], 0, size)
    return cropped, boxes


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


def horizontal_flip(
    prob: float,
    images: np.ndarray,
    rng: np.random.Generator,
    boxes: Optional[np.ndarray] = None,
):
    if rng.uniform() < prob:
        W = images.shape[2]
        images = images[:, :, ::-1]
        if boxes is not None:
            out = boxes.copy()
            out[..., 0] = W - boxes[..., 2]
            out[..., 2] = W - boxes[..., 0]
            boxes = out
    return images, boxes


def _get_param_spatial_crop(
    scale: Tuple[float, float],
    ratio: Tuple[float, float],
    height: int,
    width: int,
    rng: np.random.Generator,
    num_repeat: int = 10,
):
    """Inception-style crop parameters (reference :597-637)."""
    for _ in range(num_repeat):
        area = height * width
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return i, j, h, w
    in_ratio = width / height
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def random_resized_crop(
    images: np.ndarray,
    target_height: int,
    target_width: int,
    rng: np.random.Generator,
    scale=(0.08, 1.0),
    ratio=(3.0 / 4.0, 4.0 / 3.0),
    boxes: Optional[np.ndarray] = None,
):
    """Inception crop + resize (reference :638-684), box-aware."""
    H, W = images.shape[1:3]
    i, j, h, w = _get_param_spatial_crop(scale, ratio, H, W, rng)
    cropped = images[:, i : i + h, j : j + w]
    out = bilinear_resize(cropped, target_height, target_width)
    if boxes is not None:
        boxes = crop_boxes(boxes, j, i)
        boxes[..., [0, 2]] = np.clip(boxes[..., [0, 2]], 0, w) * target_width / w
        boxes[..., [1, 3]] = np.clip(boxes[..., [1, 3]], 0, h) * target_height / h
        return out, boxes
    return out, None


def tensor_normalize(images: np.ndarray, mean, std) -> np.ndarray:
    """uint8 [0,255] -> normalized float32 (reference utils.py:287-304)."""
    images = images.astype(np.float32)
    if images.max() > 1.0:
        images = images / 255.0
    return (images - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def spatial_sampling(
    frames: np.ndarray,
    rng: np.random.Generator,
    spatial_idx: int = -1,
    min_scale: int = 256,
    max_scale: int = 320,
    crop_size: int = 224,
    random_horizontal_flip: bool = True,
    inverse_uniform_sampling: bool = False,
    aspect_ratio=None,
    scale=None,
    boxes: Optional[np.ndarray] = None,
):
    """The single spatial-aug entry point (reference ``utils.py:110-192``).

    frames: [T, H, W, C].  spatial_idx -1 = random train aug, 0/1/2 = the
    deterministic test crops.
    """
    assert spatial_idx in (-1, 0, 1, 2)
    if spatial_idx == -1:
        if aspect_ratio is None and scale is None:
            frames, boxes = random_short_side_scale_jitter(
                frames, min_scale, max_scale, rng, boxes,
                inverse_uniform_sampling,
            )
            frames, boxes = random_crop(frames, crop_size, rng, boxes)
        else:
            frames, boxes = random_resized_crop(
                frames, crop_size, crop_size, rng,
                scale=tuple(scale), ratio=tuple(aspect_ratio), boxes=boxes,
            )
        if random_horizontal_flip:
            frames, boxes = horizontal_flip(0.5, frames, rng, boxes)
    else:
        assert min_scale == max_scale
        frames, boxes = short_side_scale(frames, min_scale, boxes)
        frames, boxes = uniform_crop(frames, crop_size, spatial_idx, boxes)
    return np.ascontiguousarray(frames), boxes
