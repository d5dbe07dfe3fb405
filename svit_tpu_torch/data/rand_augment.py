"""Box-aware RandAugment for clips (counterpart of
``svit_tpu/data/rand_augment.py``; timm policy semantics).

Capability-parity rebuild of the reference's vendored augment stack
(``slowfast/datasets/rand_augment.py`` + ``datasets/ssv2_MF/
{autoaugment,boxes_autoaugment}.py``): timm config strings
(``rand-m7-n4-mstd0.5-inc1``), the same 15-op policy with increasing-severity
variants, per-clip op sampling replayed identically across all frames of a
clip (the reference's ``_make_det_and_get_state_dict`` replay design), and a
paired box transform for every geometric op.

Design deviation (documented): the reference pairs PIL image ops with an
*imgaug*-based approximation for boxes (shear with fit_output + rescale +
crop, ``boxes_autoaugment.py:33-116``).  Here image and box share one affine
transform exactly — boxes are mapped by the same matrix applied to the pixels
and re-bounded, which is geometrically consistent by construction.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

_LEVEL_DENOM = 10.0
_FILL = (124, 116, 104)

_INTERPOLATIONS = {
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
    "nearest": Image.NEAREST,
}


# ---------------------------------------------------------------------------
# Affine helpers: PIL's Image.transform(AFFINE, M) maps OUTPUT (x,y) to INPUT
# via M; boxes live in input space, so corners map through the inverse of M.
# ---------------------------------------------------------------------------

def _affine_image(img: Image.Image, matrix, interpolation, fill):
    return img.transform(img.size, Image.AFFINE, matrix, interpolation, fillcolor=fill)


def _affine_boxes(boxes: np.ndarray, matrix, size) -> np.ndarray:
    """Map xyxy boxes through the forward affine (inverse of PIL's matrix)."""
    a, b, c, d, e, f = matrix
    # output->input: (xi, yi) = (a xo + b yo + c, d xo + e yo + f)
    # forward (input->output) = inverse matrix
    det = a * e - b * d
    ia, ib, ic = e / det, -b / det, (b * f - c * e) / det
    id_, ie, if_ = -d / det, a / det, (c * d - a * f) / det
    x0, y0, x1, y1 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    xs = np.stack([x0, x1, x0, x1], -1)
    ys = np.stack([y0, y0, y1, y1], -1)
    tx = ia * xs + ib * ys + ic
    ty = id_ * xs + ie * ys + if_
    W, H = size
    out = np.stack(
        [
            np.clip(tx.min(-1), 0, W),
            np.clip(ty.min(-1), 0, H),
            np.clip(tx.max(-1), 0, W),
            np.clip(ty.max(-1), 0, H),
        ],
        axis=-1,
    ).astype(boxes.dtype)
    # degenerate (all-zero) boxes stay zero
    empty = np.all(boxes == 0, axis=-1, keepdims=True)
    return np.where(empty, 0.0, out)


# -- image ops ---------------------------------------------------------------

def _shear_x(img, v, interpolation, fill):
    return _affine_image(img, (1, v, 0, 0, 1, 0), interpolation, fill)


def _shear_y(img, v, interpolation, fill):
    return _affine_image(img, (1, 0, 0, v, 1, 0), interpolation, fill)


def _translate_x_rel(img, v, interpolation, fill):
    return _affine_image(img, (1, 0, v * img.size[0], 0, 1, 0), interpolation, fill)


def _translate_y_rel(img, v, interpolation, fill):
    return _affine_image(img, (1, 0, 0, 0, 1, v * img.size[1]), interpolation, fill)


def _rotate_matrix(degrees, size):
    """PIL-style center rotation as an output->input affine matrix."""
    W, H = size
    angle = -math.radians(degrees)
    cx, cy = W / 2.0, H / 2.0
    cos, sin = math.cos(angle), math.sin(angle)
    a, b = cos, sin
    d, e = -sin, cos
    c = cx - a * cx - b * cy
    f = cy - d * cx - e * cy
    return (a, b, c, d, e, f)


def _rotate(img, v, interpolation, fill):
    return img.rotate(v, resample=interpolation, fillcolor=fill)


# -- pixel (box-identity) ops ------------------------------------------------

def _enhance(factory):
    def fn(img, v, interpolation, fill):
        return factory(img).enhance(v)

    return fn


_PIXEL_OPS = {
    "AutoContrast": lambda img, v, i, f: ImageOps.autocontrast(img),
    "Equalize": lambda img, v, i, f: ImageOps.equalize(img),
    "Invert": lambda img, v, i, f: ImageOps.invert(img),
    "Posterize": lambda img, v, i, f: ImageOps.posterize(img, max(1, int(v))),
    "Solarize": lambda img, v, i, f: ImageOps.solarize(img, int(v)),
    "SolarizeAdd": None,  # special-cased below
    "Color": _enhance(ImageEnhance.Color),
    "Contrast": _enhance(ImageEnhance.Contrast),
    "Brightness": _enhance(ImageEnhance.Brightness),
    "Sharpness": _enhance(ImageEnhance.Sharpness),
}


def _solarize_add(img, add, thresh=128):
    lut = [min(255, i + int(add)) if i < thresh else i for i in range(256)]
    if img.mode in ("L", "RGB"):
        if img.mode == "RGB":
            lut = lut + lut + lut
        return img.point(lut)
    return img


# -- level (magnitude -> arg) maps; timm semantics ---------------------------

def _randomly_negate(v, rng):
    return -v if rng.random() > 0.5 else v


def _level_arg(name: str, level: float, rng) -> Optional[float]:
    frac = level / _LEVEL_DENOM
    if name in ("ShearX", "ShearY"):
        return _randomly_negate(frac * 0.3, rng)
    if name in ("TranslateXRel", "TranslateYRel"):
        return _randomly_negate(frac * 0.45, rng)
    if name == "Rotate":
        return _randomly_negate(frac * 30.0, rng)
    if name == "Posterize":
        return max(1, int(frac * 4))
    if name == "PosterizeIncreasing":
        return max(1, 4 - int(frac * 4))
    if name == "Solarize":
        return min(256, int(frac * 256))
    if name == "SolarizeIncreasing":
        return 256 - min(256, int(frac * 256))
    if name == "SolarizeAdd":
        return min(128, int(frac * 110))
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        return max(0.1, 1.0 + _randomly_negate(frac * 0.9, rng))
    if name in (
        "ColorIncreasing", "ContrastIncreasing",
        "BrightnessIncreasing", "SharpnessIncreasing",
    ):
        return max(0.1, 1.0 + _randomly_negate(frac * 0.9, rng))
    return None  # AutoContrast / Equalize / Invert


_RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]

_RAND_INCREASING_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]

_GEOMETRIC = {"Rotate", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel"}


class RandAugment:
    """Per-clip RandAugment: ops + magnitudes sampled once, replayed on every
    frame (and on the boxes of every frame when ``with_boxes``)."""

    def __init__(
        self,
        config_str: str,
        interpolation: str = "bicubic",
        with_boxes: bool = False,
        img_mean: Tuple[int, int, int] = _FILL,
        rng: Optional[np.random.Generator] = None,
    ):
        m = 10
        n = 2
        mstd = 0.0
        increasing = False
        for part in config_str.split("-")[1:]:
            key = re.match(r"([a-z]+)(.*)", part)
            if not key:
                continue
            name, val = key.group(1), key.group(2)
            if name == "m":
                m = float(val)
            elif name == "n":
                n = int(val)
            elif name == "mstd":
                mstd = float(val)
            elif name == "inc":
                increasing = bool(int(val))
        self.magnitude = m
        self.num_layers = n
        self.magnitude_std = mstd
        self.transforms = (
            _RAND_INCREASING_TRANSFORMS if increasing else _RAND_TRANSFORMS
        )
        self.interpolation = _INTERPOLATIONS[interpolation]
        self.with_boxes = with_boxes
        self.img_mean = tuple(img_mean)
        self.rng = rng or np.random.default_rng()

    def _sample_plan(self):
        """Choose ops/magnitudes/probs once (replayed across the clip)."""
        rng = self.rng
        plan = []
        names = [
            self.transforms[int(i)]
            for i in rng.integers(0, len(self.transforms), self.num_layers)
        ]
        for name in names:
            apply = rng.random() <= 0.5
            level = self.magnitude
            if self.magnitude_std > 0:
                level = rng.normal(self.magnitude, self.magnitude_std)
            level = min(_LEVEL_DENOM, max(0.0, level))
            arg = _level_arg(name, level, rng)
            plan.append((name, apply, arg))
        return plan

    def __call__(
        self, frames: List[Image.Image], boxes: Optional[np.ndarray] = None
    ):
        """frames: list of PIL images; boxes: [T, O, 4] xyxy pixel coords."""
        plan = self._sample_plan()
        size = frames[0].size
        for name, apply, arg in plan:
            if not apply:
                continue
            frames = [self._apply_img(f, name, arg) for f in frames]
            if self.with_boxes and boxes is not None and name in _GEOMETRIC:
                boxes = self._apply_boxes(boxes, name, arg, size)
        if self.with_boxes:
            return frames, boxes
        return frames

    def _apply_img(self, img, name, arg):
        interp, fill = self.interpolation, self.img_mean
        if name == "SolarizeAdd":
            return _solarize_add(img, arg)
        base = name.replace("Increasing", "")
        if base in _PIXEL_OPS and _PIXEL_OPS[base] is not None:
            return _PIXEL_OPS[base](img, arg, interp, fill)
        if name == "ShearX":
            return _shear_x(img, arg, interp, fill)
        if name == "ShearY":
            return _shear_y(img, arg, interp, fill)
        if name == "TranslateXRel":
            return _translate_x_rel(img, arg, interp, fill)
        if name == "TranslateYRel":
            return _translate_y_rel(img, arg, interp, fill)
        if name == "Rotate":
            return _rotate(img, arg, interp, fill)
        raise NotImplementedError(name)

    def _apply_boxes(self, boxes, name, arg, size):
        W, H = size
        if name == "ShearX":
            matrix = (1, arg, 0, 0, 1, 0)
        elif name == "ShearY":
            matrix = (1, 0, 0, arg, 1, 0)
        elif name == "TranslateXRel":
            matrix = (1, 0, arg * W, 0, 1, 0)
        elif name == "TranslateYRel":
            matrix = (1, 0, 0, 0, 1, arg * H)
        elif name == "Rotate":
            matrix = _rotate_matrix(arg, size)
        else:
            return boxes
        return _affine_boxes(boxes, matrix, size)


def rand_augment_transform(config_str, interpolation="bicubic",
                           with_boxes=False, img_mean=_FILL, rng=None):
    assert config_str.startswith("rand"), config_str
    return RandAugment(
        config_str, interpolation=interpolation, with_boxes=with_boxes,
        img_mean=img_mean, rng=rng,
    )
