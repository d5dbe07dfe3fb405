"""On-device training augmentation (counterpart of
``svit_tpu/data/device_aug.py``).

With ``TPU.DEVICE_AUG`` the host ships raw uint8 frames at ``TPU.RAW_SIZE``
and the train step augments the batch on the card, inside its CUDA graph
(``engine/steps.py``), as the JAX package does inside its jitted step:

1. a per-clip geometric plan (inception crop, flip, shear, rotation)
   composed into one output -> input 2 x 3 affine, applied by one bilinear
   resample to every frame of the clip;
2. a photometric plan (brightness, contrast, saturation, solarize-add),
   each op gated per clip, the same for every frame of the clip;
3. normalisation, then per-frame random erasing with pixel noise.

The image branch's frames take the same plan, and their boxes go through
the inverse of the affine to normalised cxcywh HAOG targets.

This is plain torch on the card, as the JAX package computes it as plain
XLA ops (no Pallas kernel).  Each random function is split into a draw
(``draw_clip_plans``, from a ``torch.Generator`` or, under data
parallelism, the global batch's draws, ``parallel/mesh.py:GlobalDraws``) and its application given
the draws (``augment_clips``): the draws cannot match ``jax.random``'s
streams, so the tests hand the port the values that JAX drew.  The policy
approximates the host PIL pipeline (``TPU.PARITY_STRICT`` refuses it).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from svit_tpu_torch.parallel.mesh import rand, randn

Draws = Dict[str, torch.Tensor]

# each RandAugment op draws three values: magnitude noise, sign, apply gate
GEOMETRIC_OPS = ("shear_x", "shear_y", "rot")
PHOTOMETRIC_OPS = ("bright", "contrast", "sat")


class DeviceAugConfig(NamedTuple):
    out_size: int = 224
    scale_min: float = 0.08
    scale_max: float = 1.0
    ratio_min: float = 0.75
    ratio_max: float = 4.0 / 3.0
    hflip_prob: float = 0.0          # ssv2: RANDOM_FLIP false
    magnitude: float = 7.0           # RandAugment m
    magnitude_std: float = 0.5
    op_prob: float = 0.5
    re_prob: float = 0.25            # random erasing
    mean: Tuple[float, float, float] = (0.45, 0.45, 0.45)
    std: Tuple[float, float, float] = (0.225, 0.225, 0.225)


def config_from_cfg(cfg) -> DeviceAugConfig:
    scl = cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE or [0.08, 1.0]
    asp = cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE or [0.75, 4.0 / 3.0]
    # the magnitude from the AA string
    mag, mstd = 9.0, 0.5
    for part in cfg.AUG.AA_TYPE.split("-")[1:]:
        if part.startswith("mstd"):
            mstd = float(part[4:])
        elif part.startswith("m") and part[1:].replace(".", "").isdigit():
            mag = float(part[1:])
    return DeviceAugConfig(
        out_size=cfg.DATA.TRAIN_CROP_SIZE,
        scale_min=scl[0], scale_max=scl[1],
        ratio_min=asp[0], ratio_max=asp[1],
        hflip_prob=0.5 if cfg.DATA.RANDOM_FLIP else 0.0,
        magnitude=mag, magnitude_std=mstd,
        re_prob=cfg.AUG.RE_PROB,
        mean=tuple(cfg.DATA.MEAN), std=tuple(cfg.DATA.STD),
    )


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def _uniform(shape, lo, hi, generator, device):
    return lo + (hi - lo) * rand(shape, generator, device)


def _op_draws(out: Draws, name: str, shape, generator, device) -> None:
    out[f"{name}_n"] = randn(shape, generator, device)
    out[f"{name}_sign"] = rand(shape, generator, device)
    out[f"{name}_apply"] = rand(shape, generator, device)


def draw_affine(B: int, cfg: DeviceAugConfig, generator, device) -> Draws:
    """Per clip: the crop's area fraction, log aspect and corner, the three
    geometric ops' draws, the flip's uniform ([B] each)."""
    d: Draws = {
        "area": _uniform((B,), cfg.scale_min, cfg.scale_max, generator,
                         device),
        "log_ratio": _uniform((B,), math.log(cfg.ratio_min),
                              math.log(cfg.ratio_max), generator, device),
        "x": rand((B,), generator, device),
        "y": rand((B,), generator, device),
    }
    for name in GEOMETRIC_OPS:
        _op_draws(d, name, (B,), generator, device)
    d["flip"] = rand((B,), generator, device)
    return d


def draw_photometric(B: int, generator, device) -> Draws:
    """Per clip: the three factor ops' draws, solarize-add's noise and
    gate ([B] each)."""
    d: Draws = {}
    for name in PHOTOMETRIC_OPS:
        _op_draws(d, name, (B,), generator, device)
    d["sol_n"] = randn((B,), generator, device)
    d["sol_apply"] = rand((B,), generator, device)
    return d


def draw_erase(B: int, T: int, S: int, C: int, generator, device) -> Draws:
    """Per frame ([B, T]): the gate, the area fraction, the log aspect and
    the corner; the pixel noise [B, T, S, S, C]."""
    shape = (B, T)
    return {
        "do": rand(shape, generator, device),
        "area": _uniform(shape, 0.02, 1 / 3, generator, device),
        "log_aspect": _uniform(shape, math.log(0.3), math.log(1 / 0.3),
                               generator, device),
        "top": rand(shape, generator, device),
        "left": rand(shape, generator, device),
        "noise": randn((B, T, S, S, C), generator, device),
    }


def draw_clip_plans(B: int, T: int, C: int, cfg: DeviceAugConfig,
                    generator, device) -> Dict[str, Draws]:
    """Every draw of a batch, in the order affine, photometric, erase."""
    return {"affine": draw_affine(B, cfg, generator, device),
            "photometric": draw_photometric(B, generator, device),
            "erase": draw_erase(B, T, cfg.out_size, C, generator, device)}


# ---------------------------------------------------------------------------
# The plan given its draws (JAX's arithmetic, in its order, in f32)
# ---------------------------------------------------------------------------

def _op_value(d: Draws, name: str, cfg: DeviceAugConfig, scale: float):
    """A gated, signed RandAugment magnitude (``device_aug.py:draw``)."""
    mag = (cfg.magnitude + cfg.magnitude_std * d[f"{name}_n"]).clamp(
        0.0, 10.0) / 10.0
    sign = torch.where(d[f"{name}_sign"] > 0.5, 1.0, -1.0)
    v = mag * scale * sign
    return torch.where(d[f"{name}_apply"] <= cfg.op_prob, v,
                       torch.zeros_like(v))


def affine_matrix(d: Draws, H: int, W: int, cfg: DeviceAugConfig):
    """[B, 6]: crop, flip, shear and rotation composed into one map from
    centred output coordinates to input coordinates
    (``_affine_matrix``)."""
    S = cfg.out_size
    area = H * W * d["area"]
    aspect = torch.exp(d["log_ratio"])
    w = torch.sqrt(area * aspect).clamp(8.0, W)
    h = torch.sqrt(area / aspect).clamp(8.0, H)
    x0 = d["x"] * (W - w)
    y0 = d["y"] * (H - h)
    sx, sy = w / S, h / S
    shear_x = _op_value(d, "shear_x", cfg, 0.3)
    shear_y = _op_value(d, "shear_y", cfg, 0.3)
    rot = _op_value(d, "rot", cfg, 30.0) * math.pi / 180.0
    flip = d["flip"] < cfg.hflip_prob
    c, s = torch.cos(rot), torch.sin(rot)
    m00 = c + shear_x * s
    m01 = shear_x * c - s
    m10 = s + shear_y * c
    m11 = c - shear_y * s
    sign = torch.where(flip, -1.0, 1.0)
    return torch.stack([sx * m00 * sign, sx * m01, x0 + w / 2.0,
                        sy * m10 * sign, sy * m11, y0 + h / 2.0], dim=-1)


def warp_clips(frames: torch.Tensor, M: torch.Tensor, out_size: int):
    """Bilinear resample of every frame of each clip through its affine,
    as ``_warp_clip`` computes it: pixel centres at i + 0.5, taps clamped
    to the border, weights clamped to [0, 1].

    frames [B, T, H, W, C] f32; M [B, 6] -> [B, T, S, S, C]."""
    B, T, H, W, C = frames.shape
    S = out_size
    grid = torch.arange(S, dtype=torch.float32, device=frames.device) \
        + 0.5 - S / 2.0
    xs, ys = grid[None, None, :], grid[None, :, None]
    m = [M[:, i, None, None] for i in range(6)]
    gx = m[0] * xs + m[1] * ys + m[2] - 0.5
    gy = m[3] * xs + m[4] * ys + m[5] - 0.5
    x0 = torch.floor(gx).clamp(0, W - 1)
    y0 = torch.floor(gy).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    wx = (gx - x0).clamp(0.0, 1.0).reshape(B, S * S, 1)
    wy = (gy - y0).clamp(0.0, 1.0).reshape(B, S * S, 1)
    # channels of every frame side by side: one gather serves the clip
    flat = frames.permute(0, 2, 3, 1, 4).reshape(B, H * W, T * C)
    rows = torch.arange(B, device=frames.device)[:, None]

    def tap(yi, xi):
        lin = (yi.long() * W + xi.long()).reshape(B, S * S)
        return flat[rows, lin]                      # [B, S * S, T * C]

    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape(B, S, S, T, C).permute(0, 3, 1, 2, 4)


def _factor(d: Draws, name: str, cfg: DeviceAugConfig):
    mag = (cfg.magnitude + cfg.magnitude_std * d[f"{name}_n"]).clamp(
        0.0, 10.0) / 10.0
    f = 1.0 + mag * 0.9 * torch.where(d[f"{name}_sign"] > 0.5, 1.0, -1.0)
    return torch.where(d[f"{name}_apply"] <= cfg.op_prob, f,
                       torch.ones_like(f))


def photometric(clips: torch.Tensor, d: Draws, cfg: DeviceAugConfig):
    """Brightness, contrast (against each frame's mean), saturation
    (against each pixel's gray), solarize-add, then the clip to [0, 1]
    (``_photometric``).  clips [B, T, S, S, C] in [0, 1]."""
    def per_clip(v):
        return v[:, None, None, None, None]

    clips = clips * per_clip(_factor(d, "bright", cfg))
    f = per_clip(_factor(d, "contrast", cfg))
    lum = clips.mean(dim=(-1, -2, -3), keepdim=True)
    clips = lum + (clips - lum) * f
    f = per_clip(_factor(d, "sat", cfg))
    gray = clips.mean(dim=-1, keepdim=True)
    clips = gray + (clips - gray) * f
    amt = per_clip((cfg.magnitude + cfg.magnitude_std * d["sol_n"]).clamp(
        0, 10) / 10.0 * (110.0 / 255.0))
    apply = per_clip(d["sol_apply"] <= cfg.op_prob)
    clips = torch.where(apply & (clips < 0.5),
                        torch.minimum(clips + amt, torch.ones_like(clips)),
                        clips)
    return clips.clamp(0.0, 1.0)


def erase(clips: torch.Tensor, d: Draws, cfg: DeviceAugConfig):
    """Per-frame pixel-noise erasing of one box (``_erase``).  clips [B, T,
    S, S, C] normalised."""
    S = clips.shape[2]
    area = d["area"] * S * S
    aspect = torch.exp(d["log_aspect"])
    h = torch.sqrt(area * aspect).clamp(1, S - 1)
    w = torch.sqrt(area / aspect).clamp(1, S - 1)
    top = d["top"] * (S - h)
    left = d["left"] * (S - w)

    def per_frame(v):
        return v[:, :, None, None]

    yy = torch.arange(S, dtype=torch.float32, device=clips.device)[:, None]
    xx = torch.arange(S, dtype=torch.float32, device=clips.device)[None, :]
    mask = ((yy >= per_frame(top)) & (yy < per_frame(top + h))
            & (xx >= per_frame(left)) & (xx < per_frame(left + w)))
    mask = (mask & per_frame(d["do"] < cfg.re_prob))[..., None]
    return torch.where(mask, d["noise"], clips)


def _per_channel(like, values):
    """[C] f32 on ``like``'s device, made there (no host copy, which a CUDA
    graph's capture refuses from pageable memory)."""
    return torch.stack([like.new_full((), v, dtype=torch.float32)
                        for v in values])


def _normalize(clips, cfg: DeviceAugConfig):
    """``(clips - mean) / std`` as XLA compiles it: times the f32
    reciprocal of the constant."""
    inv = 1.0 / _per_channel(clips, cfg.std)
    return (clips - _per_channel(clips, cfg.mean)) * inv


def _unit(u8):
    """uint8 to [0, 1] as XLA compiles ``x / 255``: times the reciprocal,
    rounded to f32."""
    return u8.float() * (1.0 / 255.0)


def augment_clips(clips_u8: torch.Tensor, draws: Dict[str, Draws],
                  cfg: DeviceAugConfig):
    """uint8 [B, T, H, W, C] -> augmented, normalised f32 [B, T, S, S, C],
    given every draw (``draw_clip_plans``).  Also returns the affines."""
    H, W = clips_u8.shape[2:4]
    clips = _unit(clips_u8)
    M = affine_matrix(draws["affine"], H, W, cfg)
    clips = warp_clips(clips, M, cfg.out_size)
    clips = photometric(clips, draws["photometric"], cfg)
    return erase(_normalize(clips, cfg), draws["erase"], cfg), M


def device_augment(clips_u8: torch.Tensor, generator,
                   cfg: DeviceAugConfig) -> torch.Tensor:
    """uint8 [B, T, H, W, C] -> augmented, normalised f32 [B, T, S, S, C],
    drawn from ``generator`` (``device_augment``)."""
    B, T, _, _, C = clips_u8.shape
    draws = draw_clip_plans(B, T, C, cfg, generator, clips_u8.device)
    return augment_clips(clips_u8, draws, cfg)[0]


# ---------------------------------------------------------------------------
# The image branch: the same plan on the frame and its boxes
# ---------------------------------------------------------------------------

def transform_boxes(M: torch.Tensor, boxes: torch.Tensor, out_size: int):
    """xyxy boxes in input pixels through the inverse of the warp's affine
    into output pixels: the envelope of the 4 corners, clipped to [0, S]
    (``_transform_boxes``).  M [B, 6]; boxes [B, ..., 4]."""
    lead = (M.shape[0],) + (1,) * (boxes.dim() - 2)
    a, b, tx, d, e, ty = (M[:, i].reshape(lead) for i in range(6))
    det = a * e - b * d
    ia, ib = e / det, -b / det
    ic, ie = -d / det, a / det
    half = out_size / 2.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    gx = torch.stack([x1, x2, x1, x2], dim=-1) - tx[..., None]   # corners
    gy = torch.stack([y1, y1, y2, y2], dim=-1) - ty[..., None]
    xo = ia[..., None] * gx + ib[..., None] * gy + half
    yo = ic[..., None] * gx + ie[..., None] * gy + half
    return torch.stack([xo.amin(-1).clamp(0.0, out_size),
                        yo.amin(-1).clamp(0.0, out_size),
                        xo.amax(-1).clamp(0.0, out_size),
                        yo.amax(-1).clamp(0.0, out_size)], dim=-1)


def boxes_to_haog(boxes_xyxy: torch.Tensor, out_size: int,
                  was_zero: torch.Tensor):
    """Normalised cxcywh, degenerate and originally empty boxes zeroed
    (``_boxes_to_haog``)."""
    bn = boxes_xyxy / out_size
    x1, y1, x2, y2 = bn.unbind(-1)
    w, h = x2 - x1, y2 - y1
    cxcywh = torch.stack([(x1 + x2) / 2.0, (y1 + y2) / 2.0, w, h], dim=-1)
    degenerate = (w <= 0.0) | (h <= 0.0) | was_zero
    return torch.where(degenerate[..., None], torch.zeros_like(cxcywh),
                       cxcywh)


def augment_images(frames_u8: torch.Tensor, boxes_xyxy: torch.Tensor,
                   draws: Dict[str, Draws], cfg: DeviceAugConfig):
    """frames uint8 [B, 1, H, W, C], boxes [B, 1, O, 4] in input pixels
    (all-zero rows: no box), given the draws -> (frames f32 [B, 1, S, S,
    C] normalised, haog cxcywh [B, 1, O, 4]).  Erasing comes last and
    moves no box."""
    H, W = frames_u8.shape[2:4]
    img = _unit(frames_u8)
    M = affine_matrix(draws["affine"], H, W, cfg)
    img = photometric(warp_clips(img, M, cfg.out_size),
                      draws["photometric"], cfg)
    was_zero = (boxes_xyxy == 0.0).all(-1)
    haog = boxes_to_haog(transform_boxes(M, boxes_xyxy, cfg.out_size),
                         cfg.out_size, was_zero)
    return erase(_normalize(img, cfg), draws["erase"], cfg), haog


def device_augment_image(frames_u8: torch.Tensor, boxes_xyxy: torch.Tensor,
                         generator, cfg: DeviceAugConfig):
    """The image branch's augmentation with its paired box transform,
    drawn from ``generator`` (``device_augment_image``)."""
    B, T, _, _, C = frames_u8.shape
    draws = draw_clip_plans(B, T, C, cfg, generator, frames_u8.device)
    return augment_images(frames_u8, boxes_xyxy, draws, cfg)
