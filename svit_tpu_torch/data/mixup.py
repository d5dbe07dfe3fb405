"""MixUp / CutMix (counterpart of ``svit_tpu/data/mixup.py``; reference ``slowfast/datasets/mixup.py``, timm semantics).

Host-side numpy implementation producing mixed clips + soft targets.
Disabled in the shipped ssv2 recipe (``configs/ssv2.yaml: MIXUP.ENABLE
false``) but part of the public capability surface.
"""

from __future__ import annotations

import numpy as np


def one_hot(labels, num_classes, on_value=1.0, off_value=0.0):
    out = np.full((len(labels), num_classes), off_value, np.float32)
    out[np.arange(len(labels)), labels] = on_value
    return out


def mixup_target(labels, num_classes, lam, smoothing=0.0):
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = one_hot(labels, num_classes, on, off)
    y2 = one_hot(labels[::-1], num_classes, on, off)
    return y1 * lam + y2 * (1.0 - lam)


def rand_bbox(shape, lam, rng):
    """CutMix box for [..., H, W, C] images."""
    H, W = shape[-3], shape[-2]
    ratio = np.sqrt(1.0 - lam)
    cut_h, cut_w = int(H * ratio), int(W * ratio)
    cy = int(rng.integers(0, H))
    cx = int(rng.integers(0, W))
    y1, y2 = np.clip(cy - cut_h // 2, 0, H), np.clip(cy + cut_h // 2, 0, H)
    x1, x2 = np.clip(cx - cut_w // 2, 0, W), np.clip(cx + cut_w // 2, 0, W)
    return y1, y2, x1, x2


class MixUp:
    def __init__(
        self,
        mixup_alpha: float = 1.0,
        cutmix_alpha: float = 0.0,
        mix_prob: float = 1.0,
        switch_prob: float = 0.5,
        label_smoothing: float = 0.1,
        num_classes: int = 1000,
        rng: np.random.Generator = None,
    ):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.mix_prob = mix_prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.rng = rng or np.random.default_rng()

    def __call__(self, clips: np.ndarray, labels: np.ndarray):
        """clips: [B, T, H, W, C]; labels: [B] int.
        Returns (mixed clips, soft targets [B, num_classes])."""
        rng = self.rng
        lam = 1.0
        use_cutmix = False
        if rng.random() < self.mix_prob:
            if self.mixup_alpha > 0.0 and self.cutmix_alpha > 0.0:
                use_cutmix = rng.random() < self.switch_prob
            elif self.cutmix_alpha > 0.0:
                use_cutmix = True
            alpha = self.cutmix_alpha if use_cutmix else self.mixup_alpha
            lam = float(rng.beta(alpha, alpha))

        if lam != 1.0:
            if use_cutmix:
                y1, y2, x1, x2 = rand_bbox(clips.shape, lam, rng)
                clips = clips.copy()
                clips[..., y1:y2, x1:x2, :] = clips[::-1][..., y1:y2, x1:x2, :]
                lam = 1.0 - (y2 - y1) * (x2 - x1) / (
                    clips.shape[-3] * clips.shape[-2]
                )
            else:
                clips = clips * lam + clips[::-1] * (1.0 - lam)
        targets = mixup_target(labels, self.num_classes, lam, self.label_smoothing)
        return clips.astype(np.float32), targets
