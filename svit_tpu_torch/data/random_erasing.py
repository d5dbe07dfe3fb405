"""Random erasing (counterpart of ``svit_tpu/data/random_erasing.py``; reference ``slowfast/datasets/random_erasing.py``, timm).

Applied per frame on normalized [T, H, W, C] float frames; 'pixel' mode fills
with unit-normal noise (the shipped ssv2 recipe: RE_PROB 0.25, RE_MODE pixel,
RE_COUNT 1).
"""

from __future__ import annotations

import math

import numpy as np


class RandomErasing:
    def __init__(
        self,
        probability: float = 0.5,
        min_area: float = 0.02,
        max_area: float = 1 / 3,
        min_aspect: float = 0.3,
        max_aspect=None,
        mode: str = "const",
        min_count: int = 1,
        max_count=None,
        rng: np.random.Generator = None,
    ):
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect = (math.log(min_aspect), math.log(max_aspect))
        self.min_count = min_count
        self.max_count = max_count or min_count
        assert mode in ("const", "rand", "pixel")
        self.mode = mode
        self.rng = rng or np.random.default_rng()

    def _erase_one(self, frame: np.ndarray):
        H, W, C = frame.shape
        area = H * W
        count = (
            self.min_count
            if self.min_count == self.max_count
            else int(self.rng.integers(self.min_count, self.max_count + 1))
        )
        for _ in range(count):
            for _ in range(10):
                target_area = self.rng.uniform(self.min_area, self.max_area) * area / count
                aspect = math.exp(self.rng.uniform(*self.log_aspect))
                h = int(round(math.sqrt(target_area * aspect)))
                w = int(round(math.sqrt(target_area / aspect)))
                if w < W and h < H:
                    top = int(self.rng.integers(0, H - h + 1))
                    left = int(self.rng.integers(0, W - w + 1))
                    if self.mode == "pixel":
                        frame[top : top + h, left : left + w] = self.rng.normal(
                            size=(h, w, C)
                        ).astype(frame.dtype)
                    elif self.mode == "rand":
                        frame[top : top + h, left : left + w] = self.rng.normal(
                            size=(1, 1, C)
                        ).astype(frame.dtype)
                    else:
                        frame[top : top + h, left : left + w] = 0
                    break
        return frame

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """frames: [T, H, W, C] normalized floats; erases independently per frame."""
        out = frames.copy()
        for t in range(out.shape[0]):
            if self.rng.random() < self.probability:
                out[t] = self._erase_one(out[t])
        return out
