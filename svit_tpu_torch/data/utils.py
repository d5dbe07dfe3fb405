"""Data-layer helpers (counterpart of ``svit_tpu/data/utils.py``, reference
``slowfast/datasets/utils.py``)."""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np
from PIL import Image

from svit_tpu_torch.native import jpeg as native_jpeg
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def load_image(path: str) -> np.ndarray:
    """Decode one JPEG to uint8 RGB [H, W, C].

    Prefers the port's native decoder (``svit_tpu_torch/native``) when it
    builds; falls back to PIL.  (The reference uses cv2 BGR + a flip back to RGB,
    ``datasets/utils.py:20-48`` — net effect is RGB, same as here.)
    """
    arr = native_jpeg.decode_file(path)
    if arr is not None:
        return arr
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def retry_load_images(paths: List[str], retry: int = 10) -> np.ndarray:
    """Load images with retry (reference ``utils.py:20-48``): transient FS
    failures back off and retry before raising.

    The whole frame list goes through the native libjpeg batch decoder when
    built (one ctypes call, GIL released, decodes on native threads:
    ``svit_tpu_torch/native/decode.cc``); failed entries fall back to PIL."""
    for i in range(retry):
        try:
            imgs = _load_images_batch(paths)
            return np.stack(imgs, axis=0)
        except Exception:
            if i == retry - 1:
                raise
            logger.warning("Reading failed. Will retry: %s", paths[:1])
            time.sleep(1.0)


def _load_images_batch(paths: List[str]) -> List[np.ndarray]:
    decoded = native_jpeg.decode_batch(list(paths))
    if decoded is None:
        return [load_image(p) for p in paths]
    return [
        img if img is not None else load_image(p)
        for p, img in zip(paths, decoded)
    ]


def sample_seq_frames(
    video_length: int, num_frames: int, mode: str, rng: np.random.Generator
) -> List[int]:
    """Segment-based temporal sampling (reference ``ssv2.py:212-232``):
    T equal segments; random index within each (train) or midpoint (val/test)."""
    seg_size = float(video_length - 1) / num_frames
    seq = []
    for i in range(num_frames):
        start = int(np.round(seg_size * i))
        end = int(np.round(seg_size * (i + 1)))
        if mode == "train":
            seq.append(int(rng.integers(start, end + 1)))
        else:
            seq.append((start + end) // 2)
    return seq


def frame_path(data_root: str, vid_name: str, frame_idx: int) -> str:
    """``{root}/frames/{vid}/%04d.jpg`` 1-based (reference ``ssv2.py:436-444``)."""
    return os.path.join(data_root, "frames", vid_name, "%04d.jpg" % (frame_idx + 1))
