"""SSv2 single-frame image-rank dataset with HAOG boxes (counterpart of
``svit_tpu/data/ssv2_frames.py``, reference ``slowfast/datasets/ssv2_frames.py``).

Samples one random frame per video, loads its 4 HAOG boxes from
``bbox_jsons`` (slots: hand1, hand2, obj1, obj2 — ``ssv2_frames.py:474-529``),
runs box-aware RandAugment + box-aware spatial sampling, normalizes boxes to
cxcywh in [0,1], zeroes degenerate ones, and derives per-hand contact state
via center-distance matching (``utils/box_ops.py:140-194``).

Returns ``(frames [1,H,W,C] f32, label=-1, index,
metadata{haog_bboxes [1,O,4], contact_state [2], vid, label_idx})``.  With
``TPU.DEVICE_AUG`` train mode is raw: a uint8 frame at ``TPU.RAW_SIZE`` and
xyxy boxes in its pixels, for ``data/device_aug.py:device_augment_image``.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from svit_tpu_torch.data import transform, utils as dutils
from svit_tpu_torch.data.rand_augment import rand_augment_transform
from svit_tpu_torch.data.random_erasing import RandomErasing
from svit_tpu_torch.data.ssv2 import Ssv2
from svit_tpu_torch.models.registry import DATASET_REGISTRY
from svit_tpu_torch.ops import box_ops
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def _xyxy_to_cxcywh_np(b):
    out = np.empty_like(b)
    out[..., 0] = (b[..., 0] + b[..., 2]) / 2
    out[..., 1] = (b[..., 1] + b[..., 3]) / 2
    out[..., 2] = b[..., 2] - b[..., 0]
    out[..., 3] = b[..., 3] - b[..., 1]
    return out


def zero_empty_boxes_np(boxes, eps: float = 0.05):
    """cxcywh boxes with w or h <= eps are zeroed (reference box_ops:116-130)."""
    wh = boxes[..., 2:4]
    empty = np.any(wh <= eps, axis=-1, keepdims=True)
    return np.where(empty, 0.0, boxes).astype(np.float32)


@DATASET_REGISTRY.register("Ssv2_frames")
class Ssv2_frames(Ssv2):
    """Shares split construction with Ssv2; overrides sampling + item."""

    def _get_boxes(self, index: int, rng):
        vid = self._video_names[index]
        json_path = os.path.join(self.data_root, "bbox_jsons", f"{int(vid)}.json")
        with open(json_path) as f:
            video_data = json.load(f)
        n_frame = len(video_data)
        fi = int(rng.integers(0, n_frame))
        entry = video_data[fi] if fi < n_frame else {"labels": []}

        frame_no = int(entry["name"].split("/")[-1][:-4]) - 1
        fpath = dutils.frame_path(self.data_root, vid, frame_no)

        O = self.cfg.SVIT.O
        boxes = np.zeros((1, O, 4), np.float32)
        inds = {"hand": 0, "obj": 0}
        offsets = {"hand": 0, "obj": 2}
        for box_data in entry.get("labels", []):
            cat = "hand" if box_data["standard_category"] == "hand" else "obj"
            if inds[cat] > 1:
                continue
            slot = inds[cat] + offsets[cat]
            inds[cat] += 1
            bc = box_data["box2d"]
            boxes[0, slot] = [bc["x1"], bc["y1"], bc["x2"], bc["y2"]]

        matched, contact_state = box_ops.match_haog(boxes[0])
        return [fpath], matched[None], contact_state

    def __getitem__(self, index: int):
        rng = self._item_rng(index)
        cfg = self.cfg
        if self.mode in ("train", "val"):
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            spatial_idx = self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE

        fpaths, boxes, contact_state = self._get_boxes(index, rng)
        frames = dutils.retry_load_images(fpaths, self._num_retries)  # [1,H,W,C]

        if self.mode == "train" and cfg.TPU.DEVICE_AUG:
            # raw mode: a uint8 frame at TPU.RAW_SIZE and its boxes in
            # pixels; the box-aware augmentation runs on the card
            # (data/device_aug.py:device_augment_image).  The contact states
            # were matched from the boxes before it, as on the host path.
            raw = cfg.TPU.RAW_SIZE
            flat = boxes.reshape(-1, 4)
            frames, flat = transform.short_side_scale(
                frames.astype(np.float32), raw, boxes=flat)
            frames, flat = transform.uniform_crop(frames, raw, 1, boxes=flat)
            metadata = {
                "haog_bboxes": flat.reshape(boxes.shape).astype(np.float32),
                "contact_state": np.asarray(contact_state, np.int64),
                "vid": self._video_names[index],
                "label_idx": 0,
            }
            return (np.clip(np.round(frames), 0, 255).astype(np.uint8),
                    -1, index, metadata)

        if self.aug:
            frames, boxes = self._aug_frames_boxes(
                frames, boxes, spatial_idx, min_scale, max_scale, crop_size, rng
            )
        else:
            frames = transform.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
            frames, flat = transform.spatial_sampling(
                frames, rng,
                spatial_idx=spatial_idx,
                min_scale=min_scale, max_scale=max_scale, crop_size=crop_size,
                random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
                inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
                boxes=boxes.reshape(-1, 4),
            )
            boxes = flat.reshape(boxes.shape)

        h, w = frames.shape[1:3]
        boxes[..., [0, 2]] /= w
        boxes[..., [1, 3]] /= h
        boxes = np.clip(boxes, 0, 1)
        boxes = zero_empty_boxes_np(_xyxy_to_cxcywh_np(boxes))

        metadata = {
            "haog_bboxes": boxes.astype(np.float32),          # [1, O, 4] cxcywh
            "contact_state": np.asarray(contact_state, np.int64),
            "vid": self._video_names[index],
            "label_idx": 0,
        }
        return frames.astype(np.float32), -1, index, metadata

    def _aug_frames_boxes(
        self, frames, boxes, spatial_idx, min_scale, max_scale, crop_size, rng
    ):
        cfg = self.cfg
        aug = rand_augment_transform(
            cfg.AUG.AA_TYPE,
            interpolation=cfg.AUG.INTERPOLATION,
            with_boxes=True,
            rng=rng,
        )
        pil_frames = [Image.fromarray(f) for f in frames]
        pil_frames, boxes = aug(pil_frames, boxes=boxes)
        frames = np.stack([np.asarray(f) for f in pil_frames], axis=0)

        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
        scl = cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE
        asp = cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE
        orig_shape = boxes.shape
        frames, flat = transform.spatial_sampling(
            frames, rng,
            spatial_idx=spatial_idx,
            min_scale=min_scale, max_scale=max_scale, crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
            scale=scl if (self.mode == "train" and len(scl)) else None,
            aspect_ratio=asp if (self.mode == "train" and len(asp)) else None,
            boxes=boxes.reshape(-1, 4),
        )
        boxes = flat.reshape(orig_shape)
        if self.rand_erase:
            erase = RandomErasing(
                cfg.AUG.RE_PROB, mode=cfg.AUG.RE_MODE,
                min_count=cfg.AUG.RE_COUNT, max_count=cfg.AUG.RE_COUNT,
                rng=rng,
            )
            frames = erase(frames)
        return frames, boxes
