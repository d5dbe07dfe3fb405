"""100DOH single-frame dataset (counterpart of ``svit_tpu/data/doh_frames.py``,
reference ``slowfast/datasets/doh_frames.py``).

Layout:
- ``DOH.DATA_ROOT/file/{train,val}.json``: {frame_relpath: [hand annots]} with
  normalized xyxy boxes, real 5-way ``contact_state`` labels, ``hand_side``
  and optional ``obj_bbox`` per hand;
- images at ``DATA_ROOT/raw_256/{relpath}``.

Box slot order: [right hand, left hand, right-hand object, left-hand object]
(``doh_frames.py:446-476``).  Bad samples are quarantined and resampled
(``doh_frames.py:172-183``).
"""

from __future__ import annotations

import json
import os
import traceback

import numpy as np

from svit_tpu_torch.data.ssv2_frames import Ssv2_frames, _xyxy_to_cxcywh_np, zero_empty_boxes_np
from svit_tpu_torch.data import transform, utils as dutils
from svit_tpu_torch.models.registry import DATASET_REGISTRY
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

_EMPTY = {"x1": 0, "y1": 0, "x2": 0, "y2": 0, "obj_bbox": None, "contact_state": -1}

LABEL_NAMES = [
    "boardgame", "diy", "drink", "food", "furniture", "gardening",
    "housework", "packing", "puzzle", "repair", "study", "vlog",
]


@DATASET_REGISTRY.register("Doh_frames")
class Doh_frames(Ssv2_frames):
    def __init__(self, cfg, mode: str, num_retries: int = 10):
        assert mode in ("train", "val", "test"), mode
        self.cfg = cfg
        self.mode = mode
        self.dprefix = cfg.DOH.DATA_ROOT
        self.data_root = os.path.join(self.dprefix, "raw_256")
        self._num_retries = num_retries
        self._num_clips = (
            1 if mode in ("train", "val")
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        self._construct()
        self.aug = mode == "train" and cfg.AUG.ENABLE
        self.rand_erase = self.aug and cfg.AUG.RE_PROB > 0
        self._epoch = 0
        self._rng = np.random.default_rng(cfg.RNG_SEED + 77)  # resample only
        self.bad_idxs = set()
        self.label_names_idx = {k: i for i, k in enumerate(LABEL_NAMES)}

    def _construct(self):
        _mode = "val" if self.mode == "test" else self.mode
        path = os.path.join(self.dprefix, "file", f"{_mode}.json")
        with open(path) as f:
            label_json = json.load(f)
        names, labels = [], []
        for frame_name, annots in label_json.items():
            names.append(frame_name)
            labels.append(annots)
        self._video_names = [v for v in names for _ in range(self._num_clips)]
        self._annots = [l for l in labels for _ in range(self._num_clips)]
        self._spatial_temporal_idx = [
            i for _ in names for i in range(self._num_clips)
        ]
        logger.info("100DOH %s constructed: %d frames", self.mode, len(names))

    def __len__(self):
        return len(self._video_names)

    def _get_boxes_doh(self, index: int):
        annots = self._annots[index]
        rh = next((v for v in annots if v["hand_side"] == "r"), _EMPTY)
        lh = next((v for v in annots if v["hand_side"] == "l"), _EMPTY)

        def box(d):
            return [d["x1"], d["y1"], d["x2"], d["y2"]]

        def obj_box(d):
            o = d.get("obj_bbox")
            return [o["x1"], o["y1"], o["x2"], o["y2"]] if o else [0, 0, 0, 0]

        boxes = np.asarray(
            [box(rh), box(lh), obj_box(rh), obj_box(lh)], np.float32
        )[None]  # [1, 4, 4] normalized xyxy
        contact = np.asarray(
            [rh["contact_state"], lh["contact_state"]], np.int64
        )
        return boxes, contact

    def __getitem__(self, index: int):
        idx = index
        for _ in range(len(self) + 1):
            while idx in self.bad_idxs:
                idx = int(self._rng.integers(0, len(self)))
            try:
                return self._getitem(idx)
            except Exception:
                logger.warning("bad DOH sample %d:\n%s", idx, traceback.format_exc())
                self.bad_idxs.add(idx)
                idx = int(self._rng.integers(0, len(self)))
        raise RuntimeError("all DOH samples failed to load")

    def _getitem(self, index: int):
        rng = self._item_rng(index)
        cfg = self.cfg
        if self.mode in ("train", "val"):
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            spatial_idx = self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE

        boxes, contact_state = self._get_boxes_doh(index)
        fpath = os.path.join(self.data_root, self._video_names[index])
        frames = dutils.retry_load_images([fpath], self._num_retries)

        # un-normalize to pixel xyxy for the shared transform pipeline
        H, W = frames.shape[1:3]
        boxes = boxes * np.asarray([W, H, W, H], np.float32)

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

        frame_name = self._video_names[index]
        metadata = {
            "haog_bboxes": boxes.astype(np.float32),
            "contact_state": contact_state,
            "vid": frame_name,
            "label_idx": self.label_names_idx[frame_name.split("/")[1]],
        }
        return frames.astype(np.float32), -1, index, metadata
