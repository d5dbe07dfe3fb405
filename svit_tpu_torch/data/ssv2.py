"""Something-Something v2 video dataset (counterpart of
``svit_tpu/data/ssv2.py``, reference ``slowfast/datasets/ssv2.py``).

Frame-dir layout (identical to the reference's expectations):

- ``SSV2.DATA_ROOT/sm/annotations/something-something-v2-labels.json``
  (standard split: template -> class-id map)
- ``DATA_ROOT/json_files/something-something-v2-{train,validation}.json``
  (list of ``{"id", "template"}``)
- ``data/ssv2/empty_bbox_{train,val}.json`` (repo-relative skip list)
- ``DATA_ROOT/bbox_jsons/{int(vid)}.json`` — the box-tracking files; their
  frame entries define the *usable* frames of each video
  (``ssv2.py:447-473``)
- ``DATA_ROOT/frames/{vid}/%04d.jpg``

Test mode pre-replicates each video x(views*crops) with a spatial/temporal
index (``ssv2.py:182-204``); val takes the train-mode random crop at
spatial index -1, as the reference does; output is channels-last
``[T, H, W, C]`` float32.  Train mode with ``AUG.ENABLE`` applies per-clip
RandAugment, the random-resized crop and random erasing, drawn from the
item's generator in the JAX package's order.  With ``TPU.DEVICE_AUG`` train
mode is raw: uint8 frames short-side scaled and centre-cropped to
``TPU.RAW_SIZE``, augmented on the card inside the train step
(``data/device_aug.py``).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
from PIL import Image

from svit_tpu_torch.data import transform, utils as dutils
from svit_tpu_torch.data.rand_augment import rand_augment_transform
from svit_tpu_torch.data.random_erasing import RandomErasing
from svit_tpu_torch.models.registry import DATASET_REGISTRY
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


@DATASET_REGISTRY.register("Ssv2")
class Ssv2:
    def __init__(self, cfg, mode: str, num_retries: int = 10):
        assert mode in ("train", "val", "test"), mode
        self.cfg = cfg
        self.mode = mode
        self.data_root = cfg.SSV2.DATA_ROOT
        assert os.path.isdir(self.data_root), f"{self.data_root} does not exist"
        self._num_retries = num_retries
        self._num_clips = (
            1
            if mode in ("train", "val")
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        self._construct()
        self.aug = mode == "train" and cfg.AUG.ENABLE
        self.rand_erase = self.aug and cfg.AUG.RE_PROB > 0
        # raw mode (TPU.DEVICE_AUG): the augmentation runs on the card
        self.raw_mode = mode == "train" and cfg.TPU.DEVICE_AUG
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _item_rng(self, index: int) -> np.random.Generator:
        """Per-item generator seeded by (seed, mode, epoch, index): the
        augmentation stream is reproducible regardless of worker scheduling
        (a shared stream would depend on thread interleaving)."""
        mode_id = {"train": 0, "val": 1, "test": 2}[self.mode]
        return np.random.default_rng(
            np.random.SeedSequence(
                [self.cfg.RNG_SEED, mode_id, self._epoch, index]
            )
        )

    # -- label / split files -------------------------------------------------
    def _split_files(self):
        split = self.cfg.SSV2.SPLIT
        root = self.data_root
        ds = "train" if self.mode == "train" else "validation"
        if split == "standard":
            labels = f"{root}/sm/annotations/something-something-v2-labels.json"
            label_file = f"{root}/json_files/something-something-v2-{ds}.json"
        elif split == "compositional":
            labels = "data/ssv2/dataset_splits/compositional/labels.json"
            label_file = f"data/ssv2/dataset_splits/compositional/{'train' if self.mode == 'train' else 'validation'}.json"
        elif split.startswith("fewshot"):
            base = "data/ssv2/dataset_splits/fewshot"
            if split == "fewshot-base":
                labels = f"{base}/base_labels.json"
                label_file = f"{base}/base_{'training' if self.mode == 'train' else 'validation'}_set.json"
            else:
                shots = split.split("-")[1].replace("finetune", "")
                labels = f"{base}/finetune_labels.json"
                label_file = f"{base}/finetune_{shots}shot_{'training' if self.mode == 'train' else 'validation'}.json"
        else:
            raise NotImplementedError(f"split = {split}")
        return labels, label_file

    def _construct(self):
        labels_path, label_file = self._split_files()
        with open(labels_path) as f:
            label_dict = json.load(f)
        with open(label_file) as f:
            label_json = json.load(f)

        skip_file = "data/ssv2/empty_bbox_{}.json".format(
            "train" if self.mode == "train" else "val"
        )
        sort_out = set()
        if os.path.isfile(skip_file):
            with open(skip_file) as f:
                sort_out = set(json.load(f))

        names, labels = [], []
        for video in label_json:
            vid = str(video["id"])
            if vid in sort_out:
                continue
            template = video["template"].replace("[", "").replace("]", "")
            names.append(vid)
            labels.append(int(label_dict[template]))

        self._video_names = [v for v in names for _ in range(self._num_clips)]
        self._labels = [l for l in labels for _ in range(self._num_clips)]
        self._spatial_temporal_idx = [
            i for _ in names for i in range(self._num_clips)
        ]
        logger.info(
            "Ssv2 %s constructed: %d clips (%d videos)",
            self.mode, len(self._video_names), len(names),
        )

    def __len__(self):
        return len(self._video_names)

    @property
    def num_videos(self):
        return len(self._video_names)

    # -- frame selection -----------------------------------------------------
    def _frames_list(self, index: int, rng) -> List[str]:
        vid = self._video_names[index]
        json_path = os.path.join(
            self.data_root, "bbox_jsons", f"{int(vid)}.json"
        )
        with open(json_path) as f:
            video_data = json.load(f)
        n_frame = len(video_data)
        idxs = dutils.sample_seq_frames(
            n_frame, self.cfg.DATA.NUM_FRAMES, self.mode, rng
        )
        paths = []
        for fi in idxs:
            entry = video_data[fi] if fi < n_frame else {"labels": []}
            frame_no = int(entry["name"].split("/")[-1][:-4]) - 1
            paths.append(dutils.frame_path(self.data_root, vid, frame_no))
        return paths

    # -- item ---------------------------------------------------------------
    def __getitem__(self, index: int):
        rng = self._item_rng(index)
        cfg = self.cfg
        if self.mode in ("train", "val"):
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            spatial_idx = self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            if cfg.TEST.NUM_SPATIAL_CROPS == 1:
                spatial_idx = 1
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE

        label = self._labels[index]
        fpaths = self._frames_list(index, rng)
        frames = dutils.retry_load_images(fpaths, self._num_retries)  # [T,H,W,C] u8

        if self.raw_mode:
            raw = cfg.TPU.RAW_SIZE
            frames, _ = transform.short_side_scale(
                frames.astype(np.float32), raw)
            frames, _ = transform.uniform_crop(frames, raw, 1)
            return (np.clip(np.round(frames), 0, 255).astype(np.uint8),
                    label, index, {})

        if self.aug:
            frames = self._aug_frames(
                frames, spatial_idx, min_scale, max_scale, crop_size, rng
            )
        else:
            frames = transform.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
            frames, _ = transform.spatial_sampling(
                frames, rng,
                spatial_idx=spatial_idx,
                min_scale=min_scale, max_scale=max_scale, crop_size=crop_size,
                random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
                inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
            )
        return frames.astype(np.float32), label, index, {}

    def _aug_frames(self, frames, spatial_idx, min_scale, max_scale, crop_size, rng):
        cfg = self.cfg
        aug = rand_augment_transform(
            cfg.AUG.AA_TYPE,
            interpolation=cfg.AUG.INTERPOLATION,
            with_boxes=False,
            rng=rng,
        )
        pil_frames = [Image.fromarray(f) for f in frames]
        pil_frames = aug(pil_frames)
        frames = np.stack([np.asarray(f) for f in pil_frames], axis=0)

        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
        scl = cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE
        asp = cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE
        frames, _ = transform.spatial_sampling(
            frames, rng,
            spatial_idx=spatial_idx,
            min_scale=min_scale, max_scale=max_scale, crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
            scale=scl if (self.mode == "train" and len(scl)) else None,
            aspect_ratio=asp if (self.mode == "train" and len(asp)) else None,
        )
        if self.rand_erase:
            erase = RandomErasing(
                cfg.AUG.RE_PROB, mode=cfg.AUG.RE_MODE,
                min_count=cfg.AUG.RE_COUNT, max_count=cfg.AUG.RE_COUNT,
                rng=rng,
            )
            frames = erase(frames)
        return frames
