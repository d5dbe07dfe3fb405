"""Kinetics encoded-video dataset (counterpart of
``svit_tpu/data/kinetics.py``, reference ``slowfast/datasets/kinetics.py``).

Used for the K400 pretraining stage.  CSV lines ``path<sep>label`` under
``DATA.PATH_TO_DATA_DIR/{train,val,test}.csv``; decoded by
``data/decoder.py`` (the libav shim, else PyAV) with the reference's
retry-and-resample loop (``kinetics.py:236-276``).  Items are bit-equal to
the JAX package's: the same per-item generator, draws in the same order.
"""

from __future__ import annotations

import os
import random

import numpy as np

from svit_tpu_torch.data import decoder, transform
from svit_tpu_torch.data.rand_augment import rand_augment_transform
from svit_tpu_torch.data.random_erasing import RandomErasing
from svit_tpu_torch.models.registry import DATASET_REGISTRY
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


@DATASET_REGISTRY.register("Kinetics")
class Kinetics:
    def __init__(self, cfg, mode: str, num_retries: int = 10):
        assert mode in ("train", "val", "test"), mode
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        self._num_clips = (
            1
            if mode in ("train", "val")
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        self._rng = np.random.default_rng(cfg.RNG_SEED + 1234)  # decode resample
        self._epoch = 0
        self._construct()
        self.aug = mode == "train" and cfg.AUG.ENABLE
        self.rand_erase = self.aug and cfg.AUG.RE_PROB > 0
        # Repeated augmentation: __getitem__ returns this many samples per
        # item (reference kinetics.py:290-295). The loader reads this to size
        # its padded batches for ANY dataset (reference loader.py:154-156).
        self.samples_per_item = cfg.AUG.NUM_SAMPLE if self.aug else 1

    def _construct(self):
        csv_name = {"train": "train", "val": "val", "test": "test"}[self.mode]
        path_to_file = os.path.join(
            self.cfg.DATA.PATH_TO_DATA_DIR, f"{csv_name}.csv"
        )
        assert os.path.exists(path_to_file), f"{path_to_file} not found"
        self._path_to_videos = []
        self._labels = []
        self._spatial_temporal_idx = []
        with open(path_to_file) as f:
            for clip_idx, line in enumerate(f.read().splitlines()):
                if not line:
                    continue
                parts = line.split(self.cfg.DATA.PATH_LABEL_SEPARATOR)
                assert len(parts) == 2, line
                path, label = parts
                for idx in range(self._num_clips):
                    self._path_to_videos.append(
                        os.path.join(self.cfg.DATA.PATH_PREFIX, path)
                    )
                    self._labels.append(int(label))
                    self._spatial_temporal_idx.append(idx)
        assert len(self._path_to_videos) > 0, f"empty csv {path_to_file}"
        logger.info(
            "Kinetics %s constructed: %d clips", self.mode, len(self._path_to_videos)
        )

    def __len__(self):
        return len(self._path_to_videos)

    @property
    def num_videos(self):
        return len(self._path_to_videos)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _item_rng(self, index: int) -> np.random.Generator:
        mode_id = {"train": 0, "val": 1, "test": 2}[self.mode]
        return np.random.default_rng(
            np.random.SeedSequence(
                [self.cfg.RNG_SEED, 10 + mode_id, self._epoch, index]
            )
        )

    def __getitem__(self, index: int):
        cfg = self.cfg
        item_rng = self._item_rng(index)
        if self.mode in ("train", "val"):
            temporal_idx = -1
            spatial_idx = -1
            min_scale, max_scale = cfg.DATA.TRAIN_JITTER_SCALES
            crop_size = cfg.DATA.TRAIN_CROP_SIZE
        else:
            temporal_idx = (
                self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            )
            spatial_idx = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            )
            if cfg.TEST.NUM_SPATIAL_CROPS == 1:
                spatial_idx = 1
            min_scale = max_scale = crop_size = cfg.DATA.TEST_CROP_SIZE

        # Retry-and-resample loop (reference kinetics.py:236-276).
        for i_try in range(self._num_retries):
            frames = decoder.decode(
                self._path_to_videos[index],
                cfg.DATA.SAMPLING_RATE,
                cfg.DATA.NUM_FRAMES,
                temporal_idx,
                cfg.TEST.NUM_ENSEMBLE_VIEWS,
                target_fps=cfg.DATA.TARGET_FPS,
                backend=cfg.DATA.DECODING_BACKEND,
                use_offset=cfg.DATA.USE_OFFSET_SAMPLING,
                rng=item_rng,
            )
            if frames is not None:
                break
            logger.warning(
                "Failed to decode video idx %d, trial %d", index, i_try
            )
            if self.mode not in ("test",) and i_try > self._num_retries // 2:
                index = int(self._rng.integers(0, len(self)))
        else:
            raise RuntimeError(
                f"Failed to fetch video after {self._num_retries} retries."
            )

        label = self._labels[index]
        if self.aug:
            if cfg.AUG.NUM_SAMPLE > 1:
                # repeated augmentation (reference kinetics.py aug path):
                # several independently-augmented crops of the same clip
                out = []
                for _ in range(cfg.AUG.NUM_SAMPLE):
                    f = self._aug_frames(
                        frames, spatial_idx, min_scale, max_scale, crop_size,
                        item_rng,
                    )
                    out.append((f.astype(np.float32), label, index, {}))
                return out
            frames = self._aug_frames(
                frames, spatial_idx, min_scale, max_scale, crop_size, item_rng
            )
        else:
            frames = transform.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
            frames, _ = transform.spatial_sampling(
                frames, item_rng,
                spatial_idx=spatial_idx,
                min_scale=min_scale, max_scale=max_scale, crop_size=crop_size,
                random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
                inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
            )
        return frames.astype(np.float32), label, index, {}

    def _aug_frames(self, frames, spatial_idx, min_scale, max_scale, crop_size,
                    rng=None):
        from PIL import Image

        cfg = self.cfg
        rng = rng if rng is not None else self._rng
        aug = rand_augment_transform(
            cfg.AUG.AA_TYPE, interpolation=cfg.AUG.INTERPOLATION, rng=rng
        )
        pil = aug([Image.fromarray(f) for f in frames])
        frames = np.stack([np.asarray(f) for f in pil])
        frames = transform.tensor_normalize(frames, cfg.DATA.MEAN, cfg.DATA.STD)
        scl = cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE
        asp = cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE
        frames, _ = transform.spatial_sampling(
            frames, rng,
            spatial_idx=spatial_idx,
            min_scale=min_scale, max_scale=max_scale, crop_size=crop_size,
            random_horizontal_flip=cfg.DATA.RANDOM_FLIP,
            inverse_uniform_sampling=cfg.DATA.INV_UNIFORM_SAMPLE,
            scale=scl if len(scl) else None,
            aspect_ratio=asp if len(asp) else None,
        )
        if self.rand_erase:
            frames = RandomErasing(
                cfg.AUG.RE_PROB, mode=cfg.AUG.RE_MODE,
                min_count=cfg.AUG.RE_COUNT, max_count=cfg.AUG.RE_COUNT, rng=rng,
            )(frames)
        return frames
