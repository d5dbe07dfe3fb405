"""Concat wrapper over IMAGE_TRAIN.DATASETS (counterpart of
``svit_tpu/data/multi_images.py``, reference ``multi_images.py``).

Length is multiplied x100 (``doube_image_dataset_length``,
``multi_images.py:32-58``) so the image stream never exhausts before the
video stream within an epoch.
"""

from __future__ import annotations

import numpy as np

from svit_tpu_torch.models.registry import DATASET_REGISTRY

LENGTH_MULTIPLIER = 100


@DATASET_REGISTRY.register("Multi_images")
class Multi_images:
    def __init__(self, cfg, mode: str):
        from svit_tpu_torch.data.build import build_dataset

        self.datasets = [
            build_dataset(name, cfg, mode) for name in cfg.IMAGE_TRAIN.DATASETS
        ]
        self.lengths = [len(d) for d in self.datasets]
        self.offsets = np.cumsum([0] + self.lengths)
        self.base_len = int(self.offsets[-1])
        # the x100 stretch exists so the train image stream outlasts the
        # video stream; a val pass wants each sample exactly once
        self.multiplier = LENGTH_MULTIPLIER if mode == "train" else 1

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __len__(self):
        return self.base_len * self.multiplier

    def __getitem__(self, index: int):
        index = index % self.base_len
        ds_idx = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return self.datasets[ds_idx][index - int(self.offsets[ds_idx])]
