"""TensorBoard writer (counterpart of
``svit_tpu/visualization/tensorboard_vis.py``, reference
``slowfast/visualization/tensorboard_vis.py``).

Scalars, confusion matrices, per-class histograms, weight and activation
histograms and video tensors, gated by the ``TENSORBOARD.*`` config block.
The confusion matrix's figure needs matplotlib, imported when it is drawn.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def get_class_names(path: str, subset_path: str = ""):
    """Load class names json + optional subset list (reference vis utils)."""
    import json

    class_names = None
    subset_ids = None
    if path:
        with open(path) as f:
            mapping = json.load(f)
        class_names = [None] * len(mapping)
        for name, idx in mapping.items():
            class_names[int(idx)] = name
    if subset_path:
        with open(subset_path) as f:
            subset = f.read().split("\n")
        subset_ids = [
            int(mapping[name]) for name in subset if name in (mapping or {})
        ]
    return class_names, subset_ids


class TensorboardWriter:
    def __init__(self, cfg):
        self.cfg = cfg
        log_dir = cfg.TENSORBOARD.LOG_DIR or os.path.join(
            cfg.OUTPUT_DIR, f"runs-{cfg.TRAIN.DATASET}"
        )
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir)
        logger.info("TensorBoard events at %s", log_dir)
        self.class_names = None
        if cfg.TENSORBOARD.CLASS_NAMES_PATH:
            self.class_names, _ = get_class_names(cfg.TENSORBOARD.CLASS_NAMES_PATH)

    def add_scalars(self, data_dict: Dict[str, float], global_step: Optional[int] = None):
        for key, item in data_dict.items():
            if isinstance(item, (int, float, np.floating, np.integer)):
                self.writer.add_scalar(key, item, global_step)

    def add_confusion_matrix(self, preds, labels, tag="Confusion Matrix",
                             num_classes=None, global_step=None):
        if not self.cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE:
            return
        num_classes = num_classes or self.cfg.MODEL.NUM_CLASSES
        cmtx = confusion_matrix(preds, labels, num_classes)
        fig = plot_confusion_matrix(
            cmtx, num_classes, self.class_names,
            figsize=self.cfg.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE,
        )
        self.writer.add_figure(tag=tag, figure=fig, global_step=global_step)

    def add_histogram(self, tag, values, global_step=None):
        self.writer.add_histogram(tag, _numpy(values), global_step)

    def add_video(self, vid_tensor, tag="Video Input", global_step=None, fps=4):
        """vid_tensor: [B, T, H, W, C] uint8 -> torch [B,T,C,H,W].

        tensorboard's video summary needs moviepy; falls back to per-frame
        image summaries when it's unavailable.
        """
        arr = np.asarray(vid_tensor)
        try:
            import moviepy  # noqa: F401

            v = torch.from_numpy(arr).permute(0, 1, 4, 2, 3)
            self.writer.add_video(tag, v, global_step=global_step, fps=fps)
        except ImportError:
            for t in range(min(arr.shape[1], 8)):
                self.writer.add_image(
                    f"{tag}/frame_{t}",
                    arr[0, t],
                    global_step=global_step,
                    dataformats="HWC",
                )

    def plot_weights_and_activations(self, tensors, tag="", global_step=None):
        """A histogram of every tensor of a nest of dicts (a state dict,
        the captured block outputs), named by its keys joined with "/"."""
        for name, t in _flat(tensors):
            self.add_histogram(f"{tag}{name}", _numpy(t), global_step)

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.flush()
        self.writer.close()


def _numpy(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def confusion_matrix(preds: np.ndarray, labels: np.ndarray, num_classes: int):
    cmtx = np.zeros((num_classes, num_classes), np.int64)
    pred_ids = np.asarray(preds).argmax(-1)
    for p, l in zip(pred_ids, np.asarray(labels)):
        cmtx[int(l), int(p)] += 1
    return cmtx


def plot_confusion_matrix(cmtx, num_classes, class_names=None, figsize=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if class_names is None or not isinstance(class_names, list):
        class_names = [str(i) for i in range(num_classes)]
    figure = plt.figure(figsize=figsize)
    plt.imshow(cmtx, interpolation="nearest", cmap=plt.cm.Blues)
    plt.title("Confusion matrix")
    plt.colorbar()
    tick_marks = np.arange(len(class_names))
    plt.xticks(tick_marks, class_names, rotation=45, fontsize=6)
    plt.yticks(tick_marks, class_names, fontsize=6)
    threshold = cmtx.max() / 2.0 if cmtx.max() > 0 else 0.5
    for i in range(cmtx.shape[0]):
        for j in range(cmtx.shape[1]):
            color = "white" if cmtx[i, j] > threshold else "black"
            plt.text(
                j, i, format(cmtx[i, j], "d") if cmtx[i, j] != 0 else ".",
                horizontalalignment="center", color=color, fontsize=6,
            )
    plt.tight_layout()
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    return figure
