"""Offline model visualization (counterpart of
``svit_tpu/visualization/run.py``, reference ``tools/visualization.py``):
weight and activation histograms, Grad-CAM videos and a gallery of wrong
predictions in TensorBoard, gated by ``TENSORBOARD.MODEL_VIS`` and
``TENSORBOARD.WRONG_PRED_VIS``.  The activations are the blocks' grid
outputs (``SViT.forward(capture_gradcam=True)``), where the JAX package
histograms every module's intermediates.

    python -m svit_tpu_torch.tools.visualization --cfg configs/ssv2.yaml \\
        TENSORBOARD.ENABLE True TENSORBOARD.MODEL_VIS.ENABLE True

runs on the card, and raises without one.  Under a mesh
(``parallel/mesh.py``) every rank runs its share of the test batches (the
model's collectives need them all), and the master writes: the wrong
predictions of every rank are gathered to it.
"""

from __future__ import annotations

import numpy as np
import torch

from svit_tpu_torch.data.loader import construct_loader
from svit_tpu_torch.models import build_model
from svit_tpu_torch.parallel import dist as du
from svit_tpu_torch.parallel import mesh as meshlib
from svit_tpu_torch.utils import checkpoint as cu
from svit_tpu_torch.utils import logging
from svit_tpu_torch.visualization.gradcam import GradCAM
from svit_tpu_torch.visualization.tensorboard_vis import TensorboardWriter

logger = logging.get_logger(__name__)


def run_visualization(cfg, model, loader, writer, mesh=None):
    """Weights, Grad-CAM and activations of the first three test batches."""
    vis_cfg = cfg.TENSORBOARD.MODEL_VIS
    device = next(model.parameters()).device

    if vis_cfg.MODEL_WEIGHTS:
        writer.plot_weights_and_activations(
            meshlib.full_state_dict(model, mesh or meshlib.Mesh(1, 1)),
            tag="weights/")

    gradcam = None
    if vis_cfg.GRAD_CAM.ENABLE:
        layer = (vis_cfg.GRAD_CAM.LAYER_LIST[0]
                 if vis_cfg.GRAD_CAM.LAYER_LIST else None)
        gradcam = GradCAM(model, target_layer=layer, data_mean=cfg.DATA.MEAN,
                          data_std=cfg.DATA.STD,
                          colormap=vis_cfg.GRAD_CAM.COLORMAP)

    global_idx = -1
    for cur_iter, batch in enumerate(loader):
        clips = torch.from_numpy(batch["clips"]).to(device)
        if gradcam is not None:
            labels = (torch.from_numpy(batch["labels"]).to(device)
                      if vis_cfg.GRAD_CAM.USE_TRUE_LABEL else None)
            videos, _ = gradcam(clips, labels)
            if vis_cfg.INPUT_VIDEO:
                global_idx += 1
                writer.add_video(videos, tag="Input/GradCAM",
                                 global_step=global_idx)
        if vis_cfg.ACTIVATIONS:
            with torch.no_grad():
                _, extra = model(clips, capture_gradcam=True)
            writer.plot_weights_and_activations(
                extra["intermediates"], tag=f"activations/iter{cur_iter}/")
        if cur_iter >= 2:  # a bounded pass
            break


class WrongPredictionVis:
    """Gallery of misclassified clips (reference ``prediction_vis.py:16``)."""

    def __init__(self, cfg, writer):
        self.cfg = cfg
        self.writer = writer
        self.tag = cfg.TENSORBOARD.WRONG_PRED_VIS.TAG
        self.num_vis = 0

    def visualize_vid(self, video, preds, labels, batch_idx):
        pred_ids = np.asarray(preds).argmax(-1)
        labels = np.asarray(labels)
        wrong = np.nonzero(pred_ids != labels)[0]
        for i in wrong[:4]:
            frames = np.asarray(video[i: i + 1])
            frames = np.clip(frames * np.asarray(self.cfg.DATA.STD)
                             + np.asarray(self.cfg.DATA.MEAN), 0, 1)
            self.writer.add_video(
                (frames * 255).astype(np.uint8),
                tag=f"{self.tag}/label_{int(labels[i])}_pred_{int(pred_ids[i])}",
                global_step=self.num_vis)
            self.num_vis += 1


def visualize(cfg, device=None):
    """The visualization pass of ``cfg`` over its test split, with the
    weights of ``load_test_checkpoint_path`` (else the seeded random ones),
    on the card unless ``device`` says otherwise."""
    logging.setup_logging(cfg.OUTPUT_DIR, is_master=du.is_master_proc())
    mesh = meshlib.build_mesh(cfg)
    model, _ = build_model(cfg, device=device)
    meshlib.shard_model(model, mesh)
    device = next(model.parameters()).device
    ckpt = cu.load_test_checkpoint_path(cfg)
    if ckpt:
        cu.load_params_any(model, ckpt, cfg, mesh)
    loader = construct_loader(cfg, "test", meshlib.data_sharding(mesh))

    writer = TensorboardWriter(cfg) if du.is_master_proc() else _Silent()
    try:
        if cfg.TENSORBOARD.MODEL_VIS.ENABLE:
            run_visualization(cfg, model, loader, writer, mesh)
        if cfg.TENSORBOARD.WRONG_PRED_VIS.ENABLE:
            wrong_vis = WrongPredictionVis(cfg, writer)
            for batch_idx, batch in enumerate(loader):
                with torch.inference_mode():
                    logits, _ = model(torch.from_numpy(batch["clips"]).to(
                        device))
                valid = batch["weight"] > 0
                share = (batch["clips"][valid],
                         logits.float().cpu().numpy()[valid],
                         batch["labels"][valid])
                for clips, preds, labels in (
                        du.all_gather_host(share)
                        if du.get_world_size() > 1 else [share]):
                    wrong_vis.visualize_vid(clips, preds, labels, batch_idx)
                if batch_idx >= 4:
                    break
    finally:
        writer.close()


class _Silent:
    """The writer of a rank other than the master: every call does
    nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None
