"""Grad-CAM for SViT (counterpart of ``svit_tpu/visualization/gradcam.py``,
reference ``slowfast/visualization/gradcam_utils.py``).

The reference hooks a named layer's forward and backward.  The JAX package
adds zero-valued perturbations after every block and takes the score's
gradient with respect to them; the port does the same with zero leaves
(``SViT.forward(capture_gradcam=True)``) and ``torch.autograd.grad``: one
forward, one backward that wants no parameter gradient.  The per-channel
mean gradient weights the layer's activations, and the ReLU of their sum
is upsampled over the input frames.

It runs eagerly (the JAX package does not jit it either).  The model takes
the hand-written kernels as ``TPU.USE_PALLAS_ATTENTION`` says, as
``build_model`` builds it; on the card the backward runs K5, K2's bare mode
and K6 through the blocks after the target.  The JAX package builds its CAM
model without ``use_pallas`` (``visualization/run.py:34``): the port's map
is held to that plain path.

Two properties of the JAX package that the port keeps or repairs:

- the default target is the last block's output.  With a cls token the
  head reads only the extras, so that grid feeds nothing: its gradient is
  exactly zero and so is the map (``allow_unused`` gives None here);
- the JAX package reshapes every layer's map to the grid after the last
  q-stride, with floor division (``_final_thw``), which raises before the
  last strided block and where a pool's output is not the floor (56 px).
  The port keeps the map on the layer's own grid, the activation's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from svit_tpu_torch.data.transform import bilinear_resize


# the maps whose OpenCV table is matplotlib's rounded to bytes (within
# 0.5 / 255); OpenCV's jet, hot, hsv and others are other maps
OPENCV_MAPS = ("autumn", "cividis", "cool", "inferno", "magma", "plasma",
               "spring", "summer", "turbo", "viridis", "winter")


def _colormap(name: str):
    """The colormap ``name``: matplotlib's, or where matplotlib is missing
    (the card's machine) OpenCV's table of one of ``OPENCV_MAPS``, read as
    matplotlib reads a float in [0, 1] (entry ``floor(256 x)``)."""
    try:
        import matplotlib
    except ImportError:
        return _opencv_colormap(name)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt.get_cmap(name)


def _opencv_colormap(name: str):
    if name not in OPENCV_MAPS:
        raise ValueError(f"colormap {name!r} needs matplotlib, which is not "
                         f"installed; OpenCV has {OPENCV_MAPS}")
    import cv2

    table = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                              getattr(cv2, f"COLORMAP_{name.upper()}"))
    rgb = table[:, 0, ::-1].astype(np.float32) / 255.0

    def cmap(x):
        return rgb[np.clip((np.asarray(x) * 256).astype(np.int64), 0, 255)]

    return cmap


class GradCAM:
    def __init__(
        self,
        model,                        # the port's SViT, eval mode
        target_layer: Optional[str] = None,  # "blocks_<i>_out"; default last
        data_mean=(0.45, 0.45, 0.45),
        data_std=(0.225, 0.225, 0.225),
        colormap: str = "viridis",
    ):
        self.model = model
        self.target_layer = (target_layer
                             or f"blocks_{model.arch.depth - 1}_out")
        self.data_mean = np.asarray(data_mean, np.float32)
        self.data_std = np.asarray(data_std, np.float32)
        self.colormap_name = colormap
        self._colormap = None   # made at the first overlay

    def layer_cam(self, clips: torch.Tensor,
                  labels: Optional[torch.Tensor] = None) -> dict:
        """One forward and one backward: ``logits``, the target layer's
        activations ``act`` and gradient ``grad`` [B, T', H', W', C] (zeros
        where the score does not reach the layer), and the pre-ReLU map
        ``cam`` [B, T', H', W'] in f32."""
        with torch.enable_grad():
            logits, extra = self.model(clips, train=False,
                                       capture_gradcam=True)
            point = extra["perturbations"][self.target_layer]
            if labels is None:
                score = logits.max(dim=-1).values
            else:
                score = logits.gather(-1, labels.long()[:, None])[:, 0]
            (grad,) = torch.autograd.grad(score.sum(), [point],
                                          allow_unused=True)
        act = extra["intermediates"][self.target_layer].detach()
        if grad is None:   # the layer feeds nothing the score reads
            grad = torch.zeros_like(act)
        # GAP of the gradient over the grid's tokens weighs the channels
        weights = grad.float().mean(dim=(1, 2, 3), keepdim=True)
        cam = (weights * act.float()).sum(dim=-1)
        return {"logits": logits.detach(), "act": act, "grad": grad,
                "cam": cam}

    def localization_map(
        self, clips: torch.Tensor, labels: Optional[torch.Tensor] = None
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """clips: [B, T, H, W, C] normalized, on the model's device.
        Returns (the map [B, T, H, W] in [0, 1], the logits)."""
        out = self.layer_cam(clips, labels)
        cam = torch.relu(out["cam"]).cpu().numpy()
        maps = _resize_cam(cam, clips.shape[1], clips.shape[2],
                           clips.shape[3])
        mn = maps.min(axis=(1, 2, 3), keepdims=True)
        mx = maps.max(axis=(1, 2, 3), keepdims=True)
        maps = (maps - mn) / np.maximum(mx - mn, 1e-8)
        return maps, out["logits"]

    def __call__(self, clips, labels=None, alpha: float = 0.5):
        """The overlaid uint8 videos [B, T, H, W, 3] and the logits."""
        maps, preds = self.localization_map(clips, labels)
        if self._colormap is None:
            self._colormap = _colormap(self.colormap_name)
        frames = clips.float().cpu().numpy() * self.data_std + self.data_mean
        frames = np.clip(frames, 0, 1)
        heat = self._colormap(maps)[..., :3]
        out = alpha * heat + (1 - alpha) * frames
        return (out * 255).astype(np.uint8), preds


def _resize_cam(cam: np.ndarray, t: int, h: int, w: int) -> np.ndarray:
    """[B, cT, cH, cW] -> [B, t, h, w]: nearest in time, bilinear in space
    (``F.interpolate``'s half-pixel rule)."""
    B, cT, cH, cW = cam.shape
    t_idx = np.clip(np.round(np.linspace(0, cT - 1, t)).astype(int), 0,
                    cT - 1)
    out = np.empty((B, t, h, w), np.float32)
    for b in range(B):
        frames = cam[b][t_idx][..., None]          # [t, cH, cW, 1]
        out[b] = bilinear_resize(frames, h, w)[..., 0]
    return out
