"""The fused train step (counterpart of ``svit_tpu/engine/steps.py``).

One call of the step does what the JAX package's jitted step does:

1. with ``with_consistency``, a train-mode forward of the clip reshaped to
   ``B * T`` single frames under ``torch.no_grad()`` (JAX's
   ``stop_gradient``);
2. the video forward and its losses (cross-entropy on the raw logits, plus
   the consistency term);
3. with ``with_image``, the image forward and the HAOG losses;
4. the two branches weighted ``video_weight`` and ``image_weight`` (the
   reference's rank ratio), one backward;
5. the global gradient norm (reported before the clip), the clip and the
   AdamW update at this step's learning rate.

Random numbers (stochastic depth, dropout, head dropout) come from the
``torch.Generator`` passed in, drawn in the order consistency, video, image.
They cannot match JAX's streams; the tests feed both sides rates of 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from svit_tpu_torch.models.optimizer import Transform


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    tx: Transform


def create_train_state(model, tx: Transform) -> TrainState:
    return TrainState(step=0, model=model, tx=tx)


def make_train_step(model, loss_obj, tx, video_weight: float,
                    image_weight: float, with_image: bool,
                    with_consistency: bool):
    """Build the fused video + image train step.

    video_batch: {clips [B, T, H, W, 3], labels [B], weight [B]}
    image_batch: {frames [B, 1, H, W, 3], haog_bboxes [B, 1, O, 4],
                  contact_state [B, 2], weight [B]} (may be None)

    ``train_step(state, video_batch, image_batch, generator)`` updates the
    state's model in place and returns ``(state, metrics)``: the loss keys,
    ``loss`` and ``grad_norm`` as detached scalars on the device.
    """
    del model, tx  # carried by the state, as the JAX step takes them from it

    def loss_fn(m, video_batch, image_batch, generator):
        metrics: Dict[str, Any] = {}
        frames_extra = None
        clips = video_batch["clips"]
        if with_consistency:
            B, T = clips.shape[:2]
            frames = clips.reshape(B * T, 1, *clips.shape[2:])
            with torch.no_grad():
                _, fe = m(frames, train=True, generator=generator)
            desc = fe["obj_desc"]
            frames_extra = {"obj_desc": desc.reshape(B, T, -1, desc.shape[-1])}
        logits, extra = m(clips, train=True, generator=generator)
        vdict = loss_obj.video_losses(logits, video_batch["labels"], extra,
                                      frames_extra, video_batch.get("weight"))
        total = video_weight * loss_obj.weighted_sum(vdict)
        metrics.update(vdict)
        if with_image and image_batch is not None:
            _, iextra = m(image_batch["frames"], train=True,
                          generator=generator)
            idict = loss_obj.image_losses(
                iextra, {"haog_bboxes": image_batch["haog_bboxes"],
                         "contact_state": image_batch["contact_state"]},
                image_batch.get("weight"))
            total = total + image_weight * loss_obj.weighted_sum(idict)
            metrics.update(idict)
        metrics["loss"] = total
        return total, metrics

    def train_step(state: TrainState, video_batch, image_batch, generator):
        m = state.model
        params = [p for p in m.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        total, metrics = loss_fn(m, video_batch, image_batch, generator)
        total.backward()
        metrics["grad_norm"] = state.tx.apply(params, state.step)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
