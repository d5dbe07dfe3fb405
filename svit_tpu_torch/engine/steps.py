"""The train and eval steps (counterpart of ``svit_tpu/engine/steps.py``).

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

Random numbers (the on-device augmentation, stochastic depth, dropout,
head dropout) come from the ``torch.Generator`` passed in, drawn in the
order augmentation, consistency, video, image; under data parallelism
every rank seeds it alike and each draw is the global batch's, cut to the
rank's rows (``DataShare.draws``).  They cannot match JAX's
streams; the tests feed both sides rates of 0.

The three forwards share one ``StepCache``: each weight is cast to bf16
once a step and the pool filters, their LN parameters and the object-token
multipliers derived once, each use's gradient reaching the f32 master as
the JAX package's per-use converts send it.

With ``TPU.REMAT`` the model keeps only each block's inputs and runs the
block again in the backward (``models/svit.py``), with the masks its
forward drew: the step's loss, gradients, parameters and generator state
are those without remat, bit for bit (``tests/test_torch_remat.py``).

The step's device work (``train_step.device_step``) has no host effect: it
reads the learning rate at the transform's device step counter and leaves
``state.step`` alone, so ``engine/graphs.py`` captures it in a CUDA graph
(the JAX package's ``jax.jit``); ``train_step`` sets the counter from the
host's step, runs it and counts the step.

Under data parallelism (``mesh``, ``parallel/mesh.py``) each rank runs
the step on its share of the global batch (``mesh.data_share()``): the
losses are its terms of the global batch's, the gradients are summed
over the data group in buckets after the backward and before the clip
(``mesh.all_reduce_gradients``: inside the step, so inside its CUDA
graph), and the metrics too.  The clip and the norm then see the global
gradient; under tensor parallelism the norm sums the squares of the
sharded tensors over the model group (``Transform.shard``).  With no
process group none of this runs.

The step is deterministic: two runs from one state on one batch give the
same loss, gradients and parameters bit for bit.  The hand-written
backward kernels add in fixed orders (K3's ``pool_max_bwd`` included), and
on the card cuDNN's default convolution gradients (the patch embed, the
object-token multiplier) were bit-identical from run to run too
(``chip_smoke.py`` phase 9 runs a step under
``torch.use_deterministic_algorithms``, which names no op); nothing is set
for the process.

The eval steps (``make_eval_step``, ``make_image_eval_step``,
``make_test_step``) run the model in eval mode under
``torch.inference_mode()`` and return detached tensors on the model's
device; the batch lies there too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from svit_tpu_torch.data import device_aug
from svit_tpu_torch.models.common import StepCache
from svit_tpu_torch.models.losses import consistency_loss
from svit_tpu_torch.models.optimizer import Transform
from svit_tpu_torch.parallel import mesh as meshlib


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    tx: Transform


def create_train_state(model, tx: Transform) -> TrainState:
    return TrainState(step=0, model=model, tx=tx)


def make_train_step(model, loss_obj, tx, video_weight: float,
                    image_weight: float, with_image: bool,
                    with_consistency: bool, device_aug_cfg=None, mesh=None):
    """Build the fused video + image train step.

    video_batch: {clips [B, T, H, W, 3], labels [B], weight [B]}
    image_batch: {frames [B, 1, H, W, 3], haog_bboxes [B, 1, O, 4],
                  contact_state [B, 2], weight [B]} (may be None)

    With ``device_aug_cfg`` (a ``DeviceAugConfig``) the clips and frames
    arrive as raw uint8 and the image boxes as xyxy input pixels; the
    augmentation runs inside the step (``data/device_aug.py``).  With a
    ``mesh`` whose data group exists, the batches are this rank's shares
    and the step sums the gradients and the metrics over the data group.

    ``train_step(state, video_batch, image_batch, generator)`` updates the
    state's model in place and returns ``(state, metrics)``: the loss keys,
    ``loss`` and ``grad_norm`` as detached scalars on the device.
    """
    del model, tx  # carried by the state, as the JAX step takes them from it
    share = meshlib.ONE if mesh is None else mesh.data_share()

    def loss_fn(m, video_batch, image_batch, generator):
        cache = StepCache()   # the casts and derived parameters, once
        metrics: Dict[str, Any] = {}
        frames_extra = None
        clips = video_batch["clips"]
        if with_consistency:
            B, T = clips.shape[:2]
            frames = clips.reshape(B * T, 1, *clips.shape[2:])
            with torch.no_grad():
                _, fe = m(frames, train=True, generator=generator,
                          cache=cache)
            desc = fe["obj_desc"]
            frames_extra = {"obj_desc": desc.reshape(B, T, -1, desc.shape[-1])}
        logits, extra = m(clips, train=True, generator=generator,
                          cache=cache)
        vdict = loss_obj.video_losses(logits, video_batch["labels"], extra,
                                      frames_extra, video_batch.get("weight"),
                                      share)
        total = video_weight * loss_obj.weighted_sum(vdict)
        metrics.update(vdict)
        if with_image and image_batch is not None:
            _, iextra = m(image_batch["frames"], train=True,
                          generator=generator, cache=cache)
            idict = loss_obj.image_losses(
                iextra, {"haog_bboxes": image_batch["haog_bboxes"],
                         "contact_state": image_batch["contact_state"]},
                image_batch.get("weight"), share)
            total = total + image_weight * loss_obj.weighted_sum(idict)
            metrics.update(idict)
        metrics["loss"] = total
        return total, metrics

    def device_step(state: TrainState, video_batch, image_batch, generator):
        generator = share.draws(generator)
        if device_aug_cfg is not None:
            video_batch = dict(video_batch, clips=device_aug.device_augment(
                video_batch["clips"], generator, device_aug_cfg))
            if image_batch is not None:
                # the paired affine gives normalised cxcywh HAOG targets
                frames, haog = device_aug.device_augment_image(
                    image_batch["frames"], image_batch["haog_bboxes"],
                    generator, device_aug_cfg)
                image_batch = dict(image_batch, frames=frames,
                                   haog_bboxes=haog)
        m = state.model
        params = [p for p in m.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        total, metrics = loss_fn(m, video_batch, image_batch, generator)
        total.backward()
        if share.group is not None:
            meshlib.all_reduce_gradients(params, share.group)
            metrics = meshlib.all_reduce_scalars(metrics, share.group)
        metrics["grad_norm"] = state.tx.apply(params)
        return {k: v.detach() for k, v in metrics.items()}

    return _counted(device_step)


def _counted(device_step):
    """The step as callers run it: the transform's device step counter set
    from the host's step, the device work, the step counted.  The device
    work stays reachable as ``.device_step`` for ``engine/graphs.py``."""

    def train_step(state: TrainState, video_batch, image_batch, generator):
        state.tx.set_step(state.step)
        out = device_step(state, video_batch, image_batch, generator)
        state.step += 1
        return state, out

    train_step.device_step = device_step
    return train_step


def make_packed_train_step(*args, **kwargs):
    """``make_train_step`` with the metrics packed into ONE f32 vector on
    the device, in ``metric_names``' order (sorted), so that the engine
    fetches a window of steps in one stack and one device-to-host copy.
    Returns ``(step_fn, metric_names)``; the names fill at the first call."""
    base = make_train_step(*args, **kwargs)
    names: list = []

    def device_step(state, video_batch, image_batch, generator):
        m = base.device_step(state, video_batch, image_batch, generator)
        ks = sorted(m)
        if not names:
            names.extend(ks)
        return torch.stack([m[k].float() for k in ks])

    return _counted(device_step), names


@contextlib.contextmanager
def _evaluating(model):
    """Eval mode and ``torch.inference_mode()`` for one step; the model's
    mode is restored after."""
    was = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was)


def _nll(raw, labels, n, w):
    """Weighted mean NLL of ``labels`` under ``log_softmax(raw)`` in f32 (the
    stable form: ``log(softmax(x))`` gives inf for a confident wrong bf16
    prediction)."""
    safe = labels.clamp(0, max(n - 1, 0)).long()
    logp = F.log_softmax(raw.float(), dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def _weights(batch, rows, device):
    w = batch.get("weight")
    if w is None:
        return torch.ones(rows, dtype=torch.float32, device=device)
    return w.float()


def make_eval_step(model, num_classes, loss_obj=None,
                   with_consistency: bool = False):
    """Eval: logits (softmax'd, the eval head's activation) and the weighted
    top-1 and top-5 counts.

    ``num_classes`` is an int, or the arch's multitask tuple ``(("verb",
    nv), ("noun", nn), ...)``: then ``batch["labels"]`` is a dict of
    per-task labels, and the step reports each task's weighted counts
    (``{task}_top{1,5}_correct``) and the JOINT counts in the primary
    slots (a sample is jointly correct at k iff every task is correct
    within its own top-k: the reference's EPIC-Kitchens "action" protocol).

    ``loss_ce`` is the weighted NLL of the raw logits.  With ``loss_obj``
    the step also reports the val loss dict the reference logs: with
    ``with_consistency`` the consistency loss against a frames forward of
    the clip reshaped to ``B * T`` single frames, and the lambda-weighted
    ``loss``.

    ``eval_step(batch)``: ``batch`` holds ``clips [B, T, H, W, 3]``,
    ``labels`` and optionally ``weight [B]``, on the model's device.
    """
    multitask = not isinstance(num_classes, int)

    def eval_step(batch) -> Dict[str, torch.Tensor]:
        with _evaluating(model):
            clips = batch["clips"]
            logits, extra = model(clips, train=False)
            labels = batch["labels"]
            first = logits[num_classes[0][0]] if multitask else logits
            w = _weights(batch, first.shape[0], first.device)
            raw = extra.get("raw_logits", logits)
            if multitask:
                joint1 = joint5 = None
                per_task = {}
                val_loss = 0.0
                for name, n in num_classes:
                    top = torch.topk(logits[name], min(5, n), dim=-1).indices
                    corr = top == labels[name][:, None]
                    cum = torch.cumsum(corr, dim=1) > 0   # within top-k
                    c1b, c5b = cum[:, 0], cum[:, -1]
                    per_task[name] = ((c1b * w).sum(), (c5b * w).sum())
                    joint1 = c1b if joint1 is None else joint1 & c1b
                    joint5 = c5b if joint5 is None else joint5 & c5b
                    val_loss = val_loss + _nll(raw[name], labels[name], n, w)
                out = {"logits": logits,
                       "top1_correct": (joint1 * w).sum(),
                       "top5_correct": (joint5 * w).sum(),
                       "count": w.sum(), "loss_ce": val_loss}
                for name, (c1, c5) in per_task.items():
                    out[f"{name}_top1_correct"] = c1
                    out[f"{name}_top5_correct"] = c5
                if loss_obj is not None:
                    out["loss"] = loss_obj.weighted_sum({"loss_ce": val_loss})
                return out

            top = torch.topk(logits, min(5, num_classes), dim=-1).indices
            correct = top == labels[:, None]
            out = {"logits": logits,
                   "top1_correct": (correct[:, :min(1, num_classes)]
                                    .any(dim=1) * w).sum(),
                   "top5_correct": (correct.any(dim=1) * w).sum(),
                   "count": w.sum(),
                   "loss_ce": _nll(raw, labels, num_classes, w)}
            if loss_obj is not None:
                vdict = {"loss_ce": out["loss_ce"]}
                if with_consistency:
                    B, T = clips.shape[:2]
                    frames = clips.reshape(B * T, 1, *clips.shape[2:])
                    _, fe = model(frames, train=False)
                    desc = fe["obj_desc"]
                    key = f"video_image_desc_{loss_obj.consistency_kind}_loss"
                    vdict[key] = consistency_loss(
                        extra["obj_desc"],
                        desc.reshape(B, T, -1, desc.shape[-1]),
                        loss_obj.consistency_kind)
                vdict["loss"] = loss_obj.weighted_sum(vdict)
                out.update(vdict)
            return out

    return eval_step


def make_image_eval_step(model, loss_obj):
    """Image-branch val: the HAOG losses on an image batch (``frames [B, 1,
    H, W, 3]``, ``haog_bboxes``, ``contact_state``, optionally
    ``weight``).  The reference runs no image val loop; the HAOG heads are
    trained parameters, and this catches regressions of the image branch
    that the video CE cannot see."""

    def image_eval_step(batch) -> Dict[str, torch.Tensor]:
        with _evaluating(model):
            _, iextra = model(batch["frames"], train=False)
            w = batch.get("weight")
            idict = loss_obj.image_losses(
                iextra, {"haog_bboxes": batch["haog_bboxes"],
                         "contact_state": batch["contact_state"]}, w)
            idict["loss"] = loss_obj.weighted_sum(idict)
            idict["count"] = _weights(batch, batch["frames"].shape[0],
                                      batch["frames"].device).sum()
            return idict

    return image_eval_step


def make_test_step(model):
    """Multi-view test: per-clip softmax scores for host-side ensembling."""

    def test_step(batch) -> torch.Tensor:
        with _evaluating(model):
            logits, _ = model(batch["clips"], train=False)
            return logits

    return test_step


def check_nan(metrics: Dict[str, Any], extra_msg: str = ""):
    """Host-side NaN guard (reference ``misc.check_nan_losses``)."""
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"ERROR: Got NaN losses: {metrics} {extra_msg}")
