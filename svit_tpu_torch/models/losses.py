"""Loss functions (counterpart of ``svit_tpu/models/losses.py``).

Every loss takes and returns tensors and computes in f32.  Masked
reductions replace boolean indexing, and the reference's per-rank video or
image branch is two explicit functions that the train step weights.  A
per-sample ``weight`` [B] lets zero-weight padding samples leave every loss
value unchanged.

Loss keys match the reference: ``loss_ce, boxes_l1_loss, boxes_bce_loss,
boxes_giou_loss, loss_contact_state, video_image_desc_l{1,2}_loss``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from svit_tpu_torch.ops import box_ops


def _weighted_mean(per, weight):
    if weight is None:
        return per.mean()
    return (per * weight).sum() / weight.sum().clamp(min=1.0)


def cross_entropy(logits, labels, weight=None):
    """Mean CE over the batch; labels are int class ids."""
    logp = F.log_softmax(logits.float(), dim=-1)
    safe = labels.clamp(0, logits.shape[-1] - 1)
    nll = -logp.gather(-1, safe[..., None].long())[..., 0]
    return _weighted_mean(nll, weight)


def soft_target_cross_entropy(logits, soft_targets):
    """Reference ``SoftTargetCrossEntropy``."""
    return (-soft_targets * F.log_softmax(logits.float(), dim=-1)).sum(-1).mean()


def bce_with_logits(logits, targets):
    """Elementwise binary cross-entropy with logits (no reduction), in the
    JAX package's form."""
    return (logits.clamp(min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def boxes_loss(pred, tar, weight=None):
    """HAOG box losses.  pred: [B, T, O, 5] = (presence logit, cxcywh); tar:
    [B, T, O, 4] cxcywh (all-zero rows are absent) or [B, T, O, 5] with a
    leading score.  Returns (l1, bce, giou)."""
    pred, tar = pred.float(), tar.float()
    if tar.shape[-1] == 4:
        tar_mask = 1.0 - (tar == 0).all(-1).float()
        tar_mask_cont = tar_mask
    elif tar.shape[-1] == 5:
        tar_mask_cont = tar[..., 0]
        tar_mask = (tar[..., 0] > 0.5).float()
        tar = tar[..., 1:]
    else:
        raise NotImplementedError("boxes target must have 4 or 5 coords")
    if weight is None:
        weight = pred.new_ones(pred.shape[0])
    w_sample = weight.float()[:, None, None]

    bce = bce_with_logits(pred[..., 0], tar_mask_cont) * w_sample
    per_sample_el = tar_mask_cont.shape[1] * tar_mask_cont.shape[2]
    loss_bce = bce.sum() / (weight.sum() * per_sample_el).clamp(min=1.0)

    tar_mask = tar_mask * w_sample
    pred_boxes = pred[..., 1:]
    n_sel = tar_mask.sum()
    denom = n_sel.clamp(min=1.0)
    loss_l1 = ((pred_boxes - tar).abs().mean(-1) * tar_mask).sum() / denom
    giou = box_ops.paired_giou(box_ops.box_cxcywh_to_xyxy(pred_boxes),
                               box_ops.box_cxcywh_to_xyxy(tar))
    loss_giou = ((1.0 - giou) * tar_mask).sum() / denom
    has_any = (n_sel > 0).float()
    return loss_l1 * has_any, loss_bce, loss_giou * has_any


def contact_state_loss(pred, tar, weight=None):
    """Masked CE over contact states.  pred: [B, T, 2, 5] logits; tar: [B, 2]
    int in {-1 (ignored), 0..4}."""
    per_sample = pred.shape[1] * pred.shape[2]
    pred = pred.float().reshape(-1, pred.shape[-1])
    tar = tar.reshape(-1)
    mask = (tar >= 0).float()
    if weight is not None:
        mask = mask * weight.float().repeat_interleave(per_sample)
    logp = F.log_softmax(pred, dim=-1)
    nll = -logp.gather(-1, tar.clamp(min=0)[:, None].long())[:, 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def consistency_loss(video_obj_desc, frame_obj_desc, kind: str = "l1"):
    """Frame-clip consistency: the video's object tokens against the
    per-frame ones, which carry no gradient."""
    tar = frame_obj_desc.detach().reshape(video_obj_desc.shape).float()
    diff = video_obj_desc.float() - tar
    if kind == "l1":
        return diff.abs().mean()
    if kind == "l2":
        return diff.square().mean()
    raise NotImplementedError(kind)


def get_lambdas_dict(cfg) -> Dict[str, float]:
    """Loss weights (reference ``utils/misc.py:412-423``), with its quirk:
    FORWARD_VIDEO_FRAMES adds ``video_image_boxes_l1_loss``, which no loss
    emits, so the consistency term weighs only when
    ``SVIT.CONSISTENCY_LOSS`` names its kind."""
    lam = {
        "loss_ce": 1.0,
        "boxes_l1_loss": 5.0 * cfg.SVIT.LAMBDA_NODES,
        "boxes_bce_loss": 1.0 * cfg.SVIT.LAMBDA_NODES,
        "boxes_giou_loss": 2.0 * cfg.SVIT.LAMBDA_NODES,
        "loss_contact_state": cfg.SVIT.LAMBDA_EDGES,
    }
    if cfg.TRAIN.FORWARD_VIDEO_FRAMES:
        lam["video_image_boxes_l1_loss"] = cfg.SVIT.LAMBDA_CON
        kind = cfg.SVIT.CONSISTENCY_LOSS
        if kind:
            lam[f"video_image_desc_{kind}_loss"] = cfg.SVIT.LAMBDA_CON
    return lam


class VideoImageLoss:
    """The SViT objective as explicit video and image branches."""

    def __init__(self, cfg):
        self.lambdas = get_lambdas_dict(cfg)
        self.forward_video_frames = cfg.TRAIN.FORWARD_VIDEO_FRAMES
        self.consistency_kind = cfg.SVIT.CONSISTENCY_LOSS

    def video_losses(self, logits, labels, extra_preds,
                     frames_extra_preds=None, weight=None):
        if labels.dim() == 2:  # soft targets (the mixup path)
            per = (-labels * F.log_softmax(logits.float(), dim=-1)).sum(-1)
            ret = {"loss_ce": _weighted_mean(per, weight)}
        else:
            ret = {"loss_ce": cross_entropy(logits, labels, weight)}
        if (self.forward_video_frames and self.consistency_kind
                and frames_extra_preds is not None):
            key = f"video_image_desc_{self.consistency_kind}_loss"
            ret[key] = consistency_loss(extra_preds["obj_desc"],
                                        frames_extra_preds["obj_desc"],
                                        self.consistency_kind)
        return ret

    def image_losses(self, extra_preds, metadata, weight=None):
        l1, bce, giou = boxes_loss(extra_preds["pred_bboxes"],
                                   metadata["haog_bboxes"], weight)
        return {
            "boxes_l1_loss": l1,
            "boxes_bce_loss": bce,
            "boxes_giou_loss": giou,
            "loss_contact_state": contact_state_loss(
                extra_preds["pred_contact_state"], metadata["contact_state"],
                weight),
        }

    def weighted_sum(self, loss_dict):
        total = 0.0
        for k, v in loss_dict.items():
            total = total + self.lambdas[k] * v
        return total


_LOSSES = {
    "cross_entropy": lambda cfg: cross_entropy,
    "soft_cross_entropy": lambda cfg: soft_target_cross_entropy,
    "video_image_loss": VideoImageLoss,
}


def get_loss_func(cfg, state: str = "train"):
    name = cfg.MODEL.LOSS_FUNC
    if state == "val" and name == "soft_cross_entropy":
        name = "cross_entropy"
    if name not in _LOSSES:
        raise NotImplementedError(f"Loss {name} is not supported")
    return _LOSSES[name](cfg)
