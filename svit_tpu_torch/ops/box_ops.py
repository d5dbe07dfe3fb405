"""Box utilities (counterpart of ``svit_tpu/ops/box_ops.py``).

Degenerate boxes are handled by clamped denominators, not asserts, so the
losses stay finite on all-zero (absent) targets.  ``zero_empty_boxes`` works
on tensors; ``match_haog`` is numpy, for the data layer.
"""

from __future__ import annotations

import numpy as np
import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def paired_giou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                eps: float = 1e-7) -> torch.Tensor:
    """Elementwise generalized IoU of paired xyxy boxes ``[..., 4]`` (the
    diagonal of the reference's ``generalized_box_iou``)."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / union.clamp(min=eps)
    lt_enc = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_enc = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_enc = (rb_enc - lt_enc).clamp(min=0)
    area_enc = wh_enc[..., 0] * wh_enc[..., 1]
    return iou - (area_enc - union) / area_enc.clamp(min=eps)


def zero_empty_boxes(boxes: torch.Tensor, mode: str = "cxcywh",
                     eps: float = 0.05) -> torch.Tensor:
    """Zero out boxes whose width or height <= eps (reference :116-130)."""
    if mode == "xyxy":
        wh = boxes[..., 2:4] - boxes[..., 0:2]
    elif mode == "cxcywh":
        wh = boxes[..., 2:4]
    else:
        raise NotImplementedError(mode)
    empty = (wh <= eps).any(dim=-1, keepdim=True)
    return torch.where(empty, torch.zeros_like(boxes), boxes)


# ---------------------------------------------------------------------------
# HAOG matching: numpy on the host, inside the data pipeline
# ---------------------------------------------------------------------------

HIGH_COST = 1e8
CONTACT_THRESHOLD = 0.1


def match_haog(haog: np.ndarray):
    """Order (hand1, hand2, obj1, obj2) by center distance; derive the
    contact state (reference ``box_ops.py:140-194``).

    ``haog``: [4, 4] boxes (two hands, then two objects).  As in the
    reference, the centers are the first two coordinates of the boxes as
    passed.  f32 throughout: ``1e8 + small`` rounds back to 1e8, so an
    ordering that involves a missing box ties and never swaps.  Returns
    (reordered haog [4, 4], contact_state [2] in {-1, 0, 3})."""
    haog = np.asarray(haog, dtype=np.float32)
    centers = haog[:, :2]
    diff = centers[:2, None, :] - centers[None, 2:, :]
    cost = np.sqrt(np.sum(diff * diff, axis=-1, dtype=np.float32))
    obj_is_zero = np.all(haog[2:] == 0, axis=-1)
    hand_is_zero = np.all(haog[:2] == 0, axis=-1)
    cost[:, obj_is_zero] = HIGH_COST
    cost[:, hand_is_zero] = HIGH_COST

    ord1 = np.float32(cost[0, 0] + cost[1, 1])
    ord2 = np.float32(cost[0, 1] + cost[1, 0])
    if ord2 < ord1:
        h1, h2, o1, o2 = haog[0], haog[2], haog[1], haog[3]
        haog = np.stack([h1, h2, o2, o1], axis=0)
        dists = (cost[0, 1], cost[1, 0])
    else:
        dists = (cost[0, 0], cost[1, 1])

    def _state(d):
        if d == HIGH_COST:
            return -1
        return 3 if d < CONTACT_THRESHOLD else 0

    contact = np.array([_state(d) for d in dists], dtype=np.int64)
    return haog.astype(np.float32), contact
