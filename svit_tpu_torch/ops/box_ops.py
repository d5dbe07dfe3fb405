"""Box utilities (counterpart of ``svit_tpu/ops/box_ops.py``).

Degenerate boxes are handled by clamped denominators, not asserts, so the
losses stay finite on all-zero (absent) targets.  ``zero_empty_boxes`` and
the HAOG matching belong to the data layer and are not ported yet.
"""

from __future__ import annotations

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
