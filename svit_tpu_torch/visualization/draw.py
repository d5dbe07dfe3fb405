"""Debug drawing utilities (counterpart of ``svit_tpu/visualization/draw.py``,
reference ``slowfast/visualization/visualize.py`` box plotting; PIL).

Used by the demo and for HAOG-prediction inspection: draw predicted object
boxes (cxcywh in [0,1]) with presence scores onto frames.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

HAOG_COLORS = [
    (255, 64, 64),    # hand 1
    (255, 160, 64),   # hand 2
    (64, 160, 255),   # object 1
    (64, 255, 160),   # object 2
]

HAOG_NAMES = ["hand1", "hand2", "obj1", "obj2"]


def draw_haog_boxes(
    frame: np.ndarray,
    boxes_cxcywh: np.ndarray,
    scores: Optional[np.ndarray] = None,
    score_thresh: float = 0.5,
    names: Sequence[str] = HAOG_NAMES,
) -> np.ndarray:
    """frame: uint8 [H, W, 3]; boxes: [O, 4] normalized cxcywh."""
    img = Image.fromarray(frame)
    draw = ImageDraw.Draw(img)
    H, W = frame.shape[:2]
    for i, box in enumerate(np.asarray(boxes_cxcywh)):
        if scores is not None and float(scores[i]) < score_thresh:
            continue
        cx, cy, w, h = box
        if w <= 0 or h <= 0:
            continue
        x0, y0 = (cx - w / 2) * W, (cy - h / 2) * H
        x1, y1 = (cx + w / 2) * W, (cy + h / 2) * H
        color = HAOG_COLORS[i % len(HAOG_COLORS)]
        draw.rectangle([x0, y0, x1, y1], outline=color, width=2)
        label = names[i % len(names)]
        if scores is not None:
            label += f" {float(scores[i]):.2f}"
        draw.text((x0 + 2, max(0, y0 - 12)), label, fill=color)
    return np.asarray(img)


def draw_clip_haog(
    frames: np.ndarray,
    pred_bboxes: np.ndarray,
    score_thresh: float = 0.5,
) -> List[np.ndarray]:
    """frames: uint8 [T, H, W, 3]; pred_bboxes: [T, O, 5] = (score, cxcywh)."""
    out = []
    for t in range(frames.shape[0]):
        out.append(
            draw_haog_boxes(
                frames[t],
                pred_bboxes[t, :, 1:],
                pred_bboxes[t, :, 0],
                score_thresh,
            )
        )
    return out
