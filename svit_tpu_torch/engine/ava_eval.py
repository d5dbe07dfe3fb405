"""AVA-style detection evaluation (counterpart of
``svit_tpu/engine/ava_eval.py``; reference ``slowfast/utils/ava_evaluation``
+ ``ava_eval_helper.py``, compacted).

The reference vendors Google's TF object-detection evaluator (~3.3k LoC of
numpy); the same math fits in a page: per-class PASCAL AP at IoU 0.5 over
frame-level box detections, micro-averaged into mAP.  CSV read/exclusion
filtering mirrors ``ava_eval_helper.py:137-249``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU for xyxy boxes [N,4] x [M,4]."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-8)


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """PASCAL AP: area under the monotonized precision-recall curve."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_detections(
    groundtruth: Dict[str, Dict[int, List[Tuple[np.ndarray, None]]]],
    detections: Dict[str, Dict[int, List[Tuple[np.ndarray, float]]]],
    iou_thresh: float = 0.5,
) -> Dict[str, float]:
    """Frame-level per-class AP.

    groundtruth / detections: {image_key: {class_id: [(box xyxy, score)]}}.
    """
    class_ids = set()
    for img in groundtruth.values():
        class_ids.update(img.keys())

    aps = {}
    for cid in sorted(class_ids):
        scores, matches = [], []
        n_gt = 0
        for img_key, gt_img in groundtruth.items():
            gt_boxes = np.array([b for b, _ in gt_img.get(cid, [])]).reshape(-1, 4)
            n_gt += len(gt_boxes)
            det = detections.get(img_key, {}).get(cid, [])
            if not det:
                continue
            det_boxes = np.array([b for b, _ in det]).reshape(-1, 4)
            det_scores = np.array([s for _, s in det])
            order = np.argsort(-det_scores)
            taken = np.zeros(len(gt_boxes), bool)
            iou = (
                box_iou_matrix(det_boxes, gt_boxes)
                if len(gt_boxes)
                else np.zeros((len(det_boxes), 0))
            )
            for di in order:
                scores.append(det_scores[di])
                hit = False
                if iou.shape[1]:
                    gi = int(np.argmax(iou[di]))
                    if iou[di, gi] >= iou_thresh and not taken[gi]:
                        taken[gi] = True
                        hit = True
                matches.append(hit)
        if n_gt == 0:
            continue
        if not scores:
            aps[cid] = 0.0
            continue
        order = np.argsort(-np.asarray(scores))
        tp = np.asarray(matches, dtype=np.float64)[order]
        fp = 1.0 - tp
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recalls = tp_cum / n_gt
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-8)
        aps[cid] = average_precision(recalls, precisions)

    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    out = {"PascalBoxes_Precision/mAP@0.5IOU": mean_ap}
    for cid, ap in aps.items():
        out[f"PascalBoxes_PerformanceByCategory/AP@0.5IOU/{cid}"] = ap
    return out


def read_csv(path: str, class_allowlist=None):
    """AVA CSV: video_id, timestamp, x1, y1, x2, y2, action_id[, score]
    (reference ``ava_eval_helper.py:137-178``)."""
    entries: Dict[str, Dict[int, list]] = defaultdict(lambda: defaultdict(list))
    with open(path) as f:
        for line in f:
            row = line.strip().split(",")
            if len(row) < 7:
                continue
            image_key = f"{row[0]},{float(row[1]):04.0f}"
            box = np.array([float(v) for v in row[2:6]], np.float64)
            action = int(row[6])
            if class_allowlist is not None and action not in class_allowlist:
                continue
            score = float(row[7]) if len(row) > 7 else 1.0
            entries[image_key][action].append((box, score))
    return dict(entries)


def read_exclusions(path: str) -> set:
    excluded = set()
    if path:
        with open(path) as f:
            for line in f:
                row = line.strip().split(",")
                if len(row) == 2:
                    excluded.add(f"{row[0]},{float(row[1]):04.0f}")
    return excluded


def evaluate_ava(
    preds_csv: str,
    groundtruth_csv: str,
    exclusions_csv: str = "",
    class_allowlist=None,
) -> Dict[str, float]:
    gt = read_csv(groundtruth_csv, class_allowlist)
    det = read_csv(preds_csv, class_allowlist)
    for key in read_exclusions(exclusions_csv):
        gt.pop(key, None)
        det.pop(key, None)
    return evaluate_detections(gt, det)
