"""Accuracy metrics (counterpart of ``svit_tpu/engine/metrics.py``,
reference ``slowfast/utils/metrics.py``).

The host-side counts take numpy arrays or tensors; ``jit_topk_correct`` is
the device-side form the eval steps use, on tensors.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def topks_correct(preds, labels, ks: Iterable[int]) -> List:
    """Number of top-k correct predictions per k (reference metrics.py:9-50).

    preds: [B, C] scores; labels: [B] ints.  Handles the 0-class edge case.
    """
    preds = _np(preds)
    labels = _np(labels)
    if preds.shape[-1] == 0:
        return [np.zeros(()) for _ in ks]
    max_k = min(max(ks), preds.shape[-1])
    # top-k indices per row, sorted by score descending
    topk_idx = np.argsort(-preds, axis=-1)[:, :max_k]
    correct = topk_idx == labels[:, None]
    return [correct[:, : min(k, max_k)].sum() for k in ks]


def topk_accuracies(preds, labels, ks):
    num = len(_np(labels))
    return [float(c) / num * 100.0 for c in topks_correct(preds, labels, ks)]


def topk_errors(preds, labels, ks):
    num = len(_np(labels))
    return [(1.0 - float(c) / num) * 100.0
            for c in topks_correct(preds, labels, ks)]


def multitask_topks_correct(preds: dict, labels: dict, ks=(1,)):
    """Joint verb+noun top-k (reference metrics.py:78-118): a sample counts as
    correct at k iff every task is correct within its own top-k."""
    all_correct = None
    for name in preds:
        p = _np(preds[name])
        lab = _np(labels[name])
        topk_idx = np.argsort(-p, axis=-1)[:, :max(ks)]
        corr = topk_idx == lab[:, None]  # [B, max_k]
        cum = np.cumsum(corr, axis=1) > 0  # correct within top-k
        all_correct = cum if all_correct is None else (all_correct & cum)
    return [all_correct[:, k - 1].sum() for k in ks]


def jit_topk_correct(preds: torch.Tensor, labels: torch.Tensor, ks=(1, 5)):
    """Top-k correct counts on the preds' device, as tensors."""
    out = []
    for k in ks:
        kk = min(k, preds.shape[-1])
        idx = torch.topk(preds, kk, dim=-1).indices
        out.append((idx == labels[:, None]).sum())
    return out
