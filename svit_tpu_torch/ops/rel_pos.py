"""Decomposed relative positional bias tables (counterpart of
``svit_tpu/ops/rel_pos.py``).

The index math of the MViTv2 reference (``get_rel_pos`` /
``cal_rel_pos_spatial`` / ``cal_rel_pos_temporal``): relative-distance index
tables gather the learned ``rel_pos_*`` parameters.  The bias terms built
from them live in ``svit_tpu_torch/ops/attention.py``.
"""

from __future__ import annotations

import torch


def resize_rel_pos(rel_pos: torch.Tensor, d: int) -> torch.Tensor:
    """Linearly resample a [L, C] rel-pos table to length d.

    Matches ``F.interpolate(mode='linear', align_corners=False)``: half-pixel
    sampling, no antialiasing on downsampling.  The sampling positions are
    computed on the table's device (float64), so no host copy stalls the
    stream.
    """
    ori = rel_pos.shape[0]
    if ori == d:
        return rel_pos
    src = (torch.arange(d, dtype=torch.float64, device=rel_pos.device)
           + 0.5) * (ori / d) - 0.5
    lo = src.floor().clamp(0, ori - 1)
    hi = (lo + 1).clamp(0, ori - 1)
    w_hi = (src - lo).clamp(0.0, 1.0).to(rel_pos.dtype)[:, None]
    return rel_pos[lo.long()] * (1.0 - w_hi) + rel_pos[hi.long()] * w_hi


def _dist_idx(q_n: int, k_n: int, device=None) -> torch.Tensor:
    """Relative-distance index table with MViT ratio scaling: when the q and
    k grids differ, indices are scaled so the table spans the larger."""
    q_ratio = max(k_n / q_n, 1.0)
    k_ratio = max(q_n / k_n, 1.0)
    f64 = dict(dtype=torch.float64, device=device)
    dist = (torch.arange(q_n, **f64)[:, None] * q_ratio
            - torch.arange(k_n, **f64)[None, :] * k_ratio)
    return (dist + (k_n - 1) * k_ratio).long()


def rel_table(rel_pos: torch.Tensor, q_n: int, k_n: int) -> torch.Tensor:
    """Resized + distance-indexed rel-pos table: [q_n, k_n, head_dim]."""
    d = 2 * max(q_n, k_n) - 1
    return resize_rel_pos(rel_pos, d)[_dist_idx(q_n, k_n, rel_pos.device)]
