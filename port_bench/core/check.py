"""The numbers that decide ``correct``, and their comparison with the
cell's limits (``limits/<cell>.json``).

Training (the first three steps of the very step object the window then
drives, against the reference's three steps from the same weights, inputs
and draws):

- ``first_loss_gap``: the first step's |loss - reference's| /
  |reference's| (``loss_gap``: the largest over the three steps);
- ``grad_gap``: the first step's clipped gradient as the optimizer got
  it, read back from AdamW's first moment (m = (1 - b1) g after one
  step), by the worst leaf: | ||g|| - ||g_ref|| | over the larger of
  ||g_ref|| and the median leaf's ||g_ref||;
- ``update_gap``: the parameters' change over the three steps, by the
  worst leaf, measured the same way;
- ``video_grad_dist`` and ``trunk_grad_dist``: the first step's gradient
  by the relative distance ||g - g_ref|| / ||g_ref|| of the leaves that
  the image branch's losses do not reach (the reference records which it
  reaches: in SViT the classifier's projection and the temporal position
  embedding), the median of them and the worst.  The worst is the
  temporal position embedding on every seed: its gradient comes back
  through every block's backward, so it holds the backward's kernels; the
  median is the classifier's projection, steadier from seed to seed.  A
  gap of norms hardly moves under errors that are random and many (a
  perturbation orthogonal to g changes ||g|| only at second order), so a
  precision lower shows in the distance and not in the gaps.  Over all
  the leaves the distance jumps in about a quarter of the seeds: the
  image branch's box L1 and GIoU have kinks, and a bf16 rounding of a
  predicted box that crosses one moves that image's gradient by a step;
  the leaves that branch does not reach are free of it.  The gaps catch a
  state left unchanged or a batch cut short.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a key's LayerNorm bias under softmax: nought to rounding, moved
by round-off alone) are left out of both, by that rule and not by name.

Test (the scores of views the window scored, against the reference's
eval forward of the same views): ``score_gap``, the largest over the
sampled views of the relative L2 distance between the centred log-scores
(the logits up to a constant: softmax's scores of a random model lie
near 1 / classes, and their logs carry the logits' error).
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

SMALL_LEAF = 1e-3


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def kept_leaves(ref_grads: Dict[str, torch.Tensor]):
    norms = _norms(ref_grads)
    med = statistics.median(norms.values())
    return sorted(k for k, n in norms.items() if n >= SMALL_LEAF * med)


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep) -> tuple:
    """(the worst leaf's gap, its name) of the norms of ``prog`` against
    ``ref`` over the leaves ``keep``."""
    pn, rn = _norms({k: prog[k] for k in keep}), _norms(
        {k: ref[k] for k in keep})
    med = statistics.median(rn.values())
    worst, at = 0.0, None
    for k in keep:
        gap = abs(pn[k] - rn[k]) / max(rn[k], med)
        if gap > worst or at is None:
            worst, at = gap, k
    return worst, at


def distances(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """||prog - ref|| / ||ref|| of each leaf of ``keep``."""
    return {k: float((prog[k].double() - ref[k].double()).norm())
            / max(float(ref[k].double().norm()), 1e-30) for k in keep}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"losses": [3 floats], "grad": {name: tensor}
    (the first step's clipped gradient), "update": {name: tensor} (the
    change over three steps)}."""
    keep = kept_leaves(ref["grad"])
    g, g_at = leaf_gap(prog["grad"], ref["grad"], keep)
    video = distances(prog["grad"], ref["grad"], [
        k for k in keep if k not in ref.get("image_reached", ())])
    u, u_at = leaf_gap(prog["update"], ref["update"], keep)
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
            "grad_gap": g, "update_gap": u,
            "video_grad_dist": statistics.median(video.values()),
            "trunk_grad_dist": max(video.values()),
            "_video_leaves": video, "_loss_gaps": gaps,
            "_worst": {"grad_gap": g_at, "update_gap": u_at},
            "_leaves": {"kept": len(keep), "all": len(ref["grad"])}}


def score_gap(prog_scores: torch.Tensor, ref_scores: torch.Tensor) -> float:
    """The largest relative L2 distance of the centred log-scores over the
    rows (views)."""
    def centred(s):
        ls = torch.log(s.double().clamp(min=1e-30))
        return ls - ls.mean(-1, keepdim=True)

    p, r = centred(prog_scores), centred(ref_scores)
    return float(((p - r).norm(dim=-1) / r.norm(dim=-1)).max())


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) for every number the limits
    name; a number above its limit, missing, or not finite fails."""
    rows, ok = [], True
    for name, spec in sorted(limits["numbers"].items()):
        v = numbers.get(name)
        lim = float(spec["limit"])
        good = v is not None and v == v and v <= lim
        ok = ok and good
        rows.append((name, v, lim))
    return ok, rows
