"""The reference's joint train step: the SViT objective (video
cross-entropy, the frame-clip consistency term, the image branch's HAOG
box and contact losses), the global-norm clip and AdamW, in plain PyTorch
and float32.

The step follows SViT's recipe (Ben Avraham et al., 2022) as the
configuration states it: a no-grad train-mode forward of every clip's
frames one at a time gives the consistency targets; the video forward
takes cross-entropy and the L1 consistency term, the image forward the
box L1, presence BCE, GIoU and contact losses; the two branches weigh as
the video and image ranks of the published run (``NUM_GPUS`` ranks, those
in ``IMAGE_TRAIN.GPU_IDS`` image ranks); one backward; the gradient is
clipped to ``SOLVER.CLIP_GRAD_L2NORM`` by its global norm, then AdamW
(decay off for biases and 1-D tensors) steps at the cosine schedule's rate.

Every loss is a sum over rows divided by a denominator that the whole
batch fixes, so the forwards run in blocks of rows (``chunk``) whose
gradients add up to the whole batch's: the reference fits beside the
program's state.  The random draws of a step come from a generator seeded
by (``RNG_SEED``, step) and are made for the whole batch, in the order of
the three forwards.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import svit

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's draws: SeedSequence([seed, step]), 63 bits."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1, np.uint64)[0] >> 1)


def lr_at(cfg: dict, step: int, steps_per_epoch: int) -> float:
    """The cosine schedule's rate at ``step`` (f32), with the linear warm-up
    and the base rate scaled by the shards, as the configuration states."""
    sol = cfg["SOLVER"]
    base = float(sol["BASE_LR"])
    if sol["BASE_LR_SCALE_NUM_SHARDS"]:
        base *= int(cfg["NUM_SHARDS"])
    if sol["LR_POLICY"] != "cosine":
        raise NotImplementedError(sol["LR_POLICY"])
    warm = float(sol["WARMUP_EPOCHS"])
    off = warm if sol["COSINE_AFTER_WARMUP"] else 0.0
    end, top = float(sol["COSINE_END_LR"]), float(sol["MAX_EPOCH"])

    def cosine(e):
        return end + (base - end) * (math.cos(math.pi * (e - off)
                                              / (top - off)) + 1.0) * 0.5

    epoch = step / steps_per_epoch
    lr = cosine(epoch)
    if epoch < warm:
        start = float(sol["WARMUP_START_LR"])
        lr = epoch * (cosine(warm) - start) / warm + start
    return float(np.float32(lr))


def branch_weights(cfg: dict):
    """(video, image) weights: the share of the published run's ranks."""
    n = int(cfg["NUM_GPUS"])
    images = len([g for g in cfg["IMAGE_TRAIN"]["GPU_IDS"] if g < n])
    w_i = images / max(n, 1)
    return 1.0 - w_i, w_i


def lambdas(cfg: dict) -> Dict[str, float]:
    s = cfg["SVIT"]
    return {"ce": 1.0, "l1": 5.0 * s["LAMBDA_NODES"],
            "bce": 1.0 * s["LAMBDA_NODES"],
            "giou": 2.0 * s["LAMBDA_NODES"], "contact": s["LAMBDA_EDGES"],
            "con": s["LAMBDA_CON"]}


def _xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _giou(a, b, eps=1e-7):
    """Generalised IoU of paired xyxy boxes."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    wh = (torch.minimum(a[..., 2:], b[..., 2:])
          - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    enc = (torch.maximum(a[..., 2:], b[..., 2:])
           - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0)
    area_e = enc[..., 0] * enc[..., 1]
    return inter / union.clamp(min=eps) - (area_e - union) / area_e.clamp(
        min=eps)


def _rows(n, chunk):
    """Blocks of at most ``chunk`` of ``n`` rows."""
    return [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


class TrainReference:
    """Parameters and AdamW moments of the reference, stepped by
    ``step``.  ``params``: name -> f32 tensor (the initial weights)."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 steps_per_epoch: int, prec: str = "f32", chunk: int = 4,
                 frames_chunk: int = 64):
        self.cfg, self.prec = cfg, prec
        self.arch = svit.arch_from_cfg(cfg)
        self.P = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.decay = {k: not (k.endswith(".bias") or v.dim() <= 1)
                      for k, v in self.P.items()}
        self.steps_per_epoch = steps_per_epoch
        self.chunk, self.frames_chunk = chunk, frames_chunk
        self.step_count = 0
        # the leaves the image branch's losses reach (its box L1 and GIoU
        # have kinks that a rounding can cross)
        self.image_reached = set()
        self.video_weight, self.image_weight = branch_weights(cfg)
        self.lam = lambdas(cfg)
        self.consistency = bool(cfg["TRAIN"]["FORWARD_VIDEO_FRAMES"]
                                and cfg["SVIT"]["CONSISTENCY_LOSS"])
        kind = cfg["SVIT"]["CONSISTENCY_LOSS"]
        if self.consistency and kind != "l1":
            raise NotImplementedError(f"consistency loss {kind!r}")

    def _forward(self, x, masks):
        return svit.forward(self.P, self.arch, x, masks, self.prec)

    def step(self, video: dict, image: Optional[dict]) -> dict:
        """One joint step on ``video`` (clips [B, T, H, W, 3], labels [B])
        and ``image`` (frames [B, 1, H, W, 3], haog_bboxes [B, 1, O, 4],
        contact_state [B, 2]).  Returns the loss, the clipped gradient
        (name -> tensor) and the global norm before the clip."""
        arch, cfg = self.arch, self.cfg
        clips = video["clips"]
        device = clips.device
        gen = torch.Generator(device=device)
        gen.manual_seed(step_seed(cfg["RNG_SEED"], self.step_count))
        B, T = clips.shape[:2]
        frames = clips.reshape(B * T, 1, *clips.shape[2:])
        cmasks = (svit.draw_masks(arch, B * T, 1, gen, device)
                  if self.consistency else None)
        vmasks = svit.draw_masks(arch, B, T, gen, device)
        imasks = (svit.draw_masks(arch, image["frames"].shape[0], 1, gen,
                                  device) if image is not None else None)
        for p in self.P.values():
            p.grad = None
        total = 0.0
        target = None
        if self.consistency:
            with torch.no_grad():
                descs = [self._forward(frames[lo:hi],
                                       svit.rows_of(cmasks, lo, hi))[1]
                         ["obj_desc"] for lo, hi in
                         _rows(B * T, self.frames_chunk)]
            target = torch.cat(descs).reshape(-1, T, arch.num_obj_per_frame,
                                              descs[0].shape[-1])
        lam, vw = self.lam, self.video_weight
        labels = video["labels"].long()
        for lo, hi in _rows(B, self.chunk):
            logits, extra = self._forward(clips[lo:hi],
                                          svit.rows_of(vmasks, lo, hi))
            nll = -F.log_softmax(logits, -1).gather(-1, labels[lo:hi, None])
            loss = lam["ce"] * nll.sum() / B
            if target is not None:
                d = extra["obj_desc"] - target[lo:hi]
                loss = loss + lam["con"] * d.abs().sum() / (d[0].numel() * B)
            loss = vw * loss
            loss.backward()
            total += float(loss.detach())
        if image is not None:
            before = {k: None if p.grad is None else p.grad.clone()
                      for k, p in self.P.items()}
            total += self._image(image, imasks)
            self.image_reached = {
                k for k, p in self.P.items() if p.grad is not None and (
                    before[k] is None or not torch.equal(before[k], p.grad))}
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.P.items()}
        norm = torch.sqrt(sum(g.double().square().sum()
                              for g in grads.values()))
        clip = float(cfg["SOLVER"]["CLIP_GRAD_L2NORM"] or 0.0)
        if clip and float(norm) >= clip:
            grads = {k: g * float(clip / norm) for k, g in grads.items()}
        self._adamw(grads)
        self.step_count += 1
        return {"loss": total, "grads": grads, "norm": float(norm)}

    def _image(self, image, masks) -> float:
        """The image branch, in blocks of rows, backward included; returns
        its weighted loss."""
        lam, iw = self.lam, self.image_weight
        frames = image["frames"]
        tar = image["haog_bboxes"].float()
        contact = image["contact_state"].long()
        Bi = frames.shape[0]
        present = 1.0 - (tar == 0).all(-1).float()          # [B, 1, O]
        n_sel = float(present.sum())
        per_sample = present[0].numel()
        contact_mask = (contact >= 0).float()
        n_contact = max(float(contact_mask.sum()), 1.0)
        total = 0.0
        for lo, hi in _rows(Bi, self.chunk * 2):
            _, extra = self._forward(frames[lo:hi], svit.rows_of(masks, lo,
                                                                  hi))
            pred = extra["pred_bboxes"]
            pm, t = present[lo:hi], tar[lo:hi]
            bce = F.binary_cross_entropy_with_logits(
                pred[..., 0], pm, reduction="none").sum() / (Bi * per_sample)
            loss = lam["bce"] * bce
            if n_sel > 0:
                l1 = ((pred[..., 1:] - t).abs().mean(-1) * pm).sum() / n_sel
                giou = ((1.0 - _giou(_xyxy(pred[..., 1:]), _xyxy(t))) * pm
                        ).sum() / n_sel
                loss = loss + lam["l1"] * l1 + lam["giou"] * giou
            logit = extra["pred_contact_state"].reshape(-1, 5)
            c = contact[lo:hi].reshape(-1)
            nll = -F.log_softmax(logit, -1).gather(
                -1, c.clamp(min=0)[:, None])[:, 0]
            loss = loss + lam["contact"] * (
                nll * contact_mask[lo:hi].reshape(-1)).sum() / n_contact
            loss = iw * loss
            loss.backward()
            total += float(loss.detach())
        return total

    @torch.no_grad()
    def _adamw(self, grads) -> None:
        cfg = self.cfg
        lr = lr_at(cfg, self.step_count, self.steps_per_epoch)
        wd = float(cfg["SOLVER"]["WEIGHT_DECAY"])
        t = self.step_count + 1
        b1, b2 = BETAS
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for k, p in self.P.items():
            g = grads[k]
            if self.decay[k]:
                p.mul_(1.0 - lr * wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + ADAM_EPS
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


@torch.no_grad()
def test_scores(cfg: dict, params: Dict[str, torch.Tensor], views,
                prec: str = "f32", chunk: int = 8) -> torch.Tensor:
    """The eval forward's softmax scores of ``views [N, T, H, W, 3]``, in
    blocks of ``chunk`` views."""
    arch = svit.arch_from_cfg(cfg)
    P = {k: v.float() for k, v in params.items()}
    return torch.cat([svit.forward(P, arch, views[lo:hi], None, prec)[0]
                      for lo, hi in _rows(views.shape[0], chunk)])
