"""The optimizer (counterpart of ``svit_tpu/models/optimizer.py``).

``SOLVER.OPTIMIZING_METHOD``, as the JAX package's optax chain:
- ``adamw`` (b1 0.9, b2 0.999, eps 1e-8) over two parameter groups, with
  and without weight decay, grouped as the reference groups them: a
  parameter takes no decay when its bare name is in
  ``no_weight_decay_names`` (only parameters at the model root can match,
  as in the reference's dotted-name check), or when
  ``SOLVER.ZERO_WD_1D_PARAM`` is set and it is 1-D or a bias;
- ``adam`` (``optax.adam``: the same moments, no decay);
- ``sgd``: the weight decay added to the gradient under the same groups
  (``optax.add_decayed_weights``), then SGD with ``SOLVER.MOMENTUM`` and
  ``SOLVER.NESTEROV`` (``optax.sgd``'s trace: ``t = g + m t``, the update
  ``t`` or, Nesterov, ``g + m t``).
The learning rate is a per-step table of the configured policy, set on the
groups before each update by ``Transform.apply``.  Clipping comes first:
``SOLVER.CLIP_GRAD_VAL`` clips each element to +-v (``optax.clip``),
else ``SOLVER.CLIP_GRAD_L2NORM`` matches ``optax.clip_by_global_norm``:
``g / ||g|| * max`` when ``||g|| >= max`` (``clip_grad_norm_`` adds 1e-6
to the norm and differs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from svit_tpu_torch.utils import lr_policy


def no_weight_decay_names(cfg) -> list:
    """The reference's ``SViT.no_weight_decay()`` bare-name list."""
    names: list = []
    if not cfg.MVIT.ZERO_DECAY_POS_CLS:
        return names
    if cfg.MVIT.USE_ABS_POS and cfg.MVIT.SEP_POS_EMBED:
        names += ["pos_embed_spatial", "pos_embed_class"]
    if cfg.MVIT.REL_POS_SPATIAL:
        names += ["rel_pos_h", "rel_pos_w", "rel_pos_hw"]
    if cfg.MVIT.REL_POS_TEMPORAL:
        names += ["rel_pos_t"]
    if cfg.MVIT.CLS_EMBED_ON:
        names += ["cls_token"]
    names += ["object_queries", "pos_embed_temporal"]
    return names


def wd_mask(named_params, zero_wd_1d: bool, skip_names: Sequence[str] = ()):
    """{name: True where weight decay applies} for ``named_parameters()``."""
    skip = frozenset(skip_names)
    mask = {}
    for name, p in named_params:
        if "." not in name and name in skip:
            mask[name] = False
        elif not zero_wd_1d:
            mask[name] = True
        else:
            mask[name] = not (name.rsplit(".", 1)[-1] == "bias" or p.dim() <= 1)
    return mask


def lr_table(cfg, steps_per_epoch: int) -> np.ndarray:
    """The learning rate of each step, ``MAX_EPOCH * steps_per_epoch + 2``
    entries; steps past the end take the last."""
    total = int(cfg.SOLVER.MAX_EPOCH * steps_per_epoch) + 2
    return np.array([lr_policy.get_lr_at_epoch(cfg, s / steps_per_epoch)
                     for s in range(total)], dtype=np.float32)


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place as ``optax.clip_by_global_norm``; returns
    the global norm before the clip.  No host sync: the choice is a
    ``where`` on the device."""
    norm = global_norm(grads)
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    div = torch.where(clip, norm, one)
    mul = torch.where(clip, torch.full_like(norm, max_norm), one)
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


def global_norm(grads) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all leaves together, in f32."""
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


@dataclasses.dataclass
class Transform:
    """What ``optax.chain(clip, adamw)`` is in the JAX package: the torch
    optimizer, its per-step learning-rate table and the clip norm."""

    optimizer: torch.optim.Optimizer
    lr_table: np.ndarray
    clip_l2norm: Optional[float] = None
    clip_value: Optional[float] = None

    def apply(self, params, step: int) -> torch.Tensor:
        """Clip the gradients of ``params``, step the optimizer at step
        ``step``'s learning rate; returns the global norm before the clip.
        A parameter without a gradient takes zeros, as under JAX's grad."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if self.clip_value:
            norm = global_norm(grads)
            for g in grads:
                g.clamp_(-self.clip_value, self.clip_value)
        elif self.clip_l2norm:
            norm = clip_by_global_norm(grads, self.clip_l2norm)
        else:
            norm = global_norm(grads)
        lr = float(self.lr_table[min(step, len(self.lr_table) - 1)])
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return norm


def construct_optimizer(cfg, model: torch.nn.Module, steps_per_epoch: int):
    """Return (transform, lr table), as the JAX package returns (optax
    transform, schedule)."""
    sol = cfg.SOLVER
    method = sol.OPTIMIZING_METHOD
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    mask = wd_mask(named, sol.ZERO_WD_1D_PARAM, no_weight_decay_names(cfg))
    groups = [g for g in (
        {"params": [p for n, p in named if mask[n]],
         "weight_decay": sol.WEIGHT_DECAY},
        {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
    ) if g["params"]]
    table = lr_table(cfg, steps_per_epoch)
    lr = float(table[0])
    if method == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif method == "adam":
        opt = torch.optim.Adam([p for _, p in named], lr=lr,
                               betas=(0.9, 0.999), eps=1e-8)
    elif method == "sgd":
        # torch's SGD adds the decay to the gradient before the momentum,
        # as add_decayed_weights does before optax.sgd; Nesterov without
        # momentum is plain SGD in optax and refused by torch
        opt = torch.optim.SGD(groups, lr=lr, momentum=sol.MOMENTUM,
                              nesterov=bool(sol.NESTEROV and sol.MOMENTUM))
    else:
        raise NotImplementedError(f"Does not support {method} optimizer")
    return Transform(opt, table, sol.CLIP_GRAD_L2NORM,
                     sol.CLIP_GRAD_VAL), table
