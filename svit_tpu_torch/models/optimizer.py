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
The learning rate is a per-step table of the configured policy.  It lives
on the device, as optax reads its schedule at the state's count inside the
jitted step: every parameter group holds one 0-dim f32 tensor ``lr``, and
``Transform.apply`` writes into it the table's entry at a device step
counter, so that a CUDA graph of the step reads each replay's rate
(``engine/graphs.py``).  AdamW and Adam run with ``capturable=True`` on the
card (their step count on the device too); SGD runs torch's fused kernel,
which takes a tensor rate (its foreach form reads the rate on the host).
On the CPU, where torch refuses ``capturable=True``, the same tensor-rate
path runs without it.  Clipping comes first:
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
    optimizer, its per-step learning-rate table and the clip norm.

    ``lr`` is the tensor every parameter group holds; ``lr_table_t`` the
    table on the device and ``step_t`` the device step counter that
    ``apply`` reads it at.  ``set_step`` writes the host's step into the
    counter: outside a CUDA graph, before each replay."""

    optimizer: torch.optim.Optimizer
    lr_table: np.ndarray
    clip_l2norm: Optional[float] = None
    clip_value: Optional[float] = None

    def __post_init__(self):
        self.lr = self.optimizer.param_groups[0]["lr"]
        if not all(g["lr"] is self.lr for g in self.optimizer.param_groups):
            raise ValueError("every parameter group must hold the one lr "
                             "tensor")
        self.lr_table_t = torch.as_tensor(self.lr_table, dtype=torch.float32,
                                          device=self.lr.device)
        self.step_t = torch.zeros((), dtype=torch.int64,
                                  device=self.lr.device)

    def set_step(self, step: int) -> None:
        """The counter at ``step``; steps past the table's end take its
        last entry."""
        self.step_t.fill_(min(int(step), len(self.lr_table) - 1))

    def apply(self, params, step: Optional[int] = None) -> torch.Tensor:
        """Clip the gradients of ``params``, step the optimizer at the
        learning rate of the counter's step (``step``, when given, is set
        first); returns the global norm before the clip.  A parameter
        without a gradient takes zeros, as under JAX's grad.  No host sync:
        the rate is gathered on the device."""
        if step is not None:
            self.set_step(step)
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
        self.lr.copy_(torch.index_select(self.lr_table_t, 0,
                                         self.step_t.view(1))[0])
        self.optimizer.step()
        return norm

    def load_state_dict(self, saved) -> None:
        """The optimizer's state from ``saved``; the groups keep this
        transform's ``lr`` tensor and their device flags (torch's loader
        puts the saved group values in their place)."""
        keep = [{k: g[k] for k in ("capturable", "fused", "foreach")
                 if k in g} for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(saved)
        for g, flags in zip(self.optimizer.param_groups, keep):
            g.update(flags)
            g["lr"] = self.lr

    def state_tensors(self) -> list:
        """Every tensor of the optimizer's state (moments, step counts,
        momentum buffers), in a fixed order."""
        out = []
        for p in (p for g in self.optimizer.param_groups for p in g["params"]):
            st = self.optimizer.state.get(p, {})
            out.extend(st[k] for k in sorted(st) if torch.is_tensor(st[k]))
        return out


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
    device = named[0][1].device
    lr = torch.tensor(float(table[0]), dtype=torch.float32, device=device)
    capturable = device.type == "cuda"
    if method == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                capturable=capturable)
    elif method == "adam":
        opt = torch.optim.Adam([p for _, p in named], lr=lr,
                               betas=(0.9, 0.999), eps=1e-8,
                               capturable=capturable)
    elif method == "sgd":
        # torch's SGD adds the decay to the gradient before the momentum,
        # as add_decayed_weights does before optax.sgd; Nesterov without
        # momentum is plain SGD in optax and refused by torch
        opt = torch.optim.SGD(groups, lr=lr, momentum=sol.MOMENTUM,
                              nesterov=bool(sol.NESTEROV and sol.MOMENTUM),
                              fused=True)
    else:
        raise NotImplementedError(f"Does not support {method} optimizer")
    return Transform(opt, table, sol.CLIP_GRAD_L2NORM,
                     sol.CLIP_GRAD_VAL), table
