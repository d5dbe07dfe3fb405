"""Shared model building blocks (counterpart of ``svit_tpu/models/common.py``).

``LayerNorm`` normalises in f32 with eps **1e-6** (the reference's value; the
PyTorch default is 1e-5).  ``Mlp`` holds the block's two dense layers; its
forward is exact-erf GELU between them and runs through the K1 epilogue
(``ops/ln_linear.py``) or, for the extras stream, ``ln_linear.ffn``.

``keep_mask`` and ``dropout`` draw the train mode's random numbers from an
explicit ``torch.Generator``.  Their streams cannot match JAX's, so the
tests feed both sides the same masks or run with the rates at 0.
"""

from __future__ import annotations

import torch
from torch import nn

from svit_tpu_torch.ops.ln_linear import EPS, layer_norm


def keep_mask(shape, keep: float, generator, device) -> torch.Tensor:
    """f32 0/1 mask, 1 with probability ``keep`` (``jax.random.bernoulli``:
    uniform < keep)."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u < keep).float()


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(mask, x / keep, 0)`` in x's dtype."""
    keep = 1.0 - rate
    mask = keep_mask(x.shape, keep, generator, x.device).bool()
    return torch.where(mask, x / float(torch.tensor(keep, dtype=x.dtype)),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class LayerNorm(nn.Module):
    """Last-axis LayerNorm computed in f32, returned in the input dtype."""

    def __init__(self, dim: int, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 parameters (``mlp.fc1`` / ``mlp.fc2``)."""

    def __init__(self, dim_in: int, hidden: int, dim_out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim_in, hidden)
        self.fc2 = nn.Linear(hidden, dim_out)
