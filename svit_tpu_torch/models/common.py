"""Shared model building blocks (counterpart of ``svit_tpu/models/common.py``).

``LayerNorm`` normalises in f32 with eps **1e-6** (the reference's value; the
PyTorch default is 1e-5).  ``Mlp`` holds the block's two dense layers; its
forward is exact-erf GELU between them and runs through the K1 epilogue
(``ops/ln_linear.py``) or, for the extras stream, ``ln_linear.ffn``.

``keep_mask`` and ``dropout`` draw the train mode's random numbers from an
explicit ``torch.Generator``.  Their streams cannot match JAX's, so the
tests feed both sides the same masks or run with the rates at 0.

``StepCache`` holds what a train step derives from its parameters once and
shares between its three forwards (``cast``, ``derived``).
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


class _OneUse(torch.autograd.Function):
    """One use of a cast made once per step: the forward hands out the
    cast; the backward hands the use's cotangent back in the master's
    dtype, as the use's own cast (``w.to(dtype)``) would."""

    @staticmethod
    def forward(ctx, master, cast):
        ctx.dtype = master.dtype
        return cast.view_as(cast)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class StepCache:
    """What a train step derives from its parameters once and shares
    between its three forwards (the consistency frames, the video, the
    image), where the JAX package converts per use:

    - ``cast``: a weight in the compute dtype.  Each use gets its own
      autograd node (``_OneUse``), so each use's cotangent reaches the f32
      master on its own and the master sums them in f32, as the per-use
      converts' transposes do (one shared bf16 tensor would sum them in
      bf16 first); the gradient is the per-use form's, bit for bit;
    - ``derived``: an f32 function of parameters (the pool filters tiled
      over heads, their LN parameters, the object-token multipliers), one
      autograd node that the uses share (their cotangents are summed in f32
      before its backward).  It is built with grad enabled even when the
      first use runs under ``no_grad``.

    One cache per step: it holds its tensors' autograd graph."""

    def __init__(self):
        self._casts, self._derived = {}, {}

    def cast(self, w, dtype):
        key = (id(w), dtype)
        c = self._casts.get(key)
        if c is None:
            c = self._casts[key] = w.detach().to(dtype)
        if torch.is_grad_enabled() and w.requires_grad:
            return _OneUse.apply(w, c)
        return c

    def derived(self, key, fn):
        v = self._derived.get(key)
        if v is None:
            with torch.enable_grad():
                v = self._derived[key] = fn()
        return v if torch.is_grad_enabled() else v.detach()


def cast(w, dtype, cache=None):
    """``w`` in ``dtype``: once a step through ``cache``, else per use."""
    return w.to(dtype) if cache is None else cache.cast(w, dtype)


def derived(key, fn, cache=None):
    """``fn()``: once a step through ``cache`` (under ``key``), else per
    use."""
    return fn() if cache is None else cache.derived(key, fn)


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
