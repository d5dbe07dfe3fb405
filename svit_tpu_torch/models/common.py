"""Shared model building blocks (counterpart of ``svit_tpu/models/common.py``).

``LayerNorm`` normalises in f32 with eps **1e-6** (the reference's value; the
PyTorch default is 1e-5).  ``Mlp`` holds the block's two dense layers; its
forward is exact-erf GELU between them and runs through the K1 epilogue
(``ops/ln_linear.py``) or, for the extras stream, ``ln_linear.ffn``.

``keep_mask`` and ``dropout`` draw the train mode's random numbers from an
explicit ``torch.Generator`` (or, under data parallelism, the global
batch's draws of one, ``parallel/mesh.py:GlobalDraws``; under
``TPU.REMAT``, a block's ``KeptDraws``).  Their streams cannot match
JAX's, so the tests feed both sides the same masks or run with the rates
at 0.

``StepCache`` holds what a train step derives from its parameters once and
shares between its three forwards (``cast``, ``derived``).
"""

from __future__ import annotations

import torch
from torch import nn

from svit_tpu_torch.ops.ln_linear import EPS, layer_norm
from svit_tpu_torch.parallel.mesh import rand


def keep_mask(shape, keep: float, generator, device) -> torch.Tensor:
    """f32 0/1 mask, 1 with probability ``keep`` (``jax.random.bernoulli``:
    uniform < keep)."""
    if isinstance(generator, KeptDraws):
        return generator.keep_mask(shape, keep, device)
    u = rand(shape, generator, device)
    return (u < keep).float()


def dropout(x: torch.Tensor, rate: float, generator,
            columns=None) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(mask, x / keep, 0)`` in x's dtype.
    ``columns`` (index, count): ``x`` holds share ``index`` of ``count``
    equal runs of its last dim (a tensor-parallel shard of the MLP's hidden
    width); the mask is drawn for the whole width and cut to the share, so
    that it does not depend on the mesh."""
    keep = 1.0 - rate
    if columns is None:
        mask = keep_mask(x.shape, keep, generator, x.device).bool()
    else:
        index, count = columns
        n = x.shape[-1]
        mask = keep_mask((*x.shape[:-1], n * count), keep, generator,
                         x.device).bool()[..., index * n:(index + 1) * n]
    return torch.where(mask, x / float(torch.tensor(keep, dtype=x.dtype)),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class KeptDraws:
    """One block's random draws under ``TPU.REMAT``, made once and handed
    out again.  The block runs twice, its forward and then its recompute
    in the backward (``models/svit.py``): the first run draws each mask
    from ``generator`` (a ``torch.Generator`` or ``GlobalDraws``) and keeps
    it, every later run gets the kept masks in the same order.  So both
    runs see the same masks and the generator advances once, as with remat
    off, and no generator state is set back (which a CUDA graph's capture
    does not allow).  A mask is kept as bool: a byte an element."""

    def __init__(self, generator):
        self.generator = generator
        self.kept: list = []
        self.runs, self.at = 0, 0

    def start(self) -> None:
        """Begin a run of the block."""
        self.runs += 1
        self.at = 0

    def keep_mask(self, shape, keep: float, device) -> torch.Tensor:
        if self.runs == 1:
            mask = keep_mask(shape, keep, self.generator, device)
            self.kept.append(mask.bool())
            return mask
        mask = self.kept[self.at]
        self.at += 1
        return mask.float()


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


def _as_is(t):
    return t


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

    Under ``TPU.REMAT`` a block's recompute takes the same casts and
    derived values (no second cast, and each use still its own node).

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
            # what fn saves for its backward is kept as it is, also inside
            # a block that ``TPU.REMAT`` recomputes: the recompute takes the
            # cached value and does not run fn again
            with torch.enable_grad(), \
                    torch.autograd.graph.saved_tensors_hooks(_as_is, _as_is):
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
        # the model group when fc1 and fc2 hold this rank's shards
        # (parallel/mesh.py:shard_model)
        self.tp = None
