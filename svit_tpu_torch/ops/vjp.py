"""Gradients of the forward kernels that have no backward kernel.

The JAX package differentiates its LN-linear kernels (``_lnqkv_bwd``,
``_lnd_bwd``, ``_res_bwd``, ``_resm_bwd`` in ``pallas_ffn.py``) and its max
pool (``_pool_max_bwd`` in ``pallas_pool.py``) by autodiff of the plain
reference, recomputed from the saved inputs.  ``plain_vjp`` does the same:
the forward runs the kernel, only the inputs are saved (not the hidden
activations), and the backward recomputes the plain twin under
``torch.enable_grad()`` and takes its gradient.

Where no gradient is wanted (serving under ``inference_mode``, the train
step's no-grad consistency forward) every differentiable op calls its
kernel directly: ``needs_grad`` decides, so the autograd bookkeeping costs
the host nothing there.
"""

from __future__ import annotations

import torch


class _PlainVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, n_tensors, *args):
        tensors, static = args[:n_tensors], args[n_tensors:]
        ctx.plain, ctx.static = plain, static
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, *static)

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        wanted = ctx.needs_input_grad[3:3 + len(tensors)]
        with torch.enable_grad():
            inputs = [t if t is None else t.detach().requires_grad_(w)
                      for t, w in zip(tensors, wanted)]
            out = ctx.plain(*inputs, *ctx.static)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            leaves = [i for i, w in zip(inputs, wanted) if w]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], leaves, [g for _, g in pairs],
                allow_unused=True) if pairs and leaves else [None] * len(leaves))
        return (None, None, None,
                *[next(got) if w else None for w in wanted],
                *[None] * len(ctx.static))


def needs_grad(*tensors) -> bool:
    """Whether autograd will want a gradient of any of ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def plain_vjp(kernel, plain, tensors, *static):
    """``kernel(*tensors, *static)`` with the gradient of
    ``plain(*tensors, *static)`` recomputed from ``tensors``."""
    if not needs_grad(*tensors):
        return kernel(*tensors, *static)
    return _PlainVJP.apply(kernel, plain, len(tensors), *tensors, *static)
