"""Gradients of the forward kernels that have no backward kernel.

The JAX package differentiates its LN-linear kernels (``_lnqkv_bwd``,
``_lnd_bwd``, ``_res_bwd``, ``_resm_bwd`` in ``pallas_ffn.py``) and its max
pool (``_pool_max_bwd`` in ``pallas_pool.py``) by autodiff of the plain
reference, recomputed from the saved inputs.  ``kernel_vjp`` runs the
kernel forward, saves only the inputs (not the hidden activations) and
hands them to a backward of the op's own (``ops/ln_linear.py``: products
on the tensor cores in the IO dtype).  ``plain_vjp`` is the kernel_vjp
whose backward recomputes the plain twin under ``torch.enable_grad()`` and
takes its gradient (the max pool).

Where no gradient is wanted (serving under ``inference_mode``, the train
step's no-grad consistency forward) every differentiable op calls its
kernel directly: ``needs_grad`` decides, so the autograd bookkeeping costs
the host nothing there.
"""

from __future__ import annotations

import torch


class _KernelVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, backward, n_tensors, *args):
        tensors, static = args[:n_tensors], args[n_tensors:]
        ctx.backward_fn, ctx.static = backward, static
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, *static)

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        wanted = ctx.needs_input_grad[3:3 + len(tensors)]
        got = ctx.backward_fn(tensors, ctx.static, grads, wanted)
        return (None, None, None,
                *[g if w else None for g, w in zip(got, wanted)],
                *[None] * len(ctx.static))


def needs_grad(*tensors) -> bool:
    """Whether autograd will want a gradient of any of ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def kernel_vjp(kernel, backward, tensors, *static):
    """``kernel(*tensors, *static)``, differentiated by ``backward(tensors,
    static, grads, wanted)``, which returns one gradient (or None) per
    tensor; ``grads`` holds one cotangent (or None) per output."""
    if not needs_grad(*tensors):
        return kernel(*tensors, *static)
    return _KernelVJP.apply(kernel, backward, len(tensors), *tensors, *static)


def _plain_backward(plain):
    def backward(tensors, static, grads, wanted):
        with torch.enable_grad():
            inputs = [t if t is None else t.detach().requires_grad_(w)
                      for t, w in zip(tensors, wanted)]
            out = plain(*inputs, *static)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            leaves = [i for i, w in zip(inputs, wanted) if w]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], leaves, [g for _, g in pairs],
                allow_unused=True) if pairs and leaves else [None] * len(leaves))
        return [next(got) if w else None for w in wanted]
    return backward


def plain_vjp(kernel, plain, tensors, *static):
    """``kernel(*tensors, *static)`` with the gradient of
    ``plain(*tensors, *static)`` recomputed from ``tensors``."""
    return kernel_vjp(kernel, _plain_backward(plain), tensors, *static)
