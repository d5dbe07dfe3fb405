"""Gradients of the forward kernels that have no backward kernel.

The JAX package differentiates its LN-linear kernels (``_lnqkv_bwd``,
``_lnd_bwd``, ``_res_bwd``, ``_resm_bwd`` in ``pallas_ffn.py``) by autodiff
of the plain reference, recomputed from the saved inputs.  ``kernel_vjp``
runs the kernel forward, saves only the inputs (not the hidden
activations) and hands them to a backward of the op's own
(``ops/ln_linear.py``: products on the tensor cores in the IO dtype).

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
