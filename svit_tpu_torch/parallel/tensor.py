"""The tensor-parallel MLP (``TPU.MESH_MODEL > 1``), Megatron style: the
JAX package shards ``fc1`` by columns and ``fc2`` by rows
(``svit_tpu/parallel/mesh.py:_param_spec``) and lets GSPMD place the
collectives; here they are written out.

Each rank of a model group holds ``fc1``'s columns and ``fc2``'s rows of
one share of the hidden width (``mesh.shard_model``).  The residual tail
of a block then runs, per rank:

1. K1's first launch as on one card, on this rank's columns: ``(x_res +
   a) -> LN -> fc1 + b1 -> GELU``, writing h and the sum s;
2. K1's second launch on this rank's rows in its f32 mode
   (``ln_linear(..., out_f32=True)``): the product alone, with no bias,
   rounding, drop-path mask or residual;
3. an all-reduce of that f32 partial over the model group, then ``+ b2``
   in f32, one rounding to bf16, the drop-path mask and ``+ s``: the op
   order of the one-card tail, with the hidden sum split across ranks
   (the f32 sums differ in order only).

The conjugate collectives (Megatron's f and g): the all-reduce after fc2
is the forward's (its backward is the identity), and the gradient of the
LN'd input, which each rank computes from its own columns, is all-reduced
in f32 before the LN's backward (the forward's identity).  The extras'
FFN (plain products) splits the same way.

The unfused tail (``MVIT.DROPOUT_RATE > 0`` in train mode, or
``MVIT.DIM_MUL_IN_ATT=False`` at a change of width: plain products in the
JAX package too) splits its MLP alike: ``dense_columns`` gives fc1's
columns of this rank, its input's gradient summed over the group in f32
before its one rounding (f), and ``dense_rows`` sums fc2's f32 partials
over the group before the rounding and the bias (g).  The hidden dropout
draws the whole width's mask and keeps this rank's columns (``columns``);
the rest of the tail (the attention's and the output's dropout, the
residual's projection of the normed stream) is replicated, each rank of
the group drawing alike.  On one card, or at ``MESH_MODEL`` 1, none of
this runs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from svit_tpu_torch.ops import ln_linear as ll
from svit_tpu_torch.ops.vjp import kernel_vjp


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in place (no autograd)."""
    dist.all_reduce(t, group=group)
    return t


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _partial(op, x, x_add, ln_w, ln_b, w1, b1, w2, ma, keep, rows):
    """This rank's f32 partial of ``mlp(LN(x + x_add))`` and the sum s
    (None without ``x_add``): ``op`` twice (K1's ``ln_linear`` or its
    plain twin), or with no ``op`` the plain products of ``ll.ffn``."""
    if op is None:
        h = ll.ln_linear_mm(x, w1, b1, ln=(ln_w, ln_b), gelu=True)
        return ll._mm(h, w2.t()), None
    first = op(x, w1, b1, ln=(ln_w, ln_b), x_add=x_add, gelu=True,
               mask_add=ma, keep=keep, rows=rows)
    h, s = first if x_add is not None else (first, None)
    return op(h, w2, out_f32=True), s


def _partial_vjp(group, rows, keep):
    """Backward of ``_partial``: ``_ffn_vjp``'s arithmetic on this rank's
    columns, with the LN'd input's gradient summed over the model group in
    f32 and rounded once."""

    def backward(tensors, static, grads, wanted):
        x, x_add, ln_w, ln_b, w1, b1, w2, ma = tensors
        leaves, s, xn = ll._prologue(x, x_add, (ln_w, ln_b), ma, keep, rows)
        xd = xn.detach()
        z = ll._mm(xd, w1.t()) + b1.float()
        h = torch.nn.functional.gelu(z).to(xd.dtype)
        dh, dw2 = ll._dense_bwd(h, w2, grads[0].float(), wanted[6])
        dz = ll._gelu_bwd(dh, z)
        gz = dz.to(xd.dtype)
        dxn = all_reduce(ll._mm(gz, w1), group).to(xd.dtype)
        dw1 = ll._mm(gz.t(), xd).to(w1.dtype) if wanted[4] else None
        outs, cots = [xn], [dxn]
        if x_add is not None and grads[1] is not None:
            outs, cots = [xn, s], [dxn, grads[1]]
        gp = ll._prologue_grads(leaves, outs, cots, wanted[:4])
        db1 = dz.sum(0) if wanted[5] else None
        return [*gp, dw1, db1, dw2, None]

    return backward


def ffn_partial(x, ln_w, ln_b, w1, b1, w2, group, x_add=None, ma=None,
                keep=1.0, rows=1, op=ll.ln_linear):
    """(f32 partial [M, N] of this rank's hidden columns, s or None) for
    ``x`` [M, K] (and ``x_add``), differentiable; the gradient of the LN'd
    input is summed over ``group``."""
    return kernel_vjp(
        lambda *t: _partial(op, *t, keep, rows), _partial_vjp(
            group, rows, keep), (x, x_add, ln_w, ln_b, w1, b1, w2, ma))


def _tail(p, b2, dtype, my, keep, rows, residual, group):
    y = (_ReduceFromModel.apply(p, group) + b2.float()).to(dtype)
    if my is not None:
        y = ll.drop_path_scale(y, my, keep, rows)
    return y if residual is None else y + residual


def ffn_residual(group, x_res, a, ln_w, ln_b, w1, b1, w2, b2, ma=None,
                 my=None, keep=1.0, op=ll.ln_linear):
    """The block's residual tail on the grid, its MLP sharded over
    ``group`` (``fused_ffn_residual`` and, with the masks,
    ``fused_ffn_residual_masked``); ``op`` is K1 or its plain twin."""
    rows = x_res[0].numel() // x_res.shape[-1]
    p, s = ffn_partial(ll._flat(x_res), ln_w, ln_b, w1, b1, w2, group,
                       x_add=ll._flat(a), ma=ma, keep=keep, rows=rows, op=op)
    return _tail(p, b2, x_res.dtype, my, keep, rows, s, group).view(
        *x_res.shape[:-1], w2.shape[0])


def columns(group) -> tuple:
    """(this rank's index, the ranks) of the model ``group``: the share of
    a hidden width that ``mesh.shard_model`` gave this rank."""
    return dist.get_rank(group), dist.get_world_size(group)


def _columns_vjp(group):
    """Backward of ``dense_columns``: ``ll._dense_vjp``'s arithmetic on
    this rank's columns, the input's gradient summed over ``group`` in f32
    and rounded once."""

    def backward(tensors, static, grads, wanted):
        x, w, b = tensors
        gy = ll._flat(grads[0])
        dx = dw = db = None
        if wanted[0]:
            dx = all_reduce(ll._mm(gy, w), group).to(x.dtype).view(x.shape)
        if wanted[1]:
            dw = ll._mm(gy.t(), ll._flat(x)).to(w.dtype)
        if wanted[2]:
            db = gy.sum(0).to(b.dtype)
        return [dx, dw, db]

    return backward


def dense_columns(group, x, w, b):
    """``ll.dense(x, w, b)`` on this rank's output columns (``fc1``'s
    shard): the forward one card's on them, the gradient of ``x`` summed
    over ``group``."""
    return kernel_vjp(
        lambda x, w, b: ll.ln_linear_mm(
            ll._flat(x), w, b, round_then_bias=True).view(
                *x.shape[:-1], w.shape[0]),
        _columns_vjp(group), (x, w.to(x.dtype), b))


def dense_rows(group, x, w, b):
    """``ll.dense(x, w, b)`` with ``x`` and ``w`` holding this rank's share
    of the input width (``fc2``'s shard): the f32 partial products summed
    over ``group``, then rounded and ``+ b`` in the IO dtype as on one card;
    the backward is one card's on this rank's share."""
    def forward(x, ln_w, ln_b, w, b):
        acc = all_reduce(ll._mm(ll._flat(x), w.t()), group)
        return (acc.to(x.dtype) + b.to(x.dtype)).view(*x.shape[:-1],
                                                      w.shape[0])

    return kernel_vjp(forward, ll._dense_vjp,
                      (x, None, None, w.to(x.dtype), b))


def ffn(group, x, ln_w, ln_b, w1, b1, w2, b2):
    """LN + MLP without residual (the extras' FFN, ``ll.ffn``), sharded
    over ``group``: plain products on IO-dtype operands."""
    p, _ = ffn_partial(ll._flat(x), ln_w, ln_b, w1, b1, w2, group, op=None)
    return _tail(p, b2, x.dtype, None, 1.0, 1, None, group).view(
        *x.shape[:-1], w2.shape[0])
