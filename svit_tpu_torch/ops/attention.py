"""Pooled attention: kernel K4 and the rel-pos bias inputs (counterpart of
``svit_tpu/ops/pallas_attention.py``).

``pooled_attention`` computes, per head,

    out = softmax((q * scale) K^T + bias) V        (softmax in f32)

then rounds the head outputs to the IO dtype and, with ``q_residual``, adds
the unscaled q in the IO dtype (the reference's residual pooling).  q is
``[B, Nq, C]`` and the keys and values arrive as one ``[B, Nk, 2C]`` tensor
(keys in channels ``[0, C)``, values in ``[C, 2C)``), with ``C = heads *
head_dim``.

The decomposed rel-pos bias enters by gather: for a patch key ``j < k_l``
with grid position ``(t, h, w)`` in ``k_shape`` the bias is
``bias_src[q, t] + bias_src[q, kT + h] + bias_src[q, kT + kH + w]``; the
keys after the patches (cls and object tokens) get 0.  That is exactly the
JAX package's ``bias_src @ M`` with its one-hot scatter matrix, without the
matrix.  ``bias_src=None`` is the extras launch: no rel-pos bias at all.

``fused_attention_proj`` adds the out-projection as a separate K1 launch
(``ln_linear.linear_proj``): the product is rounded, then the bias is added
in the IO dtype, as the TPU kernel's epilogue did.

Both are differentiable.  The backward is kernel K5
(``pooled_attention_bwd``, ``csrc/attention.cu``): it recomputes the
probabilities from the saved q, kv and bias and returns dq, dkv and the
rel-pos bias gradient.  Around the projection it follows JAX ``_bwd_proj``:
``dbp`` and ``dwp`` in PyTorch, ``dbase = round(g @ wp)``, then K5 on dbase,
which under ``q_residual`` also adds ``dbase`` to dq.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from svit_tpu_torch.ops import _lib, ln_linear
from svit_tpu_torch.ops import rel_pos as rp
from svit_tpu_torch.ops.vjp import needs_grad

Triple = Tuple[int, int, int]


def build_bias_inputs_grid(
    q_grid: torch.Tensor,         # [B, Tq, Hq, Wq, heads*hd], pooled + normed
    num_heads: int,
    q_shape: Triple,
    k_shape: Triple,
    *,
    rel_pos_h: Optional[torch.Tensor],
    rel_pos_w: Optional[torch.Tensor],
    rel_pos_t: Optional[torch.Tensor],
) -> torch.Tensor:
    """bias_src ``[B, heads, q_l, kT + kH + kW]`` in ``q_grid``'s dtype.

    Each term is an einsum of the queries against a rel-pos table with f32
    accumulation, rounded to the IO dtype (missing tables give zeros)."""
    B, Tq, Hq, Wq, C = q_grid.shape
    hd = C // num_heads
    k_t, k_h, k_w = k_shape
    dt = q_grid.dtype
    rq = q_grid.reshape(B, Tq, Hq, Wq, num_heads, hd).float()
    zeros = q_grid.new_zeros

    def term(eq, table):
        return torch.einsum(eq, rq, table.to(dt).float()).to(dt)

    terms = []
    if rel_pos_t is not None:
        terms.append(term("btpwhc,tuc->bhtpwu",
                          rp.rel_table(rel_pos_t, q_shape[0], k_t)))
    else:
        terms.append(zeros((B, num_heads, Tq, Hq, Wq, k_t)))
    if rel_pos_h is not None:
        terms.append(term("btpwhc,pkc->bhtpwk",
                          rp.rel_table(rel_pos_h, q_shape[1], k_h)))
        terms.append(term("btpwhc,wkc->bhtpwk",
                          rp.rel_table(rel_pos_w, q_shape[2], k_w)))
    else:
        terms.append(zeros((B, num_heads, Tq, Hq, Wq, k_h)))
        terms.append(zeros((B, num_heads, Tq, Hq, Wq, k_w)))
    q_l = Tq * Hq * Wq
    return torch.cat(
        [t.reshape(B, num_heads, q_l, t.shape[-1]) for t in terms], dim=-1
    ).contiguous()


def _gather_bias(bias_src, k_shape, n_k):
    """The dense ``[B, heads, Nq, n_k]`` f32 bias of the gather rule."""
    k_t, k_h, k_w = k_shape
    j = torch.arange(k_t * k_h * k_w, device=bias_src.device)
    bf = bias_src.float()
    dense = (bf[..., j // (k_h * k_w)] + bf[..., k_t + (j // k_w) % k_h]
             + bf[..., k_t + k_h + j % k_w])
    return torch.nn.functional.pad(dense, (0, n_k - dense.shape[-1]))


def pooled_attention_reference(q, kv, bias_src, k_shape: Triple, scale: float,
                               heads: int, q_residual: bool = False):
    """Plain twin of ``pooled_attention`` (the JAX ``reference_attention``
    arithmetic: f32 logits, f32 softmax, probabilities rounded to the IO
    dtype before the value product)."""
    B, Nq, C = q.shape
    Nk = kv.shape[1]
    hd = C // heads
    dt = q.dtype

    def split_heads(t):
        return t.reshape(B, t.shape[1], heads, hd).transpose(1, 2)

    qh = split_heads(q) * torch.tensor(scale, dtype=dt)
    kh = split_heads(kv[..., :C])
    vh = split_heads(kv[..., C:])
    logits = qh.float() @ kh.float().transpose(-1, -2)
    if bias_src is not None:
        logits = logits + _gather_bias(bias_src, k_shape, Nk)
    p = torch.softmax(logits, dim=-1)
    out = (p.to(dt).float() @ vh.float()).to(dt)
    out = out.transpose(1, 2).reshape(B, Nq, C)
    return out + q if q_residual else out


def pooled_attention_fwd(q, kv, bias_src, k_shape: Triple, scale: float,
                    heads: int, q_residual: bool = False):
    """Kernel K4 (``csrc/attention.cu``), the forward alone: flash-style
    online softmax over key tiles, one block per (batch, 64-query tile,
    head).  Returns [B, Nq, C]."""
    if q.device.type == "cpu":
        return pooled_attention_reference(q, kv, bias_src, k_shape, scale,
                                          heads, q_residual)
    B, Nq, C = q.shape
    Nk = kv.shape[1]
    dt = torch.bfloat16
    _lib.check(q, "q", dt)
    _lib.check(kv, "kv", dt, (B, Nk, 2 * C), q.device)
    hd = C // heads
    if C % heads or hd not in (64, 96, 128):
        raise ValueError(f"pooled_attention takes head_dim 64, 96 or 128 "
                         f"(C={C}, heads={heads})")
    k_t, k_h, k_w = k_shape if bias_src is not None else (0, 0, 0)
    if bias_src is not None:
        _lib.check(bias_src, "bias_src", dt, (B, heads, Nq, k_t + k_h + k_w),
                   q.device)
        if k_t * k_h * k_w > Nk:
            raise ValueError(f"k_shape {k_shape} holds more keys than Nk={Nk}")
    out = torch.empty_like(q)
    if q.numel():
        _lib.launch(
            "svit_pooled_attention", "pooled_attention",
            _lib.ptr(q), _lib.ptr(kv), _lib.ptr(bias_src), _lib.ptr(out),
            B, Nq, Nk, C, heads, k_t, k_h, k_w, float(scale),
            int(q_residual), _lib.stream())
    return out


def _bias_grad(ds, k_shape: Triple):
    """JAX's ``dS M^T`` without the scatter matrix: ``ds [..., Nk]`` summed
    over the patch keys that share each temporal, row and column index."""
    k_t, k_h, k_w = k_shape
    grid = ds[..., :k_t * k_h * k_w].unflatten(-1, (k_t, k_h, k_w))
    return torch.cat([grid.sum((-2, -1)), grid.sum((-3, -1)),
                      grid.sum((-3, -2))], dim=-1)


def pooled_attention_bwd_reference(q, kv, bias_src, do, k_shape: Triple,
                                   scale: float, heads: int,
                                   q_residual: bool = False):
    """Plain twin of ``pooled_attention_bwd``, step by step as JAX
    ``_attn_bwd_kernel``: P recomputed in f32 from (q * scale in the IO
    dtype) K^T + bias; dP = dO V^T; delta = rowsum(dP o P); dS = P o (dP -
    delta); dq = round(dS) K * scale; dK = round(dS)^T (q * scale); dV =
    round(P)^T dO; dbias the scatter of dS (f32) onto the bias columns.
    Returns (dq, dkv, dbias or None) in the IO dtype; with ``q_residual``,
    dq + dO."""
    B, Nq, C = q.shape
    Nk = kv.shape[1]
    hd = C // heads
    dt = q.dtype

    def split_heads(t):
        return t.reshape(B, t.shape[1], heads, hd).transpose(1, 2).float()

    qs = split_heads(q * torch.tensor(scale, dtype=dt))
    kh, vh = split_heads(kv[..., :C]), split_heads(kv[..., C:])
    doh = split_heads(do)
    logits = qs @ kh.transpose(-1, -2)
    if bias_src is not None:
        logits = logits + _gather_bias(bias_src, k_shape, Nk)
    p = torch.softmax(logits, dim=-1)
    dp = doh @ vh.transpose(-1, -2)
    delta = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dsr = ds.to(dt).float()
    dq = (dsr @ kh) * scale
    dk = dsr.transpose(-1, -2) @ qs
    dv = p.to(dt).float().transpose(-1, -2) @ doh

    def merge(t):
        return t.transpose(1, 2).reshape(B, t.shape[2], C)

    dq = merge(dq).to(dt)
    if q_residual:
        dq = dq + do
    dkv = torch.cat([merge(dk), merge(dv)], dim=-1).to(dt)
    dbias = None if bias_src is None else _bias_grad(ds, k_shape).to(dt)
    return dq, dkv, dbias


def pooled_attention_bwd(q, kv, bias_src, do, k_shape: Triple, scale: float,
                         heads: int, q_residual: bool = False):
    """Kernel K5 (``csrc/attention.cu``): the gradient of
    ``pooled_attention`` with respect to q, kv and bias_src, for the output
    cotangent ``do`` [B, Nq, C].  Same contract as the plain twin."""
    if q.device.type == "cpu":
        return pooled_attention_bwd_reference(q, kv, bias_src, do, k_shape,
                                              scale, heads, q_residual)
    B, Nq, C = q.shape
    Nk = kv.shape[1]
    dt = torch.bfloat16
    _lib.check(q, "q", dt)
    _lib.check(kv, "kv", dt, (B, Nk, 2 * C), q.device)
    _lib.check(do, "do", dt, (B, Nq, C), q.device)
    hd = C // heads
    if C % heads or hd not in (64, 96, 128):
        raise ValueError(f"pooled_attention_bwd takes head_dim 64, 96 or 128 "
                         f"(C={C}, heads={heads})")
    k_t, k_h, k_w = k_shape if bias_src is not None else (0, 0, 0)
    if bias_src is not None:
        _lib.check(bias_src, "bias_src", dt, (B, heads, Nq, k_t + k_h + k_w),
                   q.device)
        if k_t * k_h * k_w > Nk:
            raise ValueError(f"k_shape {k_shape} holds more keys than Nk={Nk}")
    # enough key-side blocks to fill the card twice: split the query tiles
    key_blocks = -(-Nk // 64) * heads * B
    splits = max(1, min(-(-Nq // 64),
                        -(-2 * _lib.sm_count(q.device) // key_blocks)))
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv)
    dbias = torch.empty_like(bias_src) if bias_src is not None else None
    stats = torch.empty((B, heads, Nq, 3), dtype=torch.float32,
                        device=q.device)
    partial = torch.empty((splits, B, Nk, 2 * C), dtype=torch.float32,
                          device=q.device)
    if q.numel():
        _lib.launch(
            "svit_pooled_attention_bwd", "pooled_attention_bwd",
            _lib.ptr(q), _lib.ptr(kv), _lib.ptr(bias_src), _lib.ptr(do),
            _lib.ptr(dq), _lib.ptr(dkv), _lib.ptr(dbias), _lib.ptr(stats),
            _lib.ptr(partial), B, Nq, Nk, C, heads, k_t, k_h, k_w,
            float(scale), int(q_residual), splits, _lib.stream())
    return dq, dkv, dbias


class _AttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias_src, k_shape, scale, heads, q_residual):
        ctx.args = (tuple(k_shape), scale, heads, q_residual)
        ctx.save_for_backward(q, kv, bias_src)
        return pooled_attention_fwd(q, kv, bias_src, k_shape, scale, heads,
                                    q_residual)

    @staticmethod
    def backward(ctx, g):
        q, kv, bias_src = ctx.saved_tensors
        dq, dkv, dbias = pooled_attention_bwd(q, kv, bias_src, g.contiguous(),
                                              *ctx.args)
        return dq, dkv, dbias, None, None, None, None


def pooled_attention(q, kv, bias_src, k_shape: Triple, scale: float,
                     heads: int, q_residual: bool = False):
    """Kernel K4; differentiable through K5."""
    if not needs_grad(q, kv, bias_src):
        return pooled_attention_fwd(q, kv, bias_src, k_shape, scale, heads,
                                    q_residual)
    return _AttentionFn.apply(q, kv, bias_src, k_shape, scale, heads,
                              q_residual)


class _AttentionProjFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias_src, wp, bp, k_shape, scale, heads,
                q_residual):
        base = pooled_attention_fwd(q, kv, bias_src, k_shape, scale, heads,
                                    q_residual)
        ctx.args = (tuple(k_shape), scale, heads, q_residual)
        ctx.save_for_backward(q, kv, bias_src, wp, base)
        return ln_linear.linear_proj(base, wp, bp)

    @staticmethod
    def backward(ctx, g):
        q, kv, bias_src, wp, base = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dbp = g2.float().sum(0)
        dwp = (g2.t() @ base.reshape(-1, base.shape[-1])).to(wp.dtype)
        dbase = (g2 @ wp).view(g.shape)
        dq, dkv, dbias = pooled_attention_bwd(q, kv, bias_src, dbase,
                                              *ctx.args)
        return dq, dkv, dbias, dwp, dbp, None, None, None, None


def fused_attention_proj(q, kv, bias_src, k_shape, wp, bp, scale, heads,
                         q_residual=False):
    """Attention (K4) then the out-projection (K1): ``proj(att (+ q))``.
    Differentiable: the backward of JAX ``_bwd_proj``, with K5."""
    if not needs_grad(q, kv, bias_src, wp, bp):
        base = pooled_attention_fwd(q, kv, bias_src, k_shape, scale, heads,
                                    q_residual)
        return ln_linear.linear_proj(base, wp, bp)
    return _AttentionProjFn.apply(q, kv, bias_src, wp, bp, k_shape, scale,
                                  heads, q_residual)


def attention_proj_reference(q, kv, bias_src, k_shape, wp, bp, scale, heads,
                             q_residual=False):
    att = pooled_attention_reference(q, kv, bias_src, k_shape, scale, heads,
                                     q_residual)
    return ln_linear.linear_proj_reference(att, wp, bp)
