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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from svit_tpu_torch.ops import _lib, ln_linear
from svit_tpu_torch.ops import rel_pos as rp

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


def pooled_attention(q, kv, bias_src, k_shape: Triple, scale: float,
                     heads: int, q_residual: bool = False):
    """Kernel K4 (``csrc/attention.cu``): flash-style online softmax over key
    tiles, one block per (batch, 64-query tile, head).  Returns [B, Nq, C]."""
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


def fused_attention_proj(q, kv, bias_src, k_shape, wp, bp, scale, heads,
                         q_residual=False):
    """Attention (K4) then the out-projection (K1): ``proj(att (+ q))``."""
    att = pooled_attention(q, kv, bias_src, k_shape, scale, heads, q_residual)
    return ln_linear.linear_proj(att, wp, bp)


def attention_proj_reference(q, kv, bias_src, k_shape, wp, bp, scale, heads,
                             q_residual=False):
    att = pooled_attention_reference(q, kv, bias_src, k_shape, scale, heads,
                                     q_residual)
    return ln_linear.linear_proj_reference(att, wp, bp)
