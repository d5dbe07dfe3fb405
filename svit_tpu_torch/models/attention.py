"""Pooled multiscale attention over separate (patch grid | cls + object)
streams (counterpart of ``svit_tpu/models/attention.py``, its
``use_pallas=True`` path at exact widths).

The residual stream is carried as two tensors: the patch grid
``[B, T, H, W, C]`` and the small ``extras [B, 1 + O*T, C]`` (cls and object
tokens).  Keys and values are ``[patches | extras]``; softmax does not care
about key order, so this is the reference's joint attention.

The grid goes through the hand-written kernels (``use_kernels=True``) or
their plain twins (``use_kernels=False``):

- norm1 + q and k|v projections: ``fused_ln_qkv`` (K1);
- q pool and the fused k|v pool: ``fused_pool_ln`` (K2);
- attention + residual pooling: ``pooled_attention`` (K4), then the
  out-projection (K1), for the grid queries and again for the extras;
- stage transitions: ``fused_ln_dense`` (K1) and ``fused_pool_max`` (K3);
- residual tail: ``fused_ffn_residual`` (K1, two launches), or in train
  mode under stochastic depth ``fused_ffn_residual_masked`` (K1 masked).

The extras' projections, pools and FFN are tiny and stay plain PyTorch, as
the JAX package leaves them to XLA, with every product on IO-dtype operands
and an f32 sum, forward and backward (``ll.dense``, ``ll.ffn``).  So do the paths the JAX package runs
as plain XLA ops whatever its kernels: the ``max`` and ``avg`` pool modes
(the grid pooled with padding k // 2, the extras passing through), the
separate q, k and v projections of ``MVIT.SEPARATE_QKV`` on the normed
streams, and the unfused residual tail with its own projection under
``MVIT.DIM_MUL_IN_ATT=False``.  A block without q or k|v pooling leaves
that stream as it is.

Train mode follows the JAX package's ``use_pallas`` path
(``svit_tpu/models/attention.py:752-807``): a block with a drop-path rate
draws two per-sample keep masks, ``mask1`` then ``mask2``, scales the
extras' attention output by ``mask1 / keep`` and the extras' FFN by
``mask2 / keep`` and runs the masked tail on the grid; a block with rate 0
runs the unmasked tail.  With ``MVIT.DROPOUT_RATE > 0`` the attention
outputs and the MLP take dropout and the tail is unfused, as in JAX.
Every op here is differentiable: the kernels' backward passes are K5 (the
attention), K2 bare + K6 + K7 (the pools), the LN-linear uses' own
backward and K3's ``pool_max_bwd`` (the max pool).  Under tensor
parallelism (``Mlp.tp``, ``TPU.MESH_MODEL > 1``) the residual tail, fused
or unfused, runs this rank's share of the MLP (``parallel/tensor.py``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import numpy as np
import torch
from torch import nn

from svit_tpu_torch.models.common import (LayerNorm, Mlp, cast, derived,
                                          dropout, keep_mask)
from svit_tpu_torch.ops import attention as attn_ops
from svit_tpu_torch.ops import ln_linear as ll
from svit_tpu_torch.ops import pool, pooling
from svit_tpu_torch.parallel import tensor

Triple = Tuple[int, ...]


def _ops(use_kernels: bool) -> SimpleNamespace:
    """The grid-stream ops: the kernel wrappers or their plain twins
    (looked up at call time)."""
    if use_kernels:
        return SimpleNamespace(
            ln_qkv=ll.fused_ln_qkv, ln_dense=ll.fused_ln_dense,
            ffn_residual=ll.fused_ffn_residual,
            ffn_residual_masked=ll.fused_ffn_residual_masked,
            pool_ln=pool.fused_pool_ln,
            pool_max=pool.fused_pool_max,
            attention_proj=attn_ops.fused_attention_proj)
    return SimpleNamespace(
        ln_qkv=ll.ln_qkv_reference, ln_dense=ll.ln_dense_reference,
        ffn_residual=ll.ffn_residual_reference,
        ffn_residual_masked=ll.ffn_residual_masked_reference,
        pool_ln=pool.pool_ln_reference, pool_max=pool.pool_max_reference,
        attention_proj=attn_ops.attention_proj_reference)


def _needs_pool(kernel, stride) -> bool:
    """Pooling is skipped for kernel = stride = 1."""
    if not kernel or not stride:
        return False
    return int(np.prod(kernel)) != 1 or int(np.prod(stride)) != 1


class _PoolConv(nn.Module):
    """A depthwise pool filter ``[head_dim, 1, kT, kH, kW]`` (``pool_*.weight``)."""

    def __init__(self, head_dim: int, kernel: Triple):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(head_dim, 1, *kernel))


def _dense(x, layer: nn.Linear, dtype):
    """flax ``nn.Dense(dtype=...)`` on a stream of any rank: the product
    rounded to ``dtype``, the bias added in ``dtype``."""
    return ll.dense(x.to(dtype), layer.weight, layer.bias)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim, dim_out, num_heads, input_size, *, qkv_bias,
                 kernel_q, kernel_kv, stride_q, stride_kv, mode, has_cls,
                 rel_pos_spatial, rel_pos_temporal, residual_pooling,
                 separate_qkv):
        super().__init__()
        if mode not in ("conv", "max", "avg"):
            raise NotImplementedError(f"unsupported pool mode {mode!r}")
        self.mode = mode
        self.separate_qkv = separate_qkv
        self.dim_out = dim_out
        self.num_heads = num_heads
        self.head_dim = dim_out // num_heads
        self.use_qkv_bias = qkv_bias
        self.kernel_q, self.kernel_kv = tuple(kernel_q), tuple(kernel_kv)
        self.stride_q, self.stride_kv = tuple(stride_q), tuple(stride_kv)
        self.has_cls = has_cls
        self.residual_pooling = residual_pooling
        self.pool_q_on = _needs_pool(kernel_q, stride_q)
        self.pool_kv_on = _needs_pool(kernel_kv, stride_kv)
        hd = self.head_dim
        if separate_qkv:
            for n in "qkv":
                setattr(self, n, nn.Linear(dim, dim_out, bias=qkv_bias))
        else:
            # the qkv bias always exists (the JAX tree has it); it is used
            # only under MVIT.QKV_BIAS
            self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)
        if mode == "conv":
            for n, k, on in (("q", kernel_q, self.pool_q_on),
                             ("k", kernel_kv, self.pool_kv_on),
                             ("v", kernel_kv, self.pool_kv_on)):
                if on:
                    setattr(self, f"pool_{n}", _PoolConv(hd, tuple(k)))
                    setattr(self, f"norm_{n}", LayerNorm(hd))
        if rel_pos_spatial:
            assert input_size[1] == input_size[2]
            size = input_size[1]
            sq = stride_q[1] if self.pool_q_on else 1
            skv = stride_kv[1] if self.pool_kv_on else 1
            sp_dim = 2 * max(size // sq, size // skv) - 1
            self.rel_pos_h = nn.Parameter(torch.zeros(sp_dim, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(sp_dim, hd))
        else:
            self.rel_pos_h = self.rel_pos_w = None
        if rel_pos_temporal:
            self.rel_pos_t = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        else:
            self.rel_pos_t = None

    def forward(self, grid, extras, ln1, use_kernels, dtype, drop=None,
                cache=None):
        """grid [B, T, H, W, C_in] and extras [B, E, C_in] are the RAW
        streams with ``ln1`` (norm1's weight and bias), fused into the
        projection, or the normed streams with ``ln1`` None (separate q, k
        and v).  ``drop`` (train mode with ``MVIT.DROPOUT_RATE``) is applied
        to both outputs; ``cache`` is a train step's ``StepCache``.  Returns
        (grid_out [B, To, Ho, Wo, C], extras_out [B, E, C])."""
        ops = _ops(use_kernels)
        B, E = grid.shape[0], extras.shape[1]
        C, heads, hd = self.dim_out, self.num_heads, self.head_dim
        scale = hd ** -0.5

        if self.separate_qkv:
            qg, qe = (_dense(t, self.q, dtype) for t in (grid, extras))
            kvg, kve = (torch.cat([_dense(t, self.k, dtype),
                                   _dense(t, self.v, dtype)], dim=-1)
                        for t in (grid, extras))
        else:
            w = cast(self.qkv.weight, dtype, cache)
            b = self.qkv.bias if self.use_qkv_bias else None
            qg, kvg = ops.ln_qkv(grid, ln1[0], ln1[1], w, b, C)
            en = ll.layer_norm(extras, ln1[0], ln1[1])
            qe = ll.dense(en, w[:C], None if b is None else b[:C])
            kve = ll.dense(en, w[C:], None if b is None else b[C:])

        if self.pool_q_on:
            qg, qe = self._pool(ops, qg, qe, ("q",), self.kernel_q,
                                self.stride_q, cache)
        if self.pool_kv_on:
            # ONE pool for the fused k|v grid: conv and per-head LN are
            # channel-local, so pool_k | pool_v tiled over heads is exact
            kvg, kve = self._pool(ops, kvg, kve, ("k", "v"), self.kernel_kv,
                                  self.stride_kv, cache)

        q_shape = tuple(qg.shape[1:4])
        k_shape = tuple(kvg.shape[1:4])
        q_l, k_l = int(np.prod(q_shape)), int(np.prod(k_shape))
        kv_all = torch.cat([kvg.reshape(B, k_l, 2 * C), kve], dim=1)
        bias_src = attn_ops.build_bias_inputs_grid(
            qg, heads, q_shape, k_shape, rel_pos_h=self.rel_pos_h,
            rel_pos_w=self.rel_pos_w, rel_pos_t=self.rel_pos_t)
        wp = cast(self.proj.weight, dtype, cache)
        og = ops.attention_proj(qg.reshape(B, q_l, C), kv_all, bias_src,
                                k_shape, wp, self.proj.bias, scale, heads,
                                self.residual_pooling)
        # extras queries: no rel-pos bias, same keys and values
        oe = ops.attention_proj(qe, kv_all, None, k_shape, wp, self.proj.bias,
                                scale, heads, self.residual_pooling)
        if self.residual_pooling and self.has_cls:
            # the reference adds the q residual to all rows but cls; the
            # kernel adds it to every row, so remove the cls row's projected q
            cls_q = ll.dense(qe[:, 0], wp)
            oe = torch.cat([(oe[:, 0] - cls_q)[:, None], oe[:, 1:]], dim=1)
        if drop is not None:
            og, oe = drop(og), drop(oe)
        return og.view(B, *q_shape, C), oe

    def _pool(self, ops, grid, extras, names, kernel, stride, cache):
        """Pool one stream pair.  conv: the depthwise conv + per-head LN on
        the grid (the filters of ``names`` tiled over heads, concatenated),
        the exact multiplier and the same LN on the object tokens (cls
        passes).  max / avg: the grid alone, extras unchanged.  The tiled
        filters, LN parameters and multiplier are derived once a step
        through ``cache``."""
        if self.mode != "conv":
            fn = pooling.max_pool3d if self.mode == "max" else \
                pooling.avg_pool3d
            return fn(grid, kernel, stride), extras
        w, ls, lb = self._pool_params(names, cache)
        grid = ops.pool_ln(grid, w, ls, lb, stride, self.head_dim)
        if cache is None:
            mult = pooling.conv_obj_multiplier(w, stride)
        else:   # from the cached filters' graph, whatever the grad mode
            mult = cache.derived(
                (id(self), names, "mult"),
                lambda: pooling.conv_obj_multiplier(
                    self._pool_params(names, cache)[0], stride))
        return grid, self._pool_extras(extras, mult, ls, lb)

    def _pool_params(self, names, cache):
        """The filters of ``names`` tiled over heads and concatenated, and
        their per-head LN parameters (the q pool keeps head_dim-wide
        ones)."""
        heads = self.num_heads
        w = derived((id(self), names, "w"), lambda: torch.cat(
            [getattr(self, f"pool_{n}").weight.repeat(heads, 1, 1, 1, 1)
             for n in names]), cache)
        norms = [getattr(self, f"norm_{n}") for n in names]
        if len(norms) == 1:
            return w, norms[0].weight, norms[0].bias
        ls = derived((id(self), names, "ls"), lambda: torch.cat(
            [n.weight.repeat(heads) for n in norms]), cache)
        lb = derived((id(self), names, "lb"), lambda: torch.cat(
            [n.bias.repeat(heads) for n in norms]), cache)
        return w, ls, lb

    def _pool_extras(self, x, mult, ln_w, ln_b):
        mult = mult.to(x.dtype)
        if self.has_cls:
            x = torch.cat([x[:, :1], x[:, 1:] * mult], dim=1)
        else:
            x = x * mult
        return pool.group_layer_norm(x, ln_w, ln_b, self.head_dim)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim, dim_out, num_heads, input_size, *, mlp_ratio,
                 qkv_bias, kernel_q, kernel_kv, stride_q, stride_kv, mode,
                 has_cls, rel_pos_spatial, rel_pos_temporal, residual_pooling,
                 dim_mul_in_att, separate_qkv, drop_path=0.0, drop_rate=0.0):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.dim_mul_in_att = dim_mul_in_att
        self.separate_qkv = separate_qkv
        self.drop_path, self.drop_rate = drop_path, drop_rate
        self.stride_q = tuple(stride_q)
        att_dim = dim_out if dim_mul_in_att else dim
        self.norm1 = LayerNorm(dim)
        self.attn = MultiScaleAttention(
            dim, att_dim, num_heads, input_size, qkv_bias=qkv_bias,
            kernel_q=kernel_q, kernel_kv=kernel_kv, stride_q=stride_q,
            stride_kv=stride_kv, mode=mode, has_cls=has_cls,
            rel_pos_spatial=rel_pos_spatial, rel_pos_temporal=rel_pos_temporal,
            residual_pooling=residual_pooling, separate_qkv=separate_qkv)
        self.norm2 = LayerNorm(att_dim)
        self.mlp = Mlp(att_dim, int(att_dim * mlp_ratio), dim_out)
        self.proj = nn.Linear(dim, dim_out) if dim != dim_out else None

    def forward(self, grid, extras, use_kernels: bool, dtype, train=False,
                generator=None, cache=None):
        ops = _ops(use_kernels)
        drop = None
        if train and self.drop_rate > 0:
            def drop(t):
                return dropout(t, self.drop_rate, generator)
        ln1 = (self.norm1.weight, self.norm1.bias)
        if self.separate_qkv:
            # norm1 is not fused into separate projections: the attention
            # and the dim-change projection take the normed streams
            gn, en = self.norm1(grid), self.norm1(extras)
            ag, ae = self.attn(gn, en, None, use_kernels, dtype, drop, cache)
        else:
            ag, ae = self.attn(grid, extras, ln1, use_kernels, dtype, drop,
                               cache)
        if self.proj is not None and self.dim_mul_in_att:
            if self.separate_qkv:
                grid = _dense(gn, self.proj, dtype)
                extras = _dense(en, self.proj, dtype)
            else:
                # norm1 again inside the dim-change projection (the
                # attention's copy stays fused in its qkv launch)
                wpj = cast(self.proj.weight, dtype, cache)
                grid = ops.ln_dense(grid, ln1[0], ln1[1], wpj, self.proj.bias)
                extras = ll.dense(extras, wpj, self.proj.bias, ln=ln1)
        if self.stride_q and int(np.prod(self.stride_q)) > 1:
            # residual skip: max pool with kernel s+1 where the q stride is s
            kernel_skip = tuple(s + 1 if s > 1 else s for s in self.stride_q)
            grid = ops.pool_max(grid, kernel_skip, self.stride_q)
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        w1, w2 = cast(fc1.weight, dtype, cache), cast(fc2.weight, dtype, cache)
        ln2 = (self.norm2.weight, self.norm2.bias)
        keep = 1.0 - self.drop_path
        masks = None
        if train and self.drop_path > 0:
            B = grid.shape[0]
            masks = (keep_mask(B, keep, generator, grid.device),
                     keep_mask(B, keep, generator, grid.device))
        if drop is not None or (self.proj is not None
                                and not self.dim_mul_in_att):
            return self._unfused_tail(grid, extras, ag, ae, ln2, drop, masks,
                                      keep, dtype, generator)
        if self.mlp.tp is not None:
            return self._sharded_tail(grid, extras, ag, ae, ln2, w1, w2,
                                      masks, keep, use_kernels)
        if masks is None:
            out_g = ops.ffn_residual(grid, ag, *ln2, w1, fc1.bias, w2,
                                     fc2.bias)
        else:
            ae = ll.drop_path_scale(ae, masks[0], keep)
            out_g = ops.ffn_residual_masked(keep, grid, ag, *ln2, w1,
                                            fc1.bias, w2, fc2.bias, *masks)
        ex = extras + ae
        ye = ll.ffn(ex, *ln2, w1, fc1.bias, w2, fc2.bias)
        if masks is not None:
            ye = ll.drop_path_scale(ye, masks[1], keep)
        return out_g, ex + ye

    def _sharded_tail(self, grid, extras, ag, ae, ln2, w1, w2, masks, keep,
                      use_kernels):
        """The residual tail with the MLP sharded over the model group
        (``parallel/tensor.py``): this rank's fc1 columns and fc2 rows, the
        f32 partials summed across the group before fc2's bias."""
        group, fc1, fc2 = self.mlp.tp, self.mlp.fc1, self.mlp.fc2
        op = ll.ln_linear if use_kernels else ll.ln_linear_reference
        ma, my = masks if masks is not None else (None, None)
        if masks is not None:
            ae = ll.drop_path_scale(ae, ma, keep)
        out_g = tensor.ffn_residual(group, grid, ag, *ln2, w1, fc1.bias, w2,
                                    fc2.bias, ma, my, keep, op=op)
        ex = extras + ae
        ye = tensor.ffn(group, ex, *ln2, w1, fc1.bias, w2, fc2.bias)
        if masks is not None:
            ye = ll.drop_path_scale(ye, my, keep)
        return out_g, ex + ye

    def _unfused_tail(self, grid, extras, ag, ae, ln2, drop, masks, keep,
                      dtype, generator):
        """The residual tail in plain PyTorch (JAX's unfused path:
        ``_drop_path_pair`` around norm2 and a dense MLP), with the MLP's
        dropout (``drop``) and, under ``MVIT.DIM_MUL_IN_ATT=False`` at a
        change of width, the residual's projection of the normed stream.
        Under tensor parallelism the MLP is this rank's share
        (``tensor.dense_columns``, ``tensor.dense_rows``), its hidden
        dropout this rank's columns of the whole width's mask."""
        if masks is not None:
            ag = ll.drop_path_scale(ag, masks[0], keep)
            ae = ll.drop_path_scale(ae, masks[0], keep)
        grid, extras = grid + ag, extras + ae
        fc1, fc2, group = self.mlp.fc1, self.mlp.fc2, self.mlp.tp
        dropping = drop is not None
        if not dropping:
            def drop(t):
                return t

        def mlp(t):
            gelu = torch.nn.functional.gelu
            if group is None:
                h = drop(gelu(_dense(t, fc1, dtype)))
                return drop(_dense(h, fc2, dtype))
            h = gelu(tensor.dense_columns(group, t.to(dtype), fc1.weight,
                                          fc1.bias))
            if dropping:
                h = dropout(h, self.drop_rate, generator,
                            tensor.columns(group))
            return drop(tensor.dense_rows(group, h, fc2.weight, fc2.bias))

        g2, e2 = ll.layer_norm(grid, *ln2), ll.layer_norm(extras, *ln2)
        mg, me = mlp(g2), mlp(e2)
        if self.proj is not None and not self.dim_mul_in_att:
            grid = _dense(g2, self.proj, dtype)
            extras = _dense(e2, self.proj, dtype)
        if masks is not None:
            mg = ll.drop_path_scale(mg, masks[1], keep)
            me = ll.drop_path_scale(me, masks[1], keep)
        return grid + mg, extras + me
