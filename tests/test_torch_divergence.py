"""Known divergence points between the port and the JAX package, each pinned.

- LayerNorm eps is 1e-6 everywhere (PyTorch's default is 1e-5).
- Object tokens are pooled by the exact per-channel multiplier, which equals
  the reference's conv over tokens broadcast across the kernel window.
- The extras' residual pooling adds q to every row in the kernel and then
  removes the cls row's projected q.
- Rounding order of the attention epilogue (round the product, then add the
  bias in the IO dtype) and of the residual tail (bias in f32, round, then
  add x in the IO dtype), pinned in bf16 against the JAX kernels' own
  expressions on identical inputs.
- Training: the drop-path op order (``branch / keep * mask``, two bf16
  roundings) bit for bit; the max-pool gradient on tied values, which goes
  to the first maximum of the window as JAX's ``reduce_window`` VJP sends
  it; and the extras' cls row in bf16 against JAX's kernel path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from svit_tpu.models.attention import _ln_functional
from svit_tpu.ops import pooling as jpool
from svit_tpu_torch.models.common import LayerNorm
from svit_tpu_torch.ops import attention as ta
from svit_tpu_torch.ops import ln_linear as tl
from svit_tpu_torch.ops import pooling as tpool

BF = torch.bfloat16


def test_layer_norm_eps_is_1e6():
    rs = np.random.RandomState(0)
    x = torch.from_numpy((1e-3 * rs.randn(4, 64)).astype(np.float32))
    w, b = torch.ones(64), torch.zeros(64)
    y = tl.layer_norm(x, w, b)
    assert LayerNorm(64).eps == 1e-6
    torch.testing.assert_close(y, F.layer_norm(x, (64,), w, b, eps=1e-6),
                               atol=1e-5, rtol=1e-5)
    # with a variance of 1e-6, torch's default eps visibly changes the output
    assert (y - F.layer_norm(x, (64,), w, b)).abs().max() > 0.1
    ref = _ln_functional(jnp.asarray(x.numpy()), jnp.ones(64), jnp.zeros(64))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-5)


def test_object_token_pool_is_the_per_channel_multiplier():
    rs = np.random.RandomState(1)
    C, kernel, stride = 6, (3, 3, 3), (1, 2, 2)
    w = torch.from_numpy(rs.randn(C, 1, *kernel).astype(np.float32))
    tokens = torch.from_numpy(rs.randn(2, 5, C).astype(np.float32))
    # the reference: each token broadcast over a kernel-sized window,
    # depthwise conv (padding k//2), mean over the conv's outputs
    win = tokens.reshape(10, 1, 1, 1, C).expand(10, *kernel, C)
    conv = tpool.depthwise_conv3d(win.contiguous(), w, stride)
    ref = conv.mean(dim=(1, 2, 3)).reshape(2, 5, C)
    mult = tpool.conv_obj_multiplier(w, stride)
    torch.testing.assert_close(tokens * mult, ref, atol=1e-5, rtol=1e-5)
    jmult = jpool.conv_obj_multiplier(
        jnp.asarray(w.numpy().transpose(2, 3, 4, 1, 0)), stride)
    np.testing.assert_allclose(mult.numpy(), np.asarray(jmult), atol=1e-6)


def test_extras_cls_row_residual_correction():
    """q added to every extras row then the cls row's projected q removed
    equals residual pooling on the object rows only (f32)."""
    rs = np.random.RandomState(2)
    B, E, C, heads, n_k = 2, 5, 32, 2, 13
    qe = torch.from_numpy(rs.randn(B, E, C).astype(np.float32))
    kv = torch.from_numpy(rs.randn(B, n_k, 2 * C).astype(np.float32))
    wp = torch.from_numpy((0.1 * rs.randn(C, C)).astype(np.float32))
    bp = torch.from_numpy((0.1 * rs.randn(C)).astype(np.float32))
    args = (kv, None, (2, 2, 2), wp, bp, 0.25, heads)
    oe = ta.fused_attention_proj(qe, *args, q_residual=True)
    oe[:, 0] -= tl.ln_linear_reference(qe[:, 0], wp)
    want = torch.cat([ta.fused_attention_proj(qe[:, :1], *args),
                      ta.fused_attention_proj(qe[:, 1:], *args, q_residual=True)],
                     dim=1)
    torch.testing.assert_close(oe, want, atol=1e-5, rtol=1e-5)


def _bf16_case(seed, M=256, K=64, N=48):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to(BF)
    w = torch.from_numpy((0.2 * rs.randn(N, K)).astype(np.float32)).to(BF)
    b = torch.from_numpy((0.5 * rs.randn(N)).astype(np.float32))
    res = torch.from_numpy(rs.randn(M, N).astype(np.float32)).to(BF)
    return x, w, b, res


def _j(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == BF
                       else jnp.float32)


def _mismatch(a, b):
    return float((a.float().numpy() != np.asarray(b, np.float32)).mean())


def test_attention_epilogue_rounds_then_adds_bias_in_bf16():
    x, w, b, _ = _bf16_case(3)
    # pallas_attention.py _attn_kernel epilogue: f32 product -> IO dtype,
    # then + bp in the IO dtype
    ref = (jnp.dot(_j(x), _j(w).T, preferred_element_type=jnp.float32)
           .astype(jnp.bfloat16) + _j(b).astype(jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    port = tl.linear_proj_reference(x, w, b)
    other = tl.ln_linear_reference(x, w, b)   # bias in f32 before rounding
    assert _mismatch(port, ref) < 0.01
    assert _mismatch(other, ref) > 0.05


def test_residual_tail_rounds_fc2_then_adds_x_in_bf16():
    h, w2, b2, x = _bf16_case(4)
    # pallas_ffn.py _ffn_res_kernel tail: (h @ W2 + b2) in f32 -> IO dtype,
    # then + x in the IO dtype
    ref = (_j(x) + (jnp.dot(_j(h), _j(w2).T, preferred_element_type=jnp.float32)
                    + _j(b2)).astype(jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    port = tl.ln_linear_reference(h, w2, b2, residual=x)
    other = (h.float() @ w2.float().t() + b2 + x.float()).to(BF)
    assert _mismatch(port, ref) < 0.01
    assert _mismatch(other, ref) > 0.05


# ---------------------------------------------------------------------------
# the training path's divergence points
# ---------------------------------------------------------------------------

def test_drop_path_op_order_is_bit_exact():
    """``branch / keep * mask`` in bf16: two roundings, keep weakly typed
    (rounded to bf16 first), as ``_ffn_res_reference_masked`` and
    ``_drop_path_pair`` compute it; for every keep of the ssv2 schedule."""
    from svit_tpu.ops import pallas_ffn as pf

    rs = np.random.RandomState(5)
    B, N, C = 4, 50, 32
    t = torch.from_numpy(rs.randn(B, N, C).astype(np.float32)).to(BF)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    tj, mj = _j(t), jnp.asarray(mask.numpy()).reshape(B, 1, 1).astype(jnp.bfloat16)
    for keep in 1.0 - np.linspace(0, 0.4, 16)[1:]:
        keep = float(keep)
        port = tl.drop_path_scale(t.view(B * N, C), mask, keep, rows=N)
        ref = np.asarray((tj / keep * mj).astype(jnp.float32)).reshape(B * N, C)
        assert _mismatch(port, ref) == 0.0, keep
        # multiplying by mask / keep instead rounds once and differs
        other = (t.float() * (mask.view(B, 1, 1) / keep)).to(BF).view(B * N, C)
        assert _mismatch(other, ref) > 0.0 or keep == 1.0
    # the whole masked tail in bf16 against its JAX twin on the same inputs
    Hd = 4 * C
    w1 = torch.from_numpy((0.2 * rs.randn(Hd, C)).astype(np.float32)).to(BF)
    w2 = torch.from_numpy((0.1 * rs.randn(C, Hd)).astype(np.float32)).to(BF)
    b1 = torch.from_numpy((0.1 * rs.randn(Hd)).astype(np.float32))
    b2 = torch.from_numpy((0.1 * rs.randn(C)).astype(np.float32))
    ls, lb = torch.ones(C), torch.zeros(C)
    a = torch.from_numpy(rs.randn(B, N, C).astype(np.float32)).to(BF)
    my = torch.tensor([0.0, 1.0, 1.0, 1.0])
    port = tl.ffn_residual_masked_reference(0.6, t, a, ls, lb, w1, b1, w2, b2,
                                            mask, my)
    ref = pf.ffn_residual_masked_reference(
        0.6, tj, _j(a), _j(ls), _j(lb), _j(w1).T, _j(b1), _j(w2).T, _j(b2),
        jnp.asarray(mask.numpy()), jnp.asarray(my.numpy()))
    assert _mismatch(port, np.asarray(ref.astype(jnp.float32))) < 0.01


@pytest.mark.parametrize("kernel", [(1, 3, 3), (3, 3, 3)])
def test_max_pool_gradient_routes_ties_as_jax(kernel):
    """Integer-valued bf16 inputs (ties everywhere): the gradient goes to
    the same window element as ``jax.grad`` of ``pooling.max_pool3d``."""
    rs = np.random.RandomState(6)
    x = rs.randint(0, 3, size=(2, 4, 9, 9, 8)).astype(np.float32)
    stride = (1, 2, 2)
    out_shape = tpool.max_pool3d(torch.from_numpy(x), kernel, stride).shape
    g = rs.randn(*out_shape).astype(np.float32)
    want = jax.grad(lambda a: (jpool.max_pool3d(a, kernel, stride).astype(
        jnp.float32) * g).sum())(jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(BF).requires_grad_()
    (tpool.max_pool3d(xt, kernel, stride).float() * torch.from_numpy(g)).sum(
        ).backward()
    assert _mismatch(xt.grad, np.asarray(want.astype(jnp.float32))) == 0.0


def test_extras_cls_row_matches_jax_in_bf16():
    """The cls row of the extras attention (q residual added to every row,
    then the cls row's projected q removed) in bf16, against JAX
    ``use_pallas=True`` (interpret mode): it differs from JAX by no more
    than the object rows do."""
    from svit_tpu.ops import mm
    from svit_tpu.ops import pallas_attention as pa

    rs = np.random.RandomState(7)
    B, E, heads, hd = 2, 9, 2, 16
    C, k_shape = heads * hd, (2, 2, 2)
    n_k = 8 + E
    qe = torch.from_numpy(rs.randn(B, E, C).astype(np.float32)).to(BF)
    kv = torch.from_numpy(rs.randn(B, n_k, 2 * C).astype(np.float32)).to(BF)
    wp = torch.from_numpy((0.2 * rs.randn(C, C)).astype(np.float32)).to(BF)
    bp = torch.from_numpy((0.1 * rs.randn(C)).astype(np.float32))
    scale = hd ** -0.5
    oe = ta.fused_attention_proj(qe, kv, None, k_shape, wp, bp, scale, heads,
                                 True)
    port = torch.cat([(oe[:, 0] - tl.ln_linear_reference(qe[:, 0], wp))[:, None],
                      oe[:, 1:]], dim=1).float().numpy()
    R = sum(k_shape) + 1
    scatter = jnp.asarray(pa._scatter_matrix(k_shape, n_k, 128, 0), jnp.bfloat16)
    bias_e = jnp.concatenate([jnp.zeros((B, heads, E, R - 1), jnp.bfloat16),
                              jnp.ones((B, heads, E, 1), jnp.bfloat16)], -1)
    wpj = _j(wp).T
    oj = pa.fused_attention_proj(_j(qe), _j(kv), bias_e, scatter, wpj, _j(bp),
                                 scale, heads, True)
    oj = jnp.concatenate([oj[:, :1] - mm.dense2d(_j(qe)[:, :1], wpj),
                          oj[:, 1:]], axis=1)
    diff = np.abs(port - np.asarray(oj.astype(jnp.float32)))
    cls_err, obj_err = diff[:, 0].max(), diff[:, 1:].max()
    assert cls_err <= max(obj_err, 1e-6), (cls_err, obj_err)
