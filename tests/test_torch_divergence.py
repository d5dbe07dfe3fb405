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
"""

import jax.numpy as jnp
import numpy as np
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
