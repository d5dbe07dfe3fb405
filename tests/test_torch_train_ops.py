"""The backward path of the port's kernels against the JAX package.

- Each backward kernel's plain twin against the JAX function it replaces,
  run in Pallas interpret mode as the JAX package's own tests run it:
  ``pooled_attention_bwd`` (K5), the dx of ``pallas_depthwise_conv``'s VJP
  (K6), ``_dk_pallas`` (K7) and the bare conv forward (K2's bare mode).
- The gradient of every differentiable port op (its autograd.Function:
  kernel forward, kernel or plain-twin backward) against ``jax.vjp`` of the
  JAX op on the same numpy inputs and cotangent.

Tolerance: f32 on both sides, differing only in summation order, so 2e-5
relative to the largest magnitude of the reference (the forward tests use
1e-5; a gradient sums over one more axis).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.ops import pallas_attention as pa
from svit_tpu.ops import pallas_ffn as pf
from svit_tpu.ops import pallas_pool as pp
from svit_tpu_torch.ops import attention as ta
from svit_tpu_torch.ops import ln_linear as tl
from svit_tpu_torch.ops import pool as tp

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=tol)


def _port_grads(fn, inputs, cot):
    leaves = [_t(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    torch.autograd.backward(outs, [_t(c) for c in cots])
    return [t.grad for t in leaves]


def _jax_grads(fn, inputs, cot):
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    return vjp(jax.tree.map(jnp.asarray, cot))


def _ln(rs, n):
    return ((1 + 0.1 * rs.randn(n)).astype(np.float32),
            (0.1 * rs.randn(n)).astype(np.float32))


# ---------------------------------------------------------------------------
# backward kernels: plain twin against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

def _attn_case(heads, with_bias, seed):
    """q grid (2, 4, 4) against a (2, 2, 2) key grid + 5 extras keys: Nk =
    13, a ragged key tail."""
    rs = np.random.RandomState(seed)
    hd, B, E = 16, 2, 5
    C = heads * hd
    q_shape, k_shape = (2, 4, 4), (2, 2, 2)
    nq, nk = int(np.prod(q_shape)), 8 + E
    q = rs.randn(B, nq, C).astype(np.float32)
    kv = rs.randn(B, nk, 2 * C).astype(np.float32)
    do = rs.randn(B, nq, C).astype(np.float32)
    scatter = jnp.asarray(pa._scatter_matrix(k_shape, nk, 128, 0))
    R = sum(k_shape)
    if with_bias:
        bias = (0.5 * rs.randn(B, heads, nq, R)).astype(np.float32)
    else:
        bias = np.zeros((B, heads, nq, R), np.float32)
    # JAX's bias rows carry the constant mask channel last
    bias_j = np.concatenate([bias, np.ones((B, heads, nq, 1), np.float32)], -1)
    return dict(q=q, kv=kv, do=do, scatter=scatter, bias=bias, bias_j=bias_j,
                k_shape=k_shape, scale=hd ** -0.5, heads=heads,
                with_bias=with_bias)


@pytest.mark.parametrize("heads,with_bias", [(1, True), (2, True), (2, False)])
def test_pooled_attention_bwd_twin_matches_jax(heads, with_bias):
    c = _attn_case(heads, with_bias, seed=heads + 10 * with_bias)
    dq_j, dkv_j, db_j = pa.pooled_attention_bwd(
        jnp.asarray(c["q"]), jnp.asarray(c["kv"]), jnp.asarray(c["bias_j"]),
        c["scatter"], jnp.asarray(c["do"]), heads=heads, scale=c["scale"])
    dq, dkv, db = ta.pooled_attention_bwd(
        _t(c["q"]), _t(c["kv"]), _t(c["bias"]) if with_bias else None,
        _t(c["do"]), c["k_shape"], c["scale"], heads)
    _close(dq, dq_j)
    _close(dkv, dkv_j)
    if with_bias:
        _close(db, np.asarray(db_j)[..., :-1])
    else:
        assert db is None


def _conv_case(stride, seed):
    rs = np.random.RandomState(seed)
    B, T, H, W, C = 2, 4, 16, 16, 16
    x = rs.randn(B, T, H, W, C).astype(np.float32)
    kw = (0.2 * rs.randn(3, 3, 3, 1, C)).astype(np.float32)  # flax layout
    To, Ho, Wo = (tp.out_size(d, 3, s) for d, s in zip((T, H, W), stride))
    g = rs.randn(B, To, Ho, Wo, C).astype(np.float32)
    return x, kw, g


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2), (1, 4, 4)])
def test_depthwise_conv_dx_dk_twins_match_jax(stride):
    x, kw, g = _conv_case(stride, seed=sum(stride))
    w = _t(kw.transpose(4, 3, 0, 1, 2))
    # K2 bare mode: pallas_depthwise_conv's forward
    y_j, vjp = jax.vjp(
        lambda x, k: pp.pallas_depthwise_conv(x, k, (3, 3, 3), stride, 16),
        jnp.asarray(x), jnp.asarray(kw))
    _close(tp.depthwise_conv(_t(x), w, stride, 16), y_j)
    dx_j, _ = vjp(jnp.asarray(g))
    # K6: the dx half of _pdc_bwd
    _close(tp.depthwise_conv_dx(_t(g), w, stride, x.shape), dx_j)
    # K7: _dk_pallas, [kT, kH, kW, 1, C]
    dk_j = pp._dk_pallas(jnp.asarray(x), jnp.asarray(g), (3, 3, 3), stride,
                         interpret=True)
    assert dk_j is not None
    dk = tp.depthwise_conv_dk(_t(x), _t(g), (3, 3, 3), stride)
    _close(dk, np.asarray(dk_j).transpose(4, 3, 0, 1, 2))


# ---------------------------------------------------------------------------
# gradients: port autograd against jax.vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_residual", [False, True])
def test_fused_attention_proj_grads_match_jax(q_residual):
    c = _attn_case(2, True, seed=20 + q_residual)
    C = c["q"].shape[-1]
    rs = np.random.RandomState(21)
    wp = (0.1 * rs.randn(C, C)).astype(np.float32)          # flax [in, out]
    bp = (0.1 * rs.randn(C)).astype(np.float32)
    args = (c["scale"], c["heads"], q_residual)
    gj = _jax_grads(
        lambda q, kv, b, w, bb: pa.fused_attention_proj(
            q, kv, b, c["scatter"], w, bb, *args),
        (c["q"], c["kv"], c["bias_j"], wp, bp), c["do"])
    gt = _port_grads(
        lambda q, kv, b, w, bb: ta.fused_attention_proj(
            q, kv, b, c["k_shape"], w, bb, *args),
        (c["q"], c["kv"], c["bias"], wp.T, bp), c["do"])
    _close(gt[0], gj[0])
    _close(gt[1], gj[1])
    _close(gt[2], np.asarray(gj[2])[..., :-1])
    _close(gt[3], np.asarray(gj[3]).T)
    _close(gt[4], gj[4])


@pytest.mark.parametrize("stride,ln_width", [((1, 1, 1), "full"),
                                             ((1, 2, 2), "head_dim"),
                                             ((1, 4, 4), "full")])
def test_fused_pool_ln_grads_match_jax(stride, ln_width):
    x, kw, g = _conv_case(stride, seed=30 + sum(stride))
    rs = np.random.RandomState(31)
    hd = 8
    ls, lb = _ln(rs, 16 if ln_width == "full" else hd)
    gj = _jax_grads(
        lambda x, k, s, b: pp.fused_pool_ln(x, k, s, b, (3, 3, 3), stride, hd),
        (x, kw, ls, lb), g)
    gt = _port_grads(
        lambda x, w, s, b: tp.fused_pool_ln(x, w, s, b, stride, hd),
        (x, kw.transpose(4, 3, 0, 1, 2), ls, lb), g)
    _close(gt[0], gj[0])
    _close(gt[1], np.asarray(gj[1]).transpose(4, 3, 0, 1, 2))
    _close(gt[2], gj[2])
    _close(gt[3], gj[3])


def test_fused_ln_qkv_and_ln_dense_grads_match_jax():
    rs = np.random.RandomState(40)
    B, N, C_in, C = 2, 30, 32, 16
    x = rs.randn(B, N, C_in).astype(np.float32)
    ls, lb = _ln(rs, C_in)
    w = (0.1 * rs.randn(C_in, 3 * C)).astype(np.float32)
    b = (0.1 * rs.randn(3 * C)).astype(np.float32)
    cot = (rs.randn(B, N, C).astype(np.float32),
           rs.randn(B, N, 2 * C).astype(np.float32))
    gj = _jax_grads(
        lambda x, s, bb, w, b: pf.fused_ln_qkv(x, s, bb, w[:, :C], b[:C],
                                               w[:, C:], b[C:]),
        (x, ls, lb, w, b), cot)
    gt = _port_grads(lambda x, s, bb, w, b: tl.fused_ln_qkv(x, s, bb, w, b, C),
                     (x, ls, lb, w.T, b), cot)
    for i in (0, 1, 2, 4):
        _close(gt[i], gj[i])
    _close(gt[3], np.asarray(gj[3]).T)

    wd = (0.1 * rs.randn(C_in, 2 * C_in)).astype(np.float32)
    bd = (0.1 * rs.randn(2 * C_in)).astype(np.float32)
    cot = rs.randn(B, N, 2 * C_in).astype(np.float32)
    gj = _jax_grads(pf.fused_ln_dense, (x, ls, lb, wd, bd), cot)
    gt = _port_grads(tl.fused_ln_dense, (x, ls, lb, wd.T, bd), cot)
    for i in (0, 1, 2, 4):
        _close(gt[i], gj[i])
    _close(gt[3], np.asarray(gj[3]).T)


def _res_case(seed):
    rs = np.random.RandomState(seed)
    B, N, C, H = 3, 24, 16, 64
    xr = rs.randn(B, N, C).astype(np.float32)
    a = rs.randn(B, N, C).astype(np.float32)
    ls, lb = _ln(rs, C)
    w1 = (0.2 * rs.randn(C, H)).astype(np.float32)
    b1 = (0.1 * rs.randn(H)).astype(np.float32)
    w2 = (0.1 * rs.randn(H, C)).astype(np.float32)
    b2 = (0.1 * rs.randn(C)).astype(np.float32)
    cot = rs.randn(B, N, C).astype(np.float32)
    return (xr, a, ls, lb, w1, b1, w2, b2), cot


def _port_res(args):
    xr, a, ls, lb, w1, b1, w2, b2 = args
    return (xr, a, ls, lb, w1.T, b1, w2.T, b2)


def _check_res_grads(gt, gj):
    for i in (0, 1, 2, 3, 5, 7):
        _close(gt[i], gj[i])
    _close(gt[4], np.asarray(gj[4]).T)
    _close(gt[6], np.asarray(gj[6]).T)


def test_fused_ffn_residual_grads_match_jax():
    args, cot = _res_case(50)
    gj = _jax_grads(pf.fused_ffn_residual, args, cot)
    gt = _port_grads(tl.fused_ffn_residual, _port_res(args), cot)
    _check_res_grads(gt, gj)


def test_fused_ffn_residual_masked_values_and_grads_match_jax():
    """Given masks (one sample drops the attention branch, one the MLP)."""
    args, cot = _res_case(51)
    keep = 0.7
    ma = np.array([1.0, 0.0, 1.0], np.float32)
    my = np.array([1.0, 1.0, 0.0], np.float32)
    yj = pf.fused_ffn_residual_masked(keep, *map(jnp.asarray, args),
                                      jnp.asarray(ma), jnp.asarray(my))
    yt = tl.fused_ffn_residual_masked(keep, *map(_t, _port_res(args)), _t(ma),
                                      _t(my))
    _close(yt, yj)
    _close(tl.ffn_residual_masked_reference(keep, *map(_t, _port_res(args)),
                                            _t(ma), _t(my)), yj)
    gj = _jax_grads(
        lambda *t: pf.fused_ffn_residual_masked(keep, *t, jnp.asarray(ma),
                                                jnp.asarray(my)), args, cot)
    gt = _port_grads(
        lambda *t: tl.fused_ffn_residual_masked(keep, *t, _t(ma), _t(my)),
        _port_res(args), cot)
    _check_res_grads(gt, gj)


def test_linear_proj_and_pool_max_grads_match_jax():
    rs = np.random.RandomState(60)
    x = rs.randn(2, 20, 16).astype(np.float32)
    w = (0.2 * rs.randn(16, 24)).astype(np.float32)
    b = (0.1 * rs.randn(24)).astype(np.float32)
    cot = rs.randn(2, 20, 24).astype(np.float32)
    gj = _jax_grads(lambda x, w, b: jnp.dot(x, w) + b, (x, w, b), cot)
    gt = _port_grads(tl.linear_proj, (x, w.T, b), cot)
    _close(gt[0], gj[0])
    _close(gt[1], np.asarray(gj[1]).T)
    _close(gt[2], gj[2])

    x = rs.randn(2, 4, 14, 14, 16).astype(np.float32)
    cot = rs.randn(2, 4, 7, 7, 16).astype(np.float32)
    gj = _jax_grads(lambda x: pp.fused_pool_max(x, (1, 3, 3), (1, 2, 2)),
                    (x,), cot)
    gt = _port_grads(lambda x: tp.fused_pool_max(x, (1, 3, 3), (1, 2, 2)),
                     (x,), cot)
    _close(gt[0], gj[0])
