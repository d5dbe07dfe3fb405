"""Each plain version of a port kernel against the JAX function on the same
numpy inputs.  The JAX side runs its Pallas kernels in interpret mode, as
the JAX package's own tests do on the CPU; the port's wrappers take their
plain versions because the tensors lie on the CPU.

Tolerances: f32 on both sides, differing only in summation order, so 1e-5
(relative to the output's scale).  The JAX kernels' GELU uses the A&S erf
(|err| <= 1.5e-7, pallas_ffn.py:50-63); the port's is exact, well inside it.
"""

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

ATOL = RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(port, jax_out, atol=ATOL):
    ref = np.asarray(jax_out, np.float32)
    got = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=atol * scale, rtol=RTOL)


def _ln_params(rs, n):
    return ((1 + 0.1 * rs.randn(n)).astype(np.float32),
            (0.1 * rs.randn(n)).astype(np.float32))


def test_fused_ln_qkv_matches_jax():
    rs = np.random.RandomState(0)
    B, N, C_in, C = 2, 50, 64, 32
    x = rs.randn(B, N, C_in).astype(np.float32)
    ls, lb = _ln_params(rs, C_in)
    w = (rs.randn(C_in, 3 * C) * 0.1).astype(np.float32)   # flax [in, out]
    b = (rs.randn(3 * C) * 0.1).astype(np.float32)
    jq, jkv = pf.fused_ln_qkv(jnp.asarray(x), ls, lb, w[:, :C], b[:C],
                              w[:, C:], b[C:])
    q, kv = tl.fused_ln_qkv(_t(x), _t(ls), _t(lb), _t(w.T).contiguous(),
                            _t(b), C)
    _close(q, jq)
    _close(kv, jkv)


def test_fused_ln_dense_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 40, 48).astype(np.float32)
    ls, lb = _ln_params(rs, 48)
    w = (rs.randn(48, 96) * 0.1).astype(np.float32)
    b = (rs.randn(96) * 0.1).astype(np.float32)
    ref = pf.fused_ln_dense(jnp.asarray(x), ls, lb, w, b)
    _close(tl.fused_ln_dense(_t(x), _t(ls), _t(lb), _t(w.T), _t(b)), ref)


def test_fused_ffn_residual_matches_jax():
    rs = np.random.RandomState(2)
    B, N, C, H = 2, 60, 32, 128
    x_res = rs.randn(B, N, C).astype(np.float32)
    a = rs.randn(B, N, C).astype(np.float32)
    ls, lb = _ln_params(rs, C)
    w1 = (rs.randn(C, H) * 0.2).astype(np.float32)
    b1 = (rs.randn(H) * 0.1).astype(np.float32)
    w2 = (rs.randn(H, C) * 0.1).astype(np.float32)
    b2 = (rs.randn(C) * 0.1).astype(np.float32)
    ref = pf.fused_ffn_residual(jnp.asarray(x_res), jnp.asarray(a), ls, lb,
                                w1, b1, w2, b2)
    out = tl.fused_ffn_residual(_t(x_res), _t(a), _t(ls), _t(lb), _t(w1.T),
                                _t(b1), _t(w2.T), _t(b2))
    _close(out, ref)
    # the plain twin of the FFN without residual
    _close(tl.ffn_reference(_t(a), _t(ls), _t(lb), _t(w1.T), _t(b1),
                            _t(w2.T), _t(b2)),
           pf.ffn_reference(jnp.asarray(a), ls, lb, w1, b1, w2, b2))


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 8, 8)])
def test_fused_pool_ln_kv_matches_jax(stride):
    """The fused k|v pool: 2C channels, pool_k | pool_v filters and LN
    params tiled over the heads (full channel width)."""
    rs = np.random.RandomState(3)
    hd, heads = 8, 2
    C2 = 2 * heads * hd
    x = rs.randn(2, 4, 16, 16, C2).astype(np.float32)
    kw = (rs.randn(3, 3, 3, 1, C2) * 0.2).astype(np.float32)  # flax layout
    ls = np.tile((1 + 0.1 * rs.randn(2, hd)).astype(np.float32), (1, heads))
    lb = np.tile((0.1 * rs.randn(2, hd)).astype(np.float32), (1, heads))
    ls, lb = ls.reshape(-1), lb.reshape(-1)
    ref = pp.fused_pool_ln(jnp.asarray(x), jnp.asarray(kw), jnp.asarray(ls),
                           jnp.asarray(lb), (3, 3, 3), stride, hd)
    out = tp.fused_pool_ln(_t(x), _t(kw.transpose(4, 3, 0, 1, 2)), _t(ls),
                           _t(lb), stride, hd)
    _close(out, ref)


def test_fused_pool_ln_head_dim_params_matches_jax():
    """The q pool: LN params of size head_dim shared by the heads."""
    rs = np.random.RandomState(4)
    hd = 8
    x = rs.randn(1, 4, 10, 10, 3 * hd).astype(np.float32)
    kw = (rs.randn(3, 3, 3, 1, 3 * hd) * 0.2).astype(np.float32)
    ls, lb = _ln_params(rs, hd)
    ref = pp.fused_pool_ln(jnp.asarray(x), jnp.asarray(kw), ls, lb, (3, 3, 3),
                           (1, 2, 2), hd)
    _close(tp.fused_pool_ln(_t(x), _t(kw.transpose(4, 3, 0, 1, 2)), _t(ls),
                            _t(lb), (1, 2, 2), hd), ref)


def test_fused_pool_max_matches_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 14, 14, 16).astype(np.float32)
    ref = pp.fused_pool_max(jnp.asarray(x), (1, 3, 3), (1, 2, 2))
    _close(tp.fused_pool_max(_t(x), (1, 3, 3), (1, 2, 2)), ref)


def _attn_case(heads, seed=6):
    """q grid (2, 4, 4) queries against a (2, 2, 2) key grid + 5 extras:
    n_k = 13, not a multiple of 128."""
    rs = np.random.RandomState(seed)
    hd, B, E = 16, 2, 5
    C = heads * hd
    q_shape, k_shape = (2, 4, 4), (2, 2, 2)
    q_grid = rs.randn(B, *q_shape, C).astype(np.float32)
    kv = rs.randn(B, 8 + E, 2 * C).astype(np.float32)
    qe = rs.randn(B, E, C).astype(np.float32)
    rel = dict(rel_pos_h=(rs.randn(7, hd) * 0.3).astype(np.float32),
               rel_pos_w=(rs.randn(7, hd) * 0.3).astype(np.float32),
               rel_pos_t=(rs.randn(3, hd) * 0.3).astype(np.float32))
    wp = (rs.randn(C, C) * 0.1).astype(np.float32)
    bp = (rs.randn(C) * 0.1).astype(np.float32)
    return dict(heads=heads, C=C, q_shape=q_shape, k_shape=k_shape,
                q_grid=q_grid, kv=kv, qe=qe, rel=rel, wp=wp, bp=bp,
                scale=hd ** -0.5)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("q_residual", [False, True])
def test_fused_attention_proj_matches_jax(heads, q_residual):
    c = _attn_case(heads)
    B, C, n_k = 2, c["C"], c["kv"].shape[1]
    bias_j, scatter = pa.build_bias_inputs_grid(
        jnp.asarray(c["q_grid"]), heads, c["q_shape"], c["k_shape"], n_k,
        **{k: jnp.asarray(v) for k, v in c["rel"].items()})
    bias_t = ta.build_bias_inputs_grid(
        _t(c["q_grid"]), heads, c["q_shape"], c["k_shape"],
        **{k: _t(v) for k, v in c["rel"].items()})
    # the port drops the constant mask channel of the scatter-matmul form
    _close(bias_t, np.asarray(bias_j)[..., :-1])
    qf = c["q_grid"].reshape(B, -1, C)
    ref = pa.fused_attention_proj(
        jnp.asarray(qf), jnp.asarray(c["kv"]), bias_j, scatter,
        jnp.asarray(c["wp"]), jnp.asarray(c["bp"]), c["scale"], heads,
        q_residual)
    out = ta.fused_attention_proj(
        _t(qf), _t(c["kv"]), bias_t, c["k_shape"], _t(c["wp"].T), _t(c["bp"]),
        c["scale"], heads, q_residual)
    _close(out, ref)


@pytest.mark.parametrize("heads", [1, 2])
def test_extras_attention_matches_jax(heads):
    """The extras launch: no rel-pos bias (JAX: zero bias rows, mask
    channel 1), residual pooling on."""
    c = _attn_case(heads, seed=7)
    B, E, n_k = 2, c["qe"].shape[1], c["kv"].shape[1]
    R = sum(c["k_shape"]) + 1
    scatter = jnp.asarray(pa._scatter_matrix(c["k_shape"], n_k, 128, 0))
    bias_e = jnp.concatenate(
        [jnp.zeros((B, heads, E, R - 1)), jnp.ones((B, heads, E, 1))], -1)
    ref = pa.fused_attention_proj(
        jnp.asarray(c["qe"]), jnp.asarray(c["kv"]), bias_e, scatter,
        jnp.asarray(c["wp"]), jnp.asarray(c["bp"]), c["scale"], heads, True)
    out = ta.fused_attention_proj(
        _t(c["qe"]), _t(c["kv"]), None, c["k_shape"], _t(c["wp"].T),
        _t(c["bp"]), c["scale"], heads, True)
    _close(out, ref)
