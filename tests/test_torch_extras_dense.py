"""The extras stream's dense layers and MLP take their products on IO-dtype
operands with an f32 sum, forward and backward (``ops/ln_linear.py``:
``dense``, ``ffn``), as the JAX package's XLA ops do (flax
``Dense(dtype=bf16)``, ``pallas_ffn.ffn_reference``).

- Against JAX in bf16: the forward and ``jax.vjp``'s gradients of the same
  bf16 inputs.  Both sides round the same products of bf16 operands once;
  only the f32 summation order differs, so the outputs agree to one bf16
  rounding (relative L2 at most 1e-2, as ``tests/test_torch_ln_linear_vjp.py``
  holds the grid's backward) and most elements exactly.
- On the model: a bf16 train-mode forward and backward of a two-block SViT
  (kernel mode, so the grid takes the wrappers' CPU twins) records every
  product that goes through ``_mm``: all take bf16 operands, and no plain
  twin (``ln_linear_reference``, which upcasts both operands to f32) runs
  at the extras' row counts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.ops import mm as jmm
from svit_tpu.ops import pallas_ffn as pf
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models import build_model
from svit_tpu_torch.ops import ln_linear as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16
L2 = 1e-2


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF)


def _jbf(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _np(t):
    return t.float().detach().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _jax_ln(x, s, b):
    xf = x.astype(jnp.float32)
    m = xf.mean(-1, keepdims=True)
    v = jnp.square(xf - m).mean(-1, keepdims=True)
    return ((xf - m) * jax.lax.rsqrt(v + 1e-6) * s + b).astype(x.dtype)


@pytest.mark.parametrize("with_ln", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_dense_matches_jax_bf16(with_ln, with_bias):
    """``dense`` (product rounded, bias added in bf16) against JAX
    ``mm.dense2d`` on bf16 operands, optionally after the LN (the extras'
    dim-change projection)."""
    rs = np.random.RandomState(int(with_ln) * 2 + int(with_bias))
    B, E, K, N = 2, 9, 32, 48
    x = rs.randn(B, E, K)
    w = rs.randn(N, K) / np.sqrt(K)
    b = 0.1 * rs.randn(N)
    ls, lb = 1 + 0.1 * rs.randn(K), 0.1 * rs.randn(K)
    g = rs.randn(B, E, N)

    def jfn(x, w, b, ls, lb):
        xn = _jax_ln(x, ls, lb) if with_ln else x
        return jmm.dense2d(xn, w.T, b if with_bias else None)

    jin = (_jbf(x), _jbf(w), jnp.asarray(b, jnp.float32),
           jnp.asarray(ls, jnp.float32), jnp.asarray(lb, jnp.float32))
    jy, vjp = jax.vjp(jfn, *jin)
    jgrads = vjp(_jbf(g))

    tin = [_bf(x), _bf(w), torch.tensor(b, dtype=torch.float32),
           torch.tensor(ls, dtype=torch.float32),
           torch.tensor(lb, dtype=torch.float32)]
    for t in tin:
        t.requires_grad_(True)
    y = tl.dense(tin[0], tin[1], tin[2] if with_bias else None,
                 ln=(tin[3], tin[4]) if with_ln else None)
    assert y.dtype == BF
    y.backward(_bf(g))
    assert _rel_l2(_np(y), _np(jy)) <= L2
    assert np.mean(_np(y) == _np(jy)) > 0.9
    names = ["x", "w", "b", "ln_w", "ln_b"]
    for i, name in enumerate(names):
        if (name == "b" and not with_bias) or (name.startswith("ln")
                                               and not with_ln):
            assert tin[i].grad is None or not tin[i].grad.any(), name
            continue
        assert tin[i].grad.dtype == tin[i].dtype, name
        assert _rel_l2(_np(tin[i].grad), _np(jgrads[i])) <= L2, name


def test_ffn_matches_jax_bf16():
    """``ffn`` (LN -> fc1 + b1 in f32 -> GELU -> bf16 -> fc2 + b2 in f32 ->
    bf16) against JAX ``ffn_reference`` and its ``jax.vjp`` in bf16."""
    rs = np.random.RandomState(5)
    B, E, C, H = 2, 9, 32, 128
    x = rs.randn(B, E, C)
    ls, lb = 1 + 0.1 * rs.randn(C), 0.1 * rs.randn(C)
    w1, b1 = rs.randn(H, C) / np.sqrt(C), 0.1 * rs.randn(H)
    w2, b2 = rs.randn(C, H) / np.sqrt(H), 0.1 * rs.randn(C)
    g = rs.randn(B, E, C)
    f32 = (lambda a: jnp.asarray(a, jnp.float32))
    jin = (_jbf(x), f32(ls), f32(lb), _jbf(w1.T), f32(b1), _jbf(w2.T),
           f32(b2))
    jy, vjp = jax.vjp(pf.ffn_reference, *jin)
    jgrads = vjp(_jbf(g))

    t32 = (lambda a: torch.tensor(a, dtype=torch.float32))
    tin = [_bf(x), t32(ls), t32(lb), _bf(w1), t32(b1), _bf(w2), t32(b2)]
    for t in tin:
        t.requires_grad_(True)
    y = tl.ffn(*tin)
    y.backward(_bf(g))
    assert y.dtype == BF
    assert _rel_l2(_np(y), _np(jy)) <= L2
    for i, name in enumerate(["x", "ln_w", "ln_b", "w1", "b1", "w2", "b2"]):
        want = _np(jgrads[i])
        if name in ("w1", "w2"):
            want = want.T   # JAX weights are [in, out]
        assert _rel_l2(_np(tin[i].grad), want) <= L2, name


def test_extras_products_take_io_dtype_operands(monkeypatch):
    """A bf16 train step's forward and backward at depth 2: every ``_mm``
    product takes bf16 operands, and the f32-upcasting plain twin never
    runs at the extras' row counts (B, or B times 1 + O T)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.MODEL.NUM_CLASSES = 5
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.EMBED_DIM = 32
    cfg.MVIT.NUM_HEADS = 1
    cfg.MVIT.PATCH_KERNEL = [3, 7, 7]
    cfg.MVIT.PATCH_STRIDE = [2, 4, 4]
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    model, arch = build_model(cfg, dtype=BF, use_kernels=True, device="cpu",
                              train=True)
    B, T = 2, 4
    E = 1 + arch.num_obj_per_frame * (T // arch.patch_stride[0])
    seen, twin_rows = [], []
    mm, twin = tl._mm, tl.ln_linear_reference

    def record_mm(a, b):
        seen.append((a.dtype, b.dtype))
        return mm(a, b)

    def record_twin(x, *args, **kw):
        twin_rows.append(x.shape[0])
        return twin(x, *args, **kw)

    monkeypatch.setattr(tl, "_mm", record_mm)
    monkeypatch.setattr(tl, "ln_linear_reference", record_twin)
    clips = torch.from_numpy(np.random.RandomState(0).randn(
        B, T, 32, 32, 3).astype(np.float32)).to(BF)
    logits, extra = model(clips, train=True)
    (logits.float().sum() + extra["obj_desc"].float().sum()).backward()
    assert seen and all(d == (BF, BF) for d in seen), set(seen)
    assert twin_rows
    assert not set(twin_rows) & {B, B * E}, sorted(set(twin_rows))
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
