"""The LN-linear backward of the port (``ops/ln_linear.py``: ``_ln_dense_vjp``,
``_ffn_vjp``, ``_proj_vjp``) against ``jax.vjp`` of the JAX package's plain
references (``pallas_ffn.py``: ``_ln_qkv_reference``, ``_ln_dense_reference``,
``_ffn_res_reference(_masked)``, ``_ffn_reference``), which its custom VJPs
differentiate.  Gradients of x, x_add, the LN scale and bias, W and b.

- f32 IO: both sides in f32, differing only in summation order: 2e-5
  relative to the largest magnitude (``tests/test_torch_train_ops.py``).
- bf16 IO: the port's backward on bf16 activations and weights (products
  of bf16 operands summed in f32, the cotangent rounded to bf16 once)
  against the f32 VJP on the same rounded values: relative L2 error at
  most 1e-2 per gradient (a handful of bf16 roundings, 2^-8 each; 1.1e-3
  to 4.2e-3 measured).  Every product of the path takes bf16 operands (a
  recording ``_mm``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.ops import pallas_ffn as pf
from svit_tpu_torch.ops import ln_linear as tl

TOL = 2e-5
BF16_L2 = 1e-2
BF = torch.bfloat16


def _ln(rs, n):
    return ((1 + 0.1 * rs.randn(n)).astype(np.float32),
            (0.1 * rs.randn(n)).astype(np.float32))


def _case(use, seed=0):
    """(JAX fn, port fn, JAX inputs, which inputs are weights [in, out],
    which are activations, cotangent) of one use."""
    rs = np.random.RandomState(seed)
    B, N, C = 2, 24, 32
    f = (lambda *s, scale=1.0: (scale * rs.randn(*s)).astype(np.float32))
    ls, lb = _ln(rs, C)
    if use in ("ln_qkv", "ln_dense"):
        O = 16 if use == "ln_qkv" else 48
        x = f(B, N, C)
        if use == "ln_qkv":
            w, b = f(C, 3 * O, scale=0.2), f(3 * O, scale=0.1)
            jfn = (lambda x, s, bb, w, b: pf.ln_qkv_reference(
                x, s, bb, w[:, :O], b[:O], w[:, O:], b[O:]))
            tfn = (lambda x, s, bb, w, b: tl.fused_ln_qkv(x, s, bb, w, b, O))
            cot = (f(B, N, O), f(B, N, 2 * O))
        else:
            w, b = f(C, O, scale=0.2), f(O, scale=0.1)
            jfn = pf._ln_dense_reference
            tfn = tl.fused_ln_dense
            cot = f(B, N, O)
        return jfn, tfn, (x, ls, lb, w, b), (3,), (0,), cot
    H = 4 * C
    w1, b1 = f(C, H, scale=0.2), f(H, scale=0.1)
    w2, b2 = f(H, C, scale=0.1), f(C, scale=0.1)
    cot = f(B, N, C)
    if use == "ffn":
        return (pf.ffn_reference, tl.fused_ffn,
                (f(B, N, C), ls, lb, w1, b1, w2, b2), (3, 5), (0,), cot)
    args = (f(B, N, C), f(B, N, C), ls, lb, w1, b1, w2, b2)
    if use == "ffn_residual":
        return (pf.ffn_residual_reference, tl.fused_ffn_residual, args,
                (4, 6), (0, 1), cot)
    keep = 0.7
    ma = np.array([1.0, 0.0], np.float32)
    my = np.array([0.0, 1.0], np.float32)
    return ((lambda *t: pf.ffn_residual_masked_reference(
                keep, *t, jnp.asarray(ma), jnp.asarray(my))),
            (lambda *t: tl.fused_ffn_residual_masked(
                keep, *t, torch.from_numpy(ma), torch.from_numpy(my))),
            args, (4, 6), (0, 1), cot)


USES = ["ln_qkv", "ln_dense", "ffn_residual", "ffn_residual_masked", "ffn"]


def _port_inputs(inputs, weights, dtype):
    """Torch leaves: weights transposed to [out, in]; activations and
    weights in ``dtype``, LN parameters and biases f32."""
    out = []
    for i, a in enumerate(inputs):
        t = torch.from_numpy(np.ascontiguousarray(a.T if i in weights else a))
        if i in weights or a.ndim == 3:
            t = t.to(dtype)
        out.append(t.requires_grad_())
    return out


def _grads(use, dtype):
    jfn, tfn, inputs, weights, acts, cot = _case(use)
    leaves = _port_inputs(inputs, weights, dtype)
    # the JAX side sees the port's (rounded) values, in f32
    jin = [np.asarray(t.detach().float().numpy().T if i in weights
                      else t.detach().float().numpy())
           for i, t in enumerate(leaves)]
    out = tfn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    tc = [torch.from_numpy(c).to(o.dtype) for c, o in zip(cots, outs)]
    torch.autograd.backward(outs, tc)
    jc = tuple(jnp.asarray(c.float().numpy()) for c in tc)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, jin))
    want = vjp(jc if isinstance(cot, tuple) else jc[0])
    got = [t.grad.float().numpy() for t in leaves]
    want = [np.asarray(w).T if i in weights else np.asarray(w)
            for i, w in enumerate(want)]
    return got, want


@pytest.mark.parametrize("use", USES)
def test_ln_linear_backward_f32_matches_jax_vjp(use):
    got, want = _grads(use, torch.float32)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=TOL * scale, rtol=TOL,
                                   err_msg=f"{use} input {i}")


@pytest.mark.parametrize("use", USES)
def test_ln_linear_backward_bf16_against_the_f32_vjp(use, monkeypatch):
    seen = []
    mm = tl._mm

    def record(a, b):
        seen.append((a.dtype, b.dtype))
        return mm(a, b)

    monkeypatch.setattr(tl, "_mm", record)
    got, want = _grads(use, BF)
    assert seen and all(d == (BF, BF) for d in seen), seen
    for i, (g, w) in enumerate(zip(got, want)):
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= BF16_L2, (use, i, err)


def test_linear_proj_backward_bf16_takes_bf16_products(monkeypatch):
    """The attention out-projection's backward: bf16 products, the bias
    gradient summed in the IO dtype, against the f32 VJP."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 20, 32).astype(np.float32)
    w = (0.2 * rs.randn(32, 24)).astype(np.float32)
    b = (0.1 * rs.randn(24)).astype(np.float32)
    cot = rs.randn(2, 20, 24).astype(np.float32)
    seen = []
    mm = tl._mm
    monkeypatch.setattr(tl, "_mm", lambda a, c: seen.append(a.dtype) or mm(a, c))
    xt = torch.from_numpy(x).to(BF).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).to(BF).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    tl.linear_proj(xt, wt, bt).backward(torch.from_numpy(cot).to(BF))
    assert seen and set(seen) == {BF}
    xr, wr = xt.detach().float().numpy(), wt.detach().float().numpy().T
    _, vjp = jax.vjp(lambda x, w, b: jnp.dot(x, w) + b, xr, wr, b)
    want = vjp(jnp.asarray(torch.from_numpy(cot).to(BF).float().numpy()))
    for g, wnt in zip((xt.grad, wt.grad.t(), bt.grad), want):
        g = g.float().numpy()
        assert np.linalg.norm(g - wnt) / np.linalg.norm(wnt) <= BF16_L2
