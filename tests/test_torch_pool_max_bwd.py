"""K3's backward (``ops/pool.py:pool_max_bwd``) and its argmax, held
against the JAX package on the CPU.

The JAX package differentiates ``fused_pool_max`` as the VJP of XLA's
``reduce_window`` (``pallas_pool.py:_pool_max_bwd``); the port's forward
writes each window's argmax tap and the backward gathers g over the
windows that cover each input cell.  The plain twins run here: the argmax
(``pool_max_argmax_reference``) and the gather
(``pool_max_backward_reference``, f32 sums in the kernel's order, one
rounding).  Grids drawn from few levels make ties common: the gradient
must go to the first maximum of each window, as JAX sends it.  Exact in
f32.  In bf16 JAX adds the overlapping windows' cotangents in bf16, each
partial sum rounded, the port in f32 rounded once.  Each of JAX's n - 1
roundings of the n routed cotangents errs by at most half a bf16 ulp of a
partial sum, and the port's one rounding by half an ulp, so the two
differ by at most n / 2 ulps of the sum of the cotangents' magnitudes
(where they cancel, that is more than an ulp of the result).  On the main
path's skip pool (kernel 1 x 3 x 3, stride 2: n <= 4) the test holds them
to one such ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.ops import pallas_pool as pp
from svit_tpu_torch.ops import pool as tp

# (shape [B, T, H, W, C], kernel, stride): the main path's skip pool
# (kernel 3, stride 2) at the reduced size, odd edges, T strides and a
# stride-4 kernel-5 window
CASES = [
    ((2, 4, 14, 14, 16), (1, 3, 3), (1, 2, 2)),
    ((2, 4, 7, 9, 8), (3, 3, 3), (1, 2, 2)),
    ((1, 5, 8, 8, 8), (3, 3, 3), (2, 2, 2)),
    ((1, 2, 9, 9, 8), (1, 5, 5), (1, 4, 4)),
]


def _grid(shape, levels, seed):
    rs = np.random.RandomState(seed)
    if levels:
        return rs.randint(0, levels, shape).astype(np.float32)
    return rs.randn(*shape).astype(np.float32)


def _jax_vjp(x, g, kernel, stride):
    out, vjp = jax.vjp(lambda a: pp.fused_pool_max(a, kernel, stride),
                       jnp.asarray(x))
    return np.asarray(out.astype(jnp.float32)), np.asarray(
        vjp(jnp.asarray(g).astype(out.dtype))[0].astype(jnp.float32))


def _port_vjp(x, g, kernel, stride):
    xt = torch.from_numpy(x).requires_grad_()
    out = tp.fused_pool_max(xt, kernel, stride)
    dx, = torch.autograd.grad(out, xt, torch.from_numpy(g).to(out.dtype))
    return out.detach().float().numpy(), dx.float().numpy()


@pytest.mark.parametrize("levels", [0, 2, 3])
@pytest.mark.parametrize("shape,kernel,stride", CASES)
def test_pool_max_grad_equals_jax_f32(shape, kernel, stride, levels):
    x = _grid(shape, levels, 1)
    out_shape = tp.pool_max_reference(torch.from_numpy(x), kernel,
                                      stride).shape
    g = np.random.RandomState(2).randn(*out_shape).astype(np.float32)
    out_j, dx_j = _jax_vjp(x, g, kernel, stride)
    out_t, dx_t = _port_vjp(x, g, kernel, stride)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(dx_t, dx_j)


@pytest.mark.parametrize("levels", [0, 3])
@pytest.mark.parametrize("shape,kernel,stride", CASES[:2])
def test_pool_max_grad_equals_jax_bf16(shape, kernel, stride, levels):
    """bf16 grid and cotangent: the routing is exact; the sums of n routed
    cotangents differ by at most ceil(n / 2) bf16 ulps of the sum of their
    magnitudes (one on the main path's kernel), and not at all where one
    window routes to a cell."""
    x = _grid(shape, levels, 3)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    out_shape = tp.pool_max_reference(torch.from_numpy(x), kernel,
                                      stride).shape
    g = np.random.RandomState(4).randn(*out_shape).astype(np.float32)
    gb = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    out_j, vjp = jax.vjp(lambda a: pp.fused_pool_max(a, kernel, stride),
                         jnp.asarray(xb, jnp.bfloat16))
    dx_j = np.asarray(vjp(jnp.asarray(gb, jnp.bfloat16))[0].astype(
        jnp.float32))
    xt = torch.from_numpy(xb.copy()).to(torch.bfloat16).requires_grad_()
    out = tp.fused_pool_max(xt, kernel, stride)
    dx_t, = torch.autograd.grad(out, xt, torch.from_numpy(gb).to(
        torch.bfloat16))
    np.testing.assert_array_equal(out.float().detach().numpy(),
                                  np.asarray(out_j.astype(jnp.float32)))
    dx_t = dx_t.float().numpy()
    arg = tp.pool_max_argmax_reference(torch.from_numpy(xb), kernel, stride)
    mags = tp.pool_max_backward_reference(
        torch.from_numpy(np.abs(gb)), arg, kernel, stride, shape).numpy()
    hits = tp.pool_max_backward_reference(
        torch.ones(arg.shape), arg, kernel, stride, shape).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mags, 2.0 ** -126))) - 7)
    if kernel != (1, 3, 3):
        ulp = ulp * np.maximum(1, np.ceil(hits / 2))
    err = np.abs(dx_t - dx_j)
    assert np.all(err <= ulp), float((err / ulp).max())
    # where at most one window routes to a cell there is no sum to round
    np.testing.assert_array_equal(dx_t[hits <= 1], dx_j[hits <= 1])


@pytest.mark.parametrize("shape,kernel,stride", CASES)
def test_argmax_is_the_first_valid_maximum(shape, kernel, stride):
    """The argmax tap against a direct scan of each window's taps inside
    the grid, on a grid of two levels and on one all -inf corner."""
    x = _grid(shape, 2, 5)
    x[0, 0, :3, :3] = -np.inf
    xt = torch.from_numpy(x)
    arg = tp.pool_max_argmax_reference(xt, kernel, stride).numpy()
    B, T, H, W, C = shape
    kT, kH, kW = kernel
    sT, sH, sW = stride
    To, Ho, Wo = arg.shape[1:4]
    for b, to, ho, wo in np.ndindex(B, To, Ho, Wo):
        best = np.full(C, -1)
        top = np.full(C, -np.inf)
        for dt, dh, dw in np.ndindex(kT, kH, kW):
            t, h, w = (to * sT - kT // 2 + dt, ho * sH - kH // 2 + dh,
                       wo * sW - kW // 2 + dw)
            if not (0 <= t < T and 0 <= h < H and 0 <= w < W):
                continue
            tap = (dt * kH + dh) * kW + dw
            v = x[b, t, h, w]
            take = (best < 0) | (v > top)
            best = np.where(take, tap, best)
            top = np.where(v > top, v, top)
        np.testing.assert_array_equal(arg[b, to, ho, wo], best)


def test_backward_twin_adds_in_window_order():
    """The twin's f32 sums run over the windows in (to, ho, wo) order, as
    the kernel's do: with values whose f32 sum depends on the order, dx
    equals a per-cell loop in that order bit for bit."""
    kernel, stride, shape = (1, 3, 3), (1, 2, 2), (1, 1, 5, 5, 8)
    x = np.zeros(shape, np.float32)   # every tap ties: the first wins
    xt = torch.from_numpy(x)
    arg = tp.pool_max_argmax_reference(xt, kernel, stride)
    rs = np.random.RandomState(6)
    g = (rs.randn(*arg.shape) * 10.0 ** rs.randint(-4, 4, arg.shape)
         ).astype(np.float32)
    dx = tp.pool_max_backward_reference(torch.from_numpy(g), arg, kernel,
                                        stride, shape).numpy()
    want = np.zeros(shape, np.float32)
    Ho, Wo = arg.shape[2:4]
    for h, w in np.ndindex(5, 5):
        for ho, wo in np.ndindex(Ho, Wo):
            dh, dw = h - (ho * 2 - 1), w - (wo * 2 - 1)
            if 0 <= dh < 3 and 0 <= dw < 3:
                hit = arg[0, 0, ho, wo].numpy() == dh * 3 + dw
                want[0, 0, h, w] = np.where(
                    hit, want[0, 0, h, w] + g[0, 0, ho, wo],
                    want[0, 0, h, w])
    np.testing.assert_array_equal(dx, want)
