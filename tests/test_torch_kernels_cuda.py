"""The hand-written CUDA kernels against their plain versions, on the card.

These need an NVIDIA card and ``nvcc``; without a card they skip.  Run them
there with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``
(the suite's conftest imports JAX, which the card's machine need not have).  Shapes are
small cases of the main path's (head_dim 96, ragged tiles).

Gate (as ``chip_smoke.py``): relative L2 error of the kernel against the
plain version in f32 on the same bf16 inputs must stay within 3x the plain
bf16 version's own error + 2e-3.
"""

import os

import pytest
import torch

from svit_tpu_torch.ops import _lib
from svit_tpu_torch.ops import attention as ta
from svit_tpu_torch.ops import ln_linear as tl
from svit_tpu_torch.ops import pool as tp

pytestmark = pytest.mark.cuda
BF = torch.bfloat16


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False   # the f32 plain convs
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0, dtype=BF):
    return (scale * torch.randn(shape, device="cuda", generator=gen)).to(dtype)


def _f32(obj):
    if torch.is_tensor(obj):
        return obj.float()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_f32(o) for o in obj)
    return obj


def _flat(out):
    if torch.is_tensor(out):
        return out.float().flatten()
    return torch.cat([_flat(o) for o in out if o is not None])


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _gate(kernel, plain, *args, **kwargs):
    before = _lib.LAUNCHES.copy()
    out = _flat(kernel(*args, **kwargs))
    torch.cuda.synchronize()
    assert sum((_lib.LAUNCHES - before).values()) >= 1
    p16 = _flat(plain(*args, **kwargs))
    p32 = _flat(plain(*_f32(args), **{k: _f32(v) for k, v in kwargs.items()}))
    assert torch.isfinite(out).all()
    assert _rel(out, p32) <= 3 * _rel(p16, p32) + 2e-3


def _ln(gen, K):
    return (1 + _randn(gen, K, scale=0.1, dtype=torch.float32),
            _randn(gen, K, scale=0.1, dtype=torch.float32))


# (M, K, N): the tensor-parallel fc2 partials of a model-2 split (each
# rank's half of the hidden width) at stage 0 and stage 3, ragged rows
@pytest.mark.parametrize("M,K,N", [(6272, 192, 96), (333, 1536, 768)])
def test_ln_linear_f32_partial(gen, M, K, N):
    """K1's f32 mode: the product alone, unrounded (no bias, rounding,
    mask or residual), against the plain twin's f32 product."""
    x = _randn(gen, M, K)
    w = _randn(gen, N, K, scale=K ** -0.5)
    out = tl.ln_linear(x, w, out_f32=True)
    assert out.dtype == torch.float32 and out.shape == (M, N)
    _gate(lambda x, w: tl.ln_linear(x, w, out_f32=True),
          lambda x, w: tl.ln_linear_reference(x, w, out_f32=True), x, w)
    with pytest.raises(ValueError, match="out_f32"):
        tl.ln_linear(x, w, _randn(gen, N, dtype=torch.float32), out_f32=True)


@pytest.mark.parametrize("M,K,N", [(1000, 96, 288), (333, 384, 96),
                                   (3137, 768, 2304)])
def test_ln_linear_ln_qkv_split(gen, M, K, N):
    x = _randn(gen, M, K)
    w = _randn(gen, N, K, scale=K ** -0.5)
    b = _randn(gen, N, scale=0.1, dtype=torch.float32)
    _gate(tl.ln_linear, tl.ln_linear_reference, x, w, b, ln=_ln(gen, K),
          split=N // 3)


@pytest.mark.parametrize("split", [8, 40, 200, 280])
def test_ln_linear_split_inside_a_tile(gen, split):
    """The q | kv split off every 32-column boundary: the two outputs share
    the epilogue's tiles."""
    M, K, N = 333, 96, 288
    x = _randn(gen, M, K)
    w = _randn(gen, N, K, scale=K ** -0.5)
    b = _randn(gen, N, scale=0.1, dtype=torch.float32)
    _gate(tl.ln_linear, tl.ln_linear_reference, x, w, b, ln=_ln(gen, K),
          split=split)


@pytest.mark.parametrize("K", [96, 192, 384, 768, 1536, 3072])
@pytest.mark.parametrize("M", [333, 1000, 3137])
def test_ln_linear_rows_and_depths(gen, M, K):
    """Rows off the block edge and every K of the main path: with the LN
    panel (and GELU) up to K = 768, the streaming GEMM with a residual
    beyond (fc2's K = 4C)."""
    N = 200
    x = _randn(gen, M, K)
    w = _randn(gen, N, K, scale=K ** -0.5)
    b = _randn(gen, N, scale=0.1, dtype=torch.float32)
    if K <= 768:
        _gate(tl.ln_linear, tl.ln_linear_reference, x, w, b, ln=_ln(gen, K),
              gelu=True)
    else:
        _gate(tl.ln_linear, tl.ln_linear_reference, x, w, b,
              residual=_randn(gen, M, N))


@pytest.mark.parametrize("M,K,N", [(1000, 192, 768), (3137, 768, 3072)])
def test_ln_linear_x_add_writes_the_sum(gen, M, K, N):
    x, a = _randn(gen, M, K), _randn(gen, M, K)
    w = _randn(gen, N, K, scale=K ** -0.5)
    b = _randn(gen, N, scale=0.1, dtype=torch.float32)
    _gate(tl.ln_linear, tl.ln_linear_reference, x, w, b, ln=_ln(gen, K),
          x_add=a, gelu=True)
    y, s = tl.ln_linear(x, w, b, ln=_ln(gen, K), x_add=a, gelu=True)
    torch.testing.assert_close(s, x + a, atol=0, rtol=0)


@pytest.mark.parametrize("C,rows", [(96, 250), (768, 49)])
def test_ln_linear_masked_modes(gen, C, rows):
    """K1's masked mode at both ends of the main path's widths: fc1 with
    x_add / keep * ma, fc2 with round(out) / keep * my + residual."""
    B = 4
    x, a = _randn(gen, B * rows, C), _randn(gen, B * rows, C)
    w1 = _randn(gen, 4 * C, C, scale=C ** -0.5)
    w2 = _randn(gen, C, 4 * C, scale=(4 * C) ** -0.5)
    b1 = _randn(gen, 4 * C, scale=0.1, dtype=torch.float32)
    b2 = _randn(gen, C, scale=0.1, dtype=torch.float32)
    ma = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda")
    my = torch.tensor([0.0, 1.0, 1.0, 1.0], device="cuda")
    _gate(tl.ln_linear, tl.ln_linear_reference, x, w1, b1, ln=_ln(gen, C),
          x_add=a, gelu=True, mask_add=ma, keep=0.6, rows=rows)
    h = _randn(gen, B * rows, 4 * C)
    _gate(tl.ln_linear, tl.ln_linear_reference, h, w2, b2, residual=x,
          mask_out=my, keep=0.6, rows=rows)


def test_ln_linear_round_then_bias(gen):
    x = _randn(gen, 3137, 768)
    w = _randn(gen, 768, 768, scale=768 ** -0.5)
    b = _randn(gen, 768, scale=0.1, dtype=torch.float32)
    _gate(tl.ln_linear, tl.ln_linear_reference, x, w, b, round_then_bias=True)


@pytest.mark.parametrize("M,C", [(200704, 96), (3136, 768)])
def test_fused_ffn_stage_shapes(gen, M, C):
    """``fused_ffn`` at the MLP widths of stage 0 and stage 3 (batch 8)."""
    x = _randn(gen, M, C)
    w1 = _randn(gen, 4 * C, C, scale=C ** -0.5)
    w2 = _randn(gen, C, 4 * C, scale=(4 * C) ** -0.5)
    b1 = _randn(gen, 4 * C, scale=0.1, dtype=torch.float32)
    b2 = _randn(gen, C, scale=0.1, dtype=torch.float32)
    before = _lib.LAUNCHES["ln_linear"]
    _gate(tl.fused_ffn, tl.ffn_reference, x, *_ln(gen, C), w1, b1, w2, b2)
    assert _lib.LAUNCHES["ln_linear"] - before == 2


def test_ln_linear_ffn_residual(gen):
    M, C = 777, 96
    x_res, a = _randn(gen, 1, M, C), _randn(gen, 1, M, C)
    ln = (1 + _randn(gen, C, scale=0.1, dtype=torch.float32),
          _randn(gen, C, scale=0.1, dtype=torch.float32))
    w1 = _randn(gen, 4 * C, C, scale=C ** -0.5)
    w2 = _randn(gen, C, 4 * C, scale=(4 * C) ** -0.5)
    b1 = _randn(gen, 4 * C, scale=0.1, dtype=torch.float32)
    b2 = _randn(gen, C, scale=0.1, dtype=torch.float32)
    _gate(tl.fused_ffn_residual, tl.ffn_residual_reference, x_res, a, *ln,
          w1, b1, w2, b2)
    _gate(tl.linear_proj, tl.linear_proj_reference, x_res, w2[:, :C].contiguous(),
          b2)


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 8, 8)])
def test_pool_ln(gen, stride):
    C, hd = 192, 96
    x = _randn(gen, 2, 4, 16, 16, C)
    w = _randn(gen, C, 1, 3, 3, 3, scale=0.2, dtype=torch.float32)
    ls = 1 + _randn(gen, C, scale=0.1, dtype=torch.float32)
    lb = _randn(gen, C, scale=0.1, dtype=torch.float32)
    _gate(tp.fused_pool_ln, tp.pool_ln_reference, x, w, ls, lb, stride, hd)


def test_pool_max(gen):
    x = _randn(gen, 2, 4, 14, 14, 192)
    out = tp.fused_pool_max(x, (1, 3, 3), (1, 2, 2))
    torch.testing.assert_close(out, tp.pool_max_reference(x, (1, 3, 3), (1, 2, 2)),
                               atol=0, rtol=0)


# the main path's skip pools (kernel 1 x 3 x 3, stride 2, at fewer clips:
# the tuned instance) at its true channel counts and at half of them, an
# odd-edged one, a 3 x 3 x 3 window at T stride 2 and a stride-4 kernel-5
# one (the general gather)
POOL_MAX_CASES = [
    ((2, 8, 56, 56, 96), (1, 3, 3), (1, 2, 2)),
    ((2, 8, 28, 28, 192), (1, 3, 3), (1, 2, 2)),
    ((2, 8, 14, 14, 384), (1, 3, 3), (1, 2, 2)),
    ((2, 8, 56, 56, 192), (1, 3, 3), (1, 2, 2)),
    ((2, 8, 28, 28, 384), (1, 3, 3), (1, 2, 2)),
    ((2, 8, 14, 14, 768), (1, 3, 3), (1, 2, 2)),
    ((2, 1, 56, 56, 192), (1, 3, 3), (1, 2, 2)),
    ((1, 2, 57, 55, 96), (1, 3, 3), (1, 2, 2)),
    ((2, 5, 9, 11, 16), (3, 3, 3), (2, 2, 2)),
    ((1, 2, 9, 9, 8), (1, 5, 5), (1, 4, 4)),
]


@pytest.mark.parametrize("levels", [0, 3])
@pytest.mark.parametrize("shape,kernel,stride", POOL_MAX_CASES)
def test_pool_max_bwd(gen, shape, kernel, stride, levels):
    """K3's argmax and ``pool_max_bwd`` against their plain twins, bit for
    bit, on random grids and on grids of three levels (ties in most
    windows), with a cotangent of widely spread magnitudes (so that another
    adding order shows); the instance the plan routes to against the
    general gather, bit for bit; a rerun is bit-identical (no atomics); the
    differentiated forward counts one K3 and the backward one
    pool_max_bwd."""
    x = (torch.randint(0, levels, shape, device="cuda", generator=gen)
         .to(BF) if levels else _randn(gen, *shape))
    out, arg = tp._pool_max(x, kernel, stride, with_arg=True)
    assert torch.equal(out, tp.pool_max_reference(x, kernel, stride))
    assert torch.equal(arg, tp.pool_max_argmax_reference(x, kernel, stride))
    spread = torch.randint(-24, 25, out.shape, device="cuda", generator=gen)
    g = (_randn(gen, *out.shape).float() * torch.exp2(spread.float())).to(BF)
    dx = tp.pool_max_bwd(g, arg, kernel, stride, shape)
    torch.cuda.synchronize()
    want = tp.pool_max_backward_reference(g, arg, kernel, stride, shape)
    assert torch.equal(dx.view(torch.int16), want.view(torch.int16))
    route = tp.max_bwd_plan(shape, kernel, stride).route
    assert route == ("tile" if (kernel, stride) == ((1, 3, 3), (1, 2, 2))
                     and shape[-1] % 96 == 0 else "gather")
    general = tp.pool_max_bwd(g, arg, kernel, stride, shape, general=True)
    assert torch.equal(dx.view(torch.int16), general.view(torch.int16))
    assert torch.equal(dx, tp.pool_max_bwd(g, arg, kernel, stride, shape))
    before = _lib.LAUNCHES.copy()
    xr = x.detach().requires_grad_()
    dx2, = torch.autograd.grad(tp.fused_pool_max(xr, kernel, stride), xr, g)
    assert torch.equal(dx2, dx)
    got = _lib.LAUNCHES - before
    assert got["pool_max"] == 1 and got["pool_max_bwd"] == 1


def _max_grid(gen, shape, grid):
    """A bf16 grid for K3: random, three levels (ties in most windows), all
    negative (the border windows must never see a zero), with NaN (torch's
    NaN, 0x7fc0: the plain twins keep its bits) or with -inf (some windows
    all -inf)."""
    if grid == "three":
        return torch.randint(0, 3, shape, device="cuda", generator=gen).to(BF)
    x = torch.randn(shape, device="cuda", generator=gen)
    if grid == "negative":
        return (-0.5 - x.abs()).to(BF)
    u = torch.rand(shape, device="cuda", generator=gen)
    if grid == "nan":
        x[u < 0.05] = float("nan")
    elif grid == "-inf":
        x[u < 0.3] = float("-inf")
        x[:, :, :3, :3] = float("-inf")
    return x.to(BF)


# the skip pool at the main path's channel counts (fewer clips), odd edges,
# one frame, tiny grids, and other kernels and strides
POOL_MAX_FWD_CASES = [c[0] for c in POOL_MAX_CASES] + [
    (1, 1, 7, 9, 192), (2, 1, 3, 2, 96), (1, 1, 1, 1, 96)]


@pytest.mark.parametrize("grid", ["random", "three", "negative", "nan",
                                  "-inf"])
@pytest.mark.parametrize("shape", POOL_MAX_FWD_CASES)
def test_pool_max_fwd(gen, shape, grid):
    """Both K3 instances (the serving one and the one that writes the
    argmax) against the plain twins, bit for bit: the output's bf16 bits
    (NaN's included) and the argmax bytes; one launch each."""
    kernel, stride = ((1, 3, 3), (1, 2, 2)) if shape[-1] % 96 == 0 else \
        next((k, s) for sh, k, s in POOL_MAX_CASES if sh == shape)
    x = _max_grid(gen, shape, grid)
    want = tp.pool_max_reference(x, kernel, stride).view(torch.int16)
    want_arg = tp.pool_max_argmax_reference(x, kernel, stride)
    before = _lib.LAUNCHES.copy()
    out = tp._pool_max(x, kernel, stride)
    out2, arg = tp._pool_max(x, kernel, stride, with_arg=True)
    torch.cuda.synchronize()
    assert (_lib.LAUNCHES - before)["pool_max"] == 2
    assert torch.equal(out.view(torch.int16), want)
    assert torch.equal(out2.view(torch.int16), want)
    assert torch.equal(arg, want_arg)


def test_pool_max_bwd_first_on_the_backward_thread(gen):
    """A backward whose first kernel encodes a tensor map (the tuned K3
    backward) on autograd's device thread, before anything else has run
    there: the encoder makes the context current on that thread.  A new
    process, so that the thread is fresh."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from svit_tpu_torch.ops import pool as tp\n"
        "x = torch.randn(2, 1, 14, 14, 96, device='cuda').to(torch.bfloat16)\n"
        "x.requires_grad_()\n"
        "y = tp.fused_pool_max(x, (1, 3, 3), (1, 2, 2))\n"
        "g = torch.randn_like(y)\n"
        "dx, = torch.autograd.grad(y, x, g)\n"
        "_, arg = tp._pool_max(x.detach(), (1, 3, 3), (1, 2, 2), True)\n"
        "want = tp.pool_max_backward_reference(g, arg, (1, 3, 3),\n"
        "                                      (1, 2, 2), x.shape)\n"
        "assert torch.equal(dx, want)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]


@pytest.mark.parametrize("heads,q_residual,with_bias", [
    (1, True, True), (2, False, True), (4, True, False)])
def test_pooled_attention(gen, heads, q_residual, with_bias):
    B, hd, k_shape, E = 2, 96, (4, 5, 5), 65
    C = heads * hd
    Nq, Nk = 300, 100 + E
    q = _randn(gen, B, Nq, C)
    kv = _randn(gen, B, Nk, 2 * C)
    bias = (_randn(gen, B, heads, Nq, sum(k_shape), scale=0.5)
            if with_bias else None)
    _gate(ta.pooled_attention, ta.pooled_attention_reference, q, kv, bias,
          k_shape, hd ** -0.5, heads, q_residual)


@pytest.mark.parametrize("heads,q_residual,with_bias", [
    (1, True, True), (2, False, True), (4, True, False)])
def test_pooled_attention_bwd(gen, heads, q_residual, with_bias):
    B, hd, k_shape, E = 2, 96, (4, 5, 5), 65
    C = heads * hd
    Nq, Nk = 300, 100 + E
    q = _randn(gen, B, Nq, C)
    kv = _randn(gen, B, Nk, 2 * C)
    do = _randn(gen, B, Nq, C)
    bias = (_randn(gen, B, heads, Nq, sum(k_shape), scale=0.5)
            if with_bias else None)
    _gate(ta.pooled_attention_bwd, ta.pooled_attention_bwd_reference, q, kv,
          bias, do, k_shape, hd ** -0.5, heads, q_residual)


# (B, Nq, k_shape, extras, heads, head_dim, q_residual, bias): the main
# path's key counts (Nk 457, 1633, 54, 201), query counts (392, 1568, 65, 5
# and 49, 196), bias widths (R 22, 36, 15, 29) and heads 1 to 8, at fewer
# clips; a 6272-query call for K5's query splits; head_dim 64 and 128 once
# each
MAIN_PATH = [
    (2, 392, (8, 7, 7), 65, 8, 96, True, True),
    (1, 1568, (8, 14, 14), 65, 4, 96, True, True),
    (2, 65, (8, 7, 7), 65, 2, 96, True, False),
    (2, 65, (8, 14, 14), 65, 1, 96, True, False),
    (4, 49, (1, 7, 7), 5, 8, 96, True, True),
    (4, 5, (1, 14, 14), 5, 1, 96, False, False),
    (2, 196, (1, 14, 14), 5, 2, 96, True, True),
    (2, 6272, (8, 7, 7), 65, 2, 96, True, True),
    (2, 300, (4, 5, 5), 65, 1, 64, True, True),
    (2, 300, (4, 5, 5), 65, 2, 128, False, True),
]


def _attention_inputs(gen, B, Nq, k_shape, extras, heads, hd, bias):
    C = heads * hd
    Nk = k_shape[0] * k_shape[1] * k_shape[2] + extras
    q = _randn(gen, B, Nq, C)
    kv = _randn(gen, B, Nk, 2 * C)
    b = _randn(gen, B, heads, Nq, sum(k_shape), scale=0.5) if bias else None
    return q, kv, b


@pytest.mark.parametrize("B,Nq,k_shape,extras,heads,hd,q_residual,bias",
                         MAIN_PATH)
def test_pooled_attention_main_path_shapes(gen, B, Nq, k_shape, extras,
                                           heads, hd, q_residual, bias):
    q, kv, b = _attention_inputs(gen, B, Nq, k_shape, extras, heads, hd, bias)
    _gate(ta.pooled_attention, ta.pooled_attention_reference, q, kv, b,
          k_shape, hd ** -0.5, heads, q_residual)


@pytest.mark.parametrize("B,Nq,k_shape,extras,heads,hd,q_residual,bias",
                         MAIN_PATH)
def test_pooled_attention_bwd_main_path_shapes(gen, B, Nq, k_shape, extras,
                                               heads, hd, q_residual, bias):
    q, kv, b = _attention_inputs(gen, B, Nq, k_shape, extras, heads, hd, bias)
    do = _randn(gen, *q.shape)
    _gate(ta.pooled_attention_bwd, ta.pooled_attention_bwd_reference, q, kv,
          b, do, k_shape, hd ** -0.5, heads, q_residual)


def test_pooled_attention_bwd_is_deterministic(gen):
    """Two runs on the same inputs agree bit for bit: the key side sums its
    query splits' partials in a fixed order, with no atomics."""
    B, Nq, k_shape, extras, heads, hd = 2, 6272, (8, 7, 7), 65, 2, 96
    q, kv, b = _attention_inputs(gen, B, Nq, k_shape, extras, heads, hd, True)
    do = _randn(gen, *q.shape)
    plan = ta.attention_plan(B, Nq, kv.shape[1], heads * hd, heads,
                             sum(k_shape), backward=True,
                             sms=_lib.sm_count(q.device))
    assert plan.splits > 1
    one = ta.pooled_attention_bwd(q, kv, b, do, k_shape, hd ** -0.5, heads,
                                  True)
    two = ta.pooled_attention_bwd(q, kv, b, do, k_shape, hd ** -0.5, heads,
                                  True)
    for x, y in zip(one, two):
        assert torch.equal(x, y)


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 8, 8)])
def test_depthwise_conv_and_its_gradients(gen, stride):
    B, T, H, W, C = 2, 4, 16, 16, 192
    x = _randn(gen, B, T, H, W, C)
    w = _randn(gen, C, 1, 3, 3, 3, scale=0.2, dtype=torch.float32)
    _gate(lambda x, w: tp.depthwise_conv(x, w, stride, 96),
          lambda x, w: tp.depthwise_conv_reference(x, w, stride), x, w)
    To, Ho, Wo = (tp.out_size(d, 3, s) for d, s in zip((T, H, W), stride))
    g = _randn(gen, B, To, Ho, Wo, C)
    _gate(tp.depthwise_conv_dx, tp.depthwise_conv_dx_reference, g, w, stride,
          (B, T, H, W, C))
    _gate(tp.depthwise_conv_dk, tp.depthwise_conv_dk_reference, x, g,
          (3, 3, 3), stride)


# every distinct (C, stride, input grid) of the pools of the SViT-B/16
# forward (``configs/ssv2.yaml``): the q pools, then the fused k|v pools
POOL_CALLS = [(96, 1, 56), (192, 2, 56), (192, 1, 28), (384, 2, 28),
              (384, 1, 14), (768, 2, 14), (768, 1, 7), (192, 8, 56),
              (384, 4, 56), (384, 4, 28), (768, 2, 28), (1536, 1, 14),
              (1536, 1, 7)]
# a clip of 8 latent frames at batch 1, and two images (T = 1, kT = 3)
POOL_BT = [(1, 8), (2, 1)]


def _pool_inputs(gen, B, T, H, W, C, stride):
    x = _randn(gen, B, T, H, W, C)
    w = _randn(gen, C, 1, 3, 3, 3, scale=0.2, dtype=torch.float32)
    ls = 1 + _randn(gen, C, scale=0.1, dtype=torch.float32)
    lb = _randn(gen, C, scale=0.1, dtype=torch.float32)
    To, Ho, Wo = (tp.out_size(d, 3, s) for d, s in zip((T, H, W), stride))
    g = _randn(gen, B, To, Ho, Wo, C)
    return x, w, ls, lb, g


@pytest.mark.parametrize("B,T", POOL_BT)
@pytest.mark.parametrize("C,s,side", POOL_CALLS)
def test_pool_ln_main_path_shapes(gen, C, s, side, B, T):
    """K2 in both modes and K7 at the main path's shapes."""
    stride = (1, s, s)
    x, w, ls, lb, g = _pool_inputs(gen, B, T, side, side, C, stride)
    _gate(tp.fused_pool_ln, tp.pool_ln_reference, x, w, ls, lb, stride, 96)
    _gate(lambda x, w: tp.depthwise_conv(x, w, stride, 96),
          lambda x, w: tp.depthwise_conv_reference(x, w, stride), x, w)
    _gate(tp.depthwise_conv_dk, tp.depthwise_conv_dk_reference, x, g,
          (3, 3, 3), stride)


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 8, 8),
                                    (1, 1, 2), (1, 3, 1)])
@pytest.mark.parametrize("shape", [(2, 3, 13, 19, 192), (1, 5, 9, 30, 96),
                                   (3, 2, 33, 5, 288)])
def test_pool_ragged_tiles(gen, shape, stride):
    """Grids whose H and W are no multiple of the plan's tile, odd frame
    counts and strides that differ between H and W; kT 1 and 3."""
    B, T, H, W, C = shape
    x, w, ls, lb, g = _pool_inputs(gen, B, T, H, W, C, stride)
    _gate(tp.fused_pool_ln, tp.pool_ln_reference, x, w, ls, lb, stride, 96)
    _gate(tp.depthwise_conv_dk, tp.depthwise_conv_dk_reference, x, g,
          (3, 3, 3), stride)
    w1 = w[:, :, 1:2].contiguous()
    _gate(lambda x, w: tp.depthwise_conv(x, w, stride, 96),
          lambda x, w: tp.depthwise_conv_reference(x, w, stride), x, w1)
    To, Ho, Wo = (tp.out_size(d, k, s) for d, k, s in
                  zip((T, H, W), (1, 3, 3), stride))
    g1 = _randn(gen, B, To, Ho, Wo, C)
    _gate(tp.depthwise_conv_dk, tp.depthwise_conv_dk_reference, x, g1,
          (1, 3, 3), stride)


@pytest.mark.parametrize("C,s,side", [(96, 1, 56), (384, 4, 56),
                                      (768, 2, 14)])
def test_depthwise_conv_dk_is_deterministic(gen, C, s, side):
    """K7 adds its partials in a fixed order: a rerun is bit-identical."""
    stride = (1, s, s)
    x, _, _, _, g = _pool_inputs(gen, 2, 8, side, side, C, stride)
    one = tp.depthwise_conv_dk(x, g, (3, 3, 3), stride)
    two = tp.depthwise_conv_dk(x, g, (3, 3, 3), stride)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


# the widened K2, K6 and K7 (shape, kernel, stride, head_dim of the LN):
# head widths 64 and 128, (3, 5, 5) and (1, 3, 5) kernels, T stride 2 and
# strides that differ between H and W, ragged grids
WIDE = [((2, 4, 14, 14, 128), (3, 3, 3), (1, 1, 1), 64),
        ((2, 4, 14, 14, 256), (3, 3, 3), (1, 2, 2), 128),
        ((1, 5, 15, 13, 192), (3, 5, 5), (1, 1, 1), 64),
        ((1, 6, 17, 19, 128), (3, 5, 5), (1, 2, 1), 128),
        ((2, 5, 13, 12, 128), (3, 3, 3), (2, 2, 2), 64),
        ((1, 4, 29, 31, 192), (3, 5, 5), (1, 4, 4), 96),
        ((1, 3, 33, 35, 128), (1, 3, 5), (2, 8, 8), 128),
        ((2, 3, 11, 9, 96), (3, 5, 3), (1, 3, 2), 96)]


def _wide_inputs(gen, shape, kernel, stride):
    B, T, H, W, C = shape
    x = _randn(gen, *shape)
    w = _randn(gen, C, 1, *kernel, scale=0.2, dtype=torch.float32)
    ls = 1 + _randn(gen, C, scale=0.1, dtype=torch.float32)
    lb = _randn(gen, C, scale=0.1, dtype=torch.float32)
    To, Ho, Wo = (tp.out_size(d, k, s) for d, k, s in
                  zip((T, H, W), kernel, stride))
    return x, w, ls, lb, _randn(gen, B, To, Ho, Wo, C)


@pytest.mark.parametrize("shape,kernel,stride,hd", WIDE)
def test_pool_widened_shapes(gen, shape, kernel, stride, hd):
    """K2 (LN and bare), K6 and, where it takes the stride, K7 at the shapes
    the JAX package's fused_pool_ln takes beyond the main path's."""
    x, w, ls, lb, g = _wide_inputs(gen, shape, kernel, stride)
    _gate(tp.fused_pool_ln, tp.pool_ln_reference, x, w, ls, lb, stride, hd)
    _gate(lambda x, w: tp.depthwise_conv(x, w, stride, hd),
          lambda x, w: tp.depthwise_conv_reference(x, w, stride), x, w)
    _gate(tp.depthwise_conv_dx, tp.depthwise_conv_dx_reference, g, w, stride,
          shape)
    if tp.dk_takes(shape, kernel, stride):
        _gate(tp.depthwise_conv_dk, tp.depthwise_conv_dk_reference, x, g,
              kernel, stride)
    else:
        with pytest.raises(ValueError, match="_dk_pallas"):
            tp.depthwise_conv_dk(x, g, kernel, stride)


def test_pool_raises_outside_the_set(gen):
    """A shape no instance takes raises, naming the limit; nothing falls
    back."""
    x = _randn(gen, 1, 4, 8, 8, 96)
    ls = torch.ones(96, device="cuda")
    for kernel, stride, hd, what in (((3, 7, 7), (1, 1, 1), 96, "kernels"),
                                     ((3, 3, 3), (3, 1, 1), 96, "T stride"),
                                     ((3, 3, 3), (1, 1, 1), 40, "head_dim")):
        w = torch.zeros(96, 1, *kernel, device="cuda")
        with pytest.raises(ValueError, match=what):
            tp.fused_pool_ln(x, w, ls, ls, stride, hd)
    with pytest.raises(ValueError, match="multiple"):
        tp.depthwise_conv(_randn(gen, 1, 4, 8, 8, 100),
                          torch.zeros(100, 1, 3, 3, 3, device="cuda"),
                          (1, 1, 1), 100)


@pytest.mark.parametrize("B,T", POOL_BT)
@pytest.mark.parametrize("C,s,side", POOL_CALLS)
def test_conv_dx_main_path_shapes(gen, C, s, side, B, T):
    """K6 at the main path's shapes: the parity classes at stride 2, 4 and
    8, K2's bare loop on the flipped filter at stride 1."""
    stride = (1, s, s)
    _, w, _, _, g = _pool_inputs(gen, B, T, side, side, C, stride)
    before = _lib.LAUNCHES["pool_conv_dx"]
    _gate(tp.depthwise_conv_dx, tp.depthwise_conv_dx_reference, g, w, stride,
          (B, T, side, side, C))
    assert _lib.LAUNCHES["pool_conv_dx"] == before + 1


@pytest.mark.parametrize("C,s,side", [(96, 1, 56), (192, 2, 56),
                                      (384, 4, 56), (192, 8, 56)])
def test_conv_dx_is_deterministic(gen, C, s, side):
    """K6 sums each dx position's taps in a fixed order: a rerun is
    bit-identical."""
    stride = (1, s, s)
    _, w, _, _, g = _pool_inputs(gen, 2, 8, side, side, C, stride)
    shape = (2, 8, side, side, C)
    one = tp.depthwise_conv_dx(g, w, stride, shape)
    two = tp.depthwise_conv_dx(g, w, stride, shape)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


def test_ffn_residual_masked(gen):
    B, rows, C = 4, 250, 96
    x_res, a = _randn(gen, B, rows, C), _randn(gen, B, rows, C)
    ln = (1 + _randn(gen, C, scale=0.1, dtype=torch.float32),
          _randn(gen, C, scale=0.1, dtype=torch.float32))
    w1 = _randn(gen, 4 * C, C, scale=C ** -0.5)
    w2 = _randn(gen, C, 4 * C, scale=(4 * C) ** -0.5)
    b1 = _randn(gen, 4 * C, scale=0.1, dtype=torch.float32)
    b2 = _randn(gen, C, scale=0.1, dtype=torch.float32)
    ma = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda")
    my = torch.tensor([0.0, 1.0, 1.0, 1.0], device="cuda")
    _gate(tl.fused_ffn_residual_masked, tl.ffn_residual_masked_reference, 0.6,
          x_res, a, *ln, w1, b1, w2, b2, ma, my)


def _grads(fn, inputs, cot):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    torch.autograd.backward(out, cot)
    return [t.grad for t in leaves]


def test_autograd_through_the_kernels(gen):
    """Gradients of fused_attention_proj (K5) and fused_pool_ln (K2 bare, K6,
    K7) against the plain twins' autograd in bf16 and f32."""
    B, heads, hd, k_shape, E = 2, 2, 96, (2, 4, 4), 9
    C = heads * hd
    q = _randn(gen, B, 4 * 8 * 8, C)
    kv = _randn(gen, B, 32 + E, 2 * C)
    bias = _randn(gen, B, heads, q.shape[1], sum(k_shape), scale=0.5)
    wp = _randn(gen, C, C, scale=C ** -0.5)
    bp = _randn(gen, C, scale=0.1, dtype=torch.float32)
    g = _randn(gen, B, q.shape[1], C)
    args = (k_shape,)

    def att(op):
        return lambda q, kv, bias, wp, bp: op(q, kv, bias, *args, wp, bp,
                                             hd ** -0.5, heads, True)
    inputs = (q, kv, bias, wp, bp)
    _gate(lambda *a: _grads(att(ta.fused_attention_proj), a[:5], a[5]),
          lambda *a: _grads(att(ta.attention_proj_reference), a[:5], a[5]),
          *inputs, g)

    x = _randn(gen, B, 4, 16, 16, C)
    w = _randn(gen, C, 1, 3, 3, 3, scale=0.2, dtype=torch.float32)
    ls = 1 + _randn(gen, C, scale=0.1, dtype=torch.float32)
    lb = _randn(gen, C, scale=0.1, dtype=torch.float32)
    gp = _randn(gen, B, 4, 8, 8, C)

    def pool(op):
        return lambda *a: _grads(lambda x, w, ls, lb: op(x, w, ls, lb,
                                                         (1, 2, 2), hd),
                                 a[:4], a[4])
    before = _lib.LAUNCHES.copy()
    _gate(pool(tp.fused_pool_ln), pool(tp.pool_ln_reference), x, w, ls, lb, gp)
    launched = _lib.LAUNCHES - before
    for name in ("pool_conv", "pool_conv_dx", "pool_conv_dk"):
        assert launched[name] >= 1, name


# the LN-linear uses and their plain twins, for the backward on the card
def _ln_linear_uses(gen, M, C):
    x, a = _randn(gen, M, C), _randn(gen, M, C)
    ln = (1 + _randn(gen, C, scale=0.1, dtype=torch.float32),
          _randn(gen, C, scale=0.1, dtype=torch.float32))
    w1 = _randn(gen, 4 * C, C, scale=C ** -0.5)
    w2 = _randn(gen, C, 4 * C, scale=(4 * C) ** -0.5)
    b1 = _randn(gen, 4 * C, scale=0.1, dtype=torch.float32)
    b2 = _randn(gen, C, scale=0.1, dtype=torch.float32)
    wq = _randn(gen, 3 * C, C, scale=C ** -0.5)
    bq = _randn(gen, 3 * C, scale=0.1, dtype=torch.float32)
    B = 4
    ma = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda")
    my = torch.tensor([0.0, 1.0, 1.0, 1.0], device="cuda")
    xb, ab = x.view(B, M // B, C), a.view(B, M // B, C)
    return {
        "ln_qkv": (lambda *t: tl.fused_ln_qkv(*t, C),
                   lambda *t: tl.ln_qkv_reference(*t, C),
                   (xb, *ln, wq, bq), 2),
        "ln_dense": (tl.fused_ln_dense, tl.ln_dense_reference,
                     (xb, *ln, w1, b1), 1),
        "ffn_residual": (tl.fused_ffn_residual, tl.ffn_residual_reference,
                         (xb, ab, *ln, w1, b1, w2, b2), 1),
        "ffn_residual_masked": (
            lambda *t: tl.fused_ffn_residual_masked(0.6, *t, ma, my),
            lambda *t: tl.ffn_residual_masked_reference(0.6, *t, ma, my),
            (xb, ab, *ln, w1, b1, w2, b2), 1),
        "ffn": (tl.fused_ffn, tl.ffn_reference, (xb, *ln, w1, b1, w2, b2), 1),
        "linear_proj": (tl.linear_proj, tl.linear_proj_reference,
                        (xb, w2[:, :C].contiguous(), b2), 1),
    }


@pytest.mark.parametrize("use", ["ln_qkv", "ln_dense", "ffn_residual",
                                 "ffn_residual_masked", "ffn", "linear_proj"])
@pytest.mark.parametrize("M,C", [(3136, 96), (1568, 768)])
def test_ln_linear_backward_on_the_tensor_cores(gen, use, M, C):
    """The backward of each K1 use: its gradients against the plain twin's
    f32 gradients under the gate, and every product of the path on bf16
    operands (a recording ``_mm``): no f32 GEMM, no twin recomputed."""
    kernel, plain, inputs, n_out = _ln_linear_uses(gen, M, C)[use]
    with torch.no_grad():
        outs = kernel(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [_randn(gen, *o.shape) for o in outs]
    seen = []
    mm = tl._mm

    def record(a, b):
        seen.append((a.dtype, b.dtype))
        return mm(a, b)

    def grads(fn):
        def run(*a):
            leaves = [t.detach().clone().requires_grad_() for t in a[:-n_out]]
            torch.autograd.backward(fn(*leaves), list(a[-n_out:]))
            return [t.grad for t in leaves]
        return run

    def kernel_grads(*a):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tl, "_mm", record)
            mp.setattr(tl, "ln_linear_reference", None)   # no twin recompute
            return grads(kernel)(*a)

    _gate(kernel_grads, grads(plain), *inputs, *cots)
    assert seen and set(seen) == {(BF, BF)}, seen


def _option_cfg(option, side=56):
    from svit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = side
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    if option in ("max", "avg"):
        cfg.MVIT.MODE = option
    elif option == "separate_qkv":
        cfg.MVIT.SEPARATE_QKV = True
    elif option == "no_q_pool":
        cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2]]
    elif option == "no_kv_pool":
        cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = None
        cfg.MVIT.POOL_KV_STRIDE = [[1, 1, 2, 2]]
    elif option == "dim_mul_in_att_false":
        cfg.MVIT.DIM_MUL_IN_ATT = False
    elif option == "norm_stem":
        cfg.MVIT.NORM_STEM = True
    return cfg


@pytest.mark.parametrize("option", ["max", "avg", "separate_qkv",
                                    "no_q_pool", "no_kv_pool",
                                    "dim_mul_in_att_false", "norm_stem"])
def test_model_options_through_the_kernels(gen, option):
    """Each model option at 56 px, 4 frames, 2 blocks of head_dim 96: the
    kernel model in bf16 against the plain model in f32 under the gate,
    through the kernels.  Without k|v pooling at 224 px the first block's
    key grid is 2 x 56 x 56 (kT + kH + kW = 114): K4 and K5 take it through
    their wide bias instance, forward and backward under the gate."""
    from svit_tpu_torch.models import build_model

    cfg = _option_cfg(option)
    model, arch = build_model(cfg, device="cuda")
    plain16, _ = build_model(cfg, use_kernels=False, device="cuda")
    plain32, _ = build_model(cfg, dtype=torch.float32, use_kernels=False,
                             device="cuda")
    for m in (plain16, plain32):
        m.load_state_dict(model.state_dict())
    x = torch.randn((2, 4, 56, 56, 3), device="cuda", generator=gen)
    before = _lib.LAUNCHES.copy()
    with torch.inference_mode():
        outs = [m(x) for m in (model, plain16, plain32)]
    torch.cuda.synchronize()
    launched = _lib.LAUNCHES - before
    assert launched["ln_linear"] and launched["pooled_attention"]
    if option not in ("max", "avg"):
        assert launched["pool_ln"]
    (lk, ek), (l16, e16), (l32, e32) = outs
    for a, b, c in ((lk, l16, l32),
                    (ek["pred_bboxes"], e16["pred_bboxes"],
                     e32["pred_bboxes"])):
        assert torch.isfinite(a).all()
        assert _rel(a.float(), c.float()) <= 3 * _rel(b.float(), c.float()) + 2e-3
    if option == "no_kv_pool":
        _wide_bias_model_gate(gen, _option_cfg(option, 224))


def _wide_bias_model_gate(gen, cfg):
    """One forward and backward of the kernel model in bf16, the plain one
    in bf16 and in f32 (same weights, same input and output cotangent):
    the logits and the global gradient vector under the gate, with K4 and
    K5 launched at R = 114."""
    from svit_tpu_torch.models import build_model

    models = [build_model(cfg, dtype=dt, use_kernels=k, device="cuda",
                          train=True)[0]
              for dt, k in ((BF, True), (BF, False), (torch.float32, False))]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    x = torch.randn((1, 4, 224, 224, 3), device="cuda", generator=gen)
    cot = torch.randn((1, cfg.MODEL.NUM_CLASSES), device="cuda",
                      generator=gen)
    # the first block: 6272 grid queries against 6272 + 17 keys (cls and
    # four object tokens a frame)
    assert ta.attention_plan(1, 6272, 6289, 96, 1, 114).rk == ta.RK_WIDE
    outs = []
    for i, m in enumerate(models):
        before = _lib.LAUNCHES.copy()
        logits, _ = m(x, train=False)
        (logits.float() * cot).sum().backward()
        torch.cuda.synchronize()
        launched = _lib.LAUNCHES - before
        if i == 0:
            assert launched["pooled_attention"] >= 4, launched
            assert launched["pooled_attention_bwd"] >= 2, launched
        grads = torch.cat([p.grad.float().flatten() for p in m.parameters()
                           if p.grad is not None])
        outs.append((logits.detach().float().flatten(), grads))
    (lk, gk), (l16, g16), (l32, g32) = outs
    for a, b, c in ((lk, l16, l32), (gk, g16, g32)):
        assert torch.isfinite(a).all()
        assert _rel(a, c) <= 3 * _rel(b, c) + 2e-3


@pytest.mark.parametrize("k_shape,heads,hd", [((2, 56, 56), 1, 96),
                                              ((8, 56, 56), 1, 96),
                                              ((2, 56, 56), 2, 64),
                                              ((2, 56, 56), 1, 128)])
def test_pooled_attention_wide_bias(gen, k_shape, heads, hd):
    """K4 and K5 at a key grid past 48 (R = 114 and 120, the first block
    without k|v pooling at 4 and 16 frames), 700 of its queries, with 9
    extras keys."""
    q, kv, b = _attention_inputs(gen, 1, 700, k_shape, 9, heads, hd, True)
    assert ta.attention_plan(1, 700, kv.shape[1], heads * hd, heads,
                             sum(k_shape)).rk == ta.RK_WIDE
    _gate(ta.pooled_attention, ta.pooled_attention_reference, q, kv, b,
          k_shape, hd ** -0.5, heads, True)
    do = _randn(gen, *q.shape)
    _gate(ta.pooled_attention_bwd, ta.pooled_attention_bwd_reference, q, kv,
          b, do, k_shape, hd ** -0.5, heads, True)


@pytest.mark.parametrize("k_shape,heads,hd", [((8, 64, 64), 1, 96),
                                              ((8, 64, 64), 2, 64),
                                              ((8, 64, 64), 1, 128),
                                              ((8, 80, 80), 1, 96)])
def test_pooled_attention_chunked_bias(gen, k_shape, heads, hd):
    """K4 and K5 at a key grid past 128 (R = 136, the first block without
    k|v pooling at 16 x 256; R = 168 at 16 x 320): the chunked instance,
    700 of the queries, with 9 extras keys."""
    q, kv, b = _attention_inputs(gen, 1, 700, k_shape, 9, heads, hd, True)
    assert ta.attention_plan(1, 700, kv.shape[1], heads * hd, heads,
                             sum(k_shape), backward=True).rk == ta.RK_CHUNKED
    _gate(ta.pooled_attention, ta.pooled_attention_reference, q, kv, b,
          k_shape, hd ** -0.5, heads, True)
    do = _randn(gen, *q.shape)
    args = (q, kv, b, do, k_shape, hd ** -0.5, heads, True)
    _gate(ta.pooled_attention_bwd, ta.pooled_attention_bwd_reference, *args)
    # dbias alone, and the second chunk's columns alone, under the gate
    db = ta.pooled_attention_bwd(*args)[2].float()
    d16 = ta.pooled_attention_bwd_reference(*args)[2].float()
    d32 = ta.pooled_attention_bwd_reference(*_f32(args))[2].float()
    for cols in (slice(None), slice(128, None)):
        a, p16, p32 = (t[..., cols].flatten() for t in (db, d16, d32))
        assert torch.isfinite(a).all()
        assert _rel(a, p32) <= 3 * _rel(p16, p32) + 2e-3, cols


def test_wrapper_rejects_f32_on_the_card(gen):
    x = _randn(gen, 64, 96, dtype=torch.float32)
    w = _randn(gen, 96, 96, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        tl.ln_linear(x, w)


# ---- head widths and channel counts past the shipped config's -----------
# (the JAX package's small schedules: EMBED_DIM 32, head_dim 32; NUM_HEADS
# 2: head_dim 48; EMBED_DIM 144 NUM_HEADS 2: head_dim 72, C 144 to 1152)

# (k_shape, extras, with bias): R 0 (the extras' queries), R 22 and R 120
# (a key grid past 48: the wide instance)
HEAD_WIDTH_KEYS = [((8, 7, 7), 65, False), ((8, 7, 7), 65, True),
                   ((8, 56, 56), 9, True)]


@pytest.mark.parametrize("keys", HEAD_WIDTH_KEYS)
@pytest.mark.parametrize("hd,heads", [(32, 1), (48, 2), (72, 2)])
def test_pooled_attention_head_widths(gen, hd, heads, keys):
    """K4 and K5 at head widths 32, 48 and 72: each in its instance (HD =
    32, 64, 96), the columns past hd zero-filled by TMA and masked in the
    stores; the neighbouring heads' columns untouched."""
    k_shape, extras, bias = keys
    q, kv, b = _attention_inputs(gen, 2, 700, k_shape, extras, heads, hd,
                                 bias)
    before = _lib.LAUNCHES.copy()
    _gate(ta.pooled_attention, ta.pooled_attention_reference, q, kv, b,
          k_shape, hd ** -0.5, heads, True)
    do = _randn(gen, *q.shape)
    _gate(ta.pooled_attention_bwd, ta.pooled_attention_bwd_reference, q, kv,
          b, do, k_shape, hd ** -0.5, heads, True)
    launched = _lib.LAUNCHES - before
    assert launched["pooled_attention"] >= 1
    assert launched["pooled_attention_bwd"] >= 1


# (C, head_dim): the q pools and the fused k|v pools of the new widths
POOL_WIDTHS = [(32, 32), (64, 32), (96, 48), (144, 72), (288, 72)]


@pytest.mark.parametrize("stride", [(1, 1, 1), (1, 2, 2), (1, 4, 4),
                                    (1, 8, 8)])
@pytest.mark.parametrize("C,hd", POOL_WIDTHS)
def test_pool_head_widths(gen, C, hd, stride):
    """K2 with the LN over one head of 32, 48 or 72 channels and in bare
    mode, K6 and K7 at C = 32 and 144 (and the k|v widths): the general
    instance where no tuned one takes the call, at the slab the plan
    picks."""
    shape = (2, 4, 17, 15, C)
    x, w, ls, lb, g = _wide_inputs(gen, shape, (3, 3, 3), stride)
    plan = tp.pool_plan(shape, (3, 3, 3), stride, "pool", head_dim=hd)
    assert plan.slab == (96 if plan.route == "tuned" else hd)
    before = _lib.LAUNCHES.copy()
    _gate(tp.fused_pool_ln, tp.pool_ln_reference, x, w, ls, lb, stride, hd)
    _gate(lambda x, w: tp.depthwise_conv(x, w, stride, hd),
          lambda x, w: tp.depthwise_conv_reference(x, w, stride), x, w)
    _gate(tp.depthwise_conv_dx, tp.depthwise_conv_dx_reference, g, w, stride,
          shape)
    _gate(tp.depthwise_conv_dk, tp.depthwise_conv_dk_reference, x, g,
          (3, 3, 3), stride)
    launched = _lib.LAUNCHES - before
    for name in ("pool_ln", "pool_conv", "pool_conv_dx", "pool_conv_dk"):
        assert launched[name] >= 1, name


def _prologue_uses(gen, M, C):
    """K1's uses with a prologue at width C (and ``fused_ffn``)."""
    uses = _ln_linear_uses(gen, M, C)
    return {k: uses[k] for k in ("ln_qkv", "ln_dense", "ffn_residual",
                                 "ffn_residual_masked", "ffn")}


@pytest.mark.parametrize("use", ["ln_qkv", "ln_dense", "ffn_residual",
                                 "ffn_residual_masked", "ffn"])
def test_ln_linear_prologue_pass(gen, use):
    """Each K1 use with an LN prologue at K = 1152 (MViTv2-L's last stage):
    the prologue pass, then the GEMM path, under the gate."""
    kernel, plain, inputs, _ = _prologue_uses(gen, 392, 1152)[use]
    before = _lib.LAUNCHES["ln_linear_prologue"]
    _gate(kernel, plain, *inputs)
    assert _lib.LAUNCHES["ln_linear_prologue"] == before + 1


@pytest.mark.parametrize("M,N", [(3137, 768), (3137, 2304), (1000, 3072),
                                 (333, 96)])
@pytest.mark.parametrize("mode", ["ln", "x_add", "masked"])
def test_ln_linear_prologue_pass_is_the_panel(gen, M, N, mode):
    """At K = 768, where the resident panel takes the prologue too, the
    pass and its GEMM agree with the panel bit for bit: the rows, the sum
    s and the output (each plan's order of the LN's partial sums)."""
    K = 768
    x, a = _randn(gen, M, K), _randn(gen, M, K)
    w = _randn(gen, N, K, scale=K ** -0.5)
    b = _randn(gen, N, scale=0.1, dtype=torch.float32)
    kw = dict(ln=_ln(gen, K), gelu=True)
    if mode != "ln":
        kw["x_add"] = a
    if mode == "masked":
        kw.update(mask_add=(torch.arange(M // 1, device="cuda") % 3 > 0
                            ).float(), keep=0.7)
    panel = tl.ln_linear(x, w, b, **kw)
    before = _lib.LAUNCHES["ln_linear_prologue"]
    passed = tl.ln_linear(x, w, b, force_pass=True, **kw)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["ln_linear_prologue"] == before + 1
    panel = panel if isinstance(panel, tuple) else (panel,)
    passed = passed if isinstance(passed, tuple) else (passed,)
    for p_, q_ in zip(panel, passed):
        assert torch.equal(p_.view(torch.int16), q_.view(torch.int16))
