"""The hand-written CUDA kernels against their plain versions, on the card.

These need an NVIDIA card and ``nvcc``; without a card they skip.  Run them
there with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``
(the suite's conftest imports JAX, which the card's machine need not have).  Shapes are
small cases of the main path's (head_dim 96, ragged tiles).

Gate (as ``chip_smoke.py``): relative L2 error of the kernel against the
plain version in f32 on the same bf16 inputs must stay within 3x the plain
bf16 version's own error + 2e-3.
"""

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
    return torch.cat([_flat(o) for o in out])


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


@pytest.mark.parametrize("M,K,N", [(1000, 96, 288), (333, 384, 96)])
def test_ln_linear_ln_qkv_split(gen, M, K, N):
    x = _randn(gen, M, K)
    w = _randn(gen, N, K, scale=K ** -0.5)
    b = _randn(gen, N, scale=0.1, dtype=torch.float32)
    ln = (1 + _randn(gen, K, scale=0.1, dtype=torch.float32),
          _randn(gen, K, scale=0.1, dtype=torch.float32))
    _gate(tl.ln_linear, tl.ln_linear_reference, x, w, b, ln=ln, split=N // 3)


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


def test_wrapper_rejects_f32_on_the_card(gen):
    x = _randn(gen, 64, 96, dtype=torch.float32)
    w = _randn(gen, 96, 96, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        tl.ln_linear(x, w)
