"""The rel-pos bias builder in bf16 against the JAX package's.

``ops/attention.py:build_bias_inputs_grid`` takes each term as a product of
the bf16 queries and the bf16 table with an f32 sum, rounded to bf16 once,
as ``svit_tpu/ops/pallas_attention.py:build_bias_inputs_grid`` does with
``preferred_element_type=f32``; its gradient (``_BiasTermFn``) takes the
same operand types, as ``jax.vjp`` transposes those dots.  The two sides
sum in other orders, so the tolerance is one bf16 ulp of each value for
the bias and the table gradients (the f32 rel-pos parameters' gradients
are f32 sums of bf16 values), and two for the query gradient, a bf16 sum
of three rounded terms taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.ops import pallas_attention as pa
from svit_tpu_torch.ops import attention as ta

BF = torch.bfloat16


def _ulps(got, want, n):
    """|got - want| within ``n`` bf16 ulps of the larger magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    excess = np.abs(got - want) - n * ulp
    assert float(excess.max()) <= 0, (float(excess.max()),
                                      np.unravel_index(excess.argmax(),
                                                       excess.shape))


def _case(seed, heads, hd, q_shape, k_shape, temporal=True):
    rs = np.random.RandomState(seed)
    B, C = 2, heads * hd
    rel_n = lambda q, k: 2 * max(q, k) - 1  # noqa: E731
    q = rs.randn(B, *q_shape, C).astype(np.float32)
    rel = {
        "rel_pos_h": rs.randn(rel_n(q_shape[1], k_shape[1]), hd) * 0.3,
        "rel_pos_w": rs.randn(rel_n(q_shape[2], k_shape[2]), hd) * 0.3,
        "rel_pos_t": (rs.randn(rel_n(q_shape[0], k_shape[0]), hd) * 0.3
                      if temporal else None),
    }
    rel = {k: None if v is None else v.astype(np.float32)
           for k, v in rel.items()}
    cot = rs.randn(B, heads, int(np.prod(q_shape)), sum(k_shape))
    return q, rel, cot.astype(np.float32)


CASES = [
    # (heads, hd, q_shape, k_shape, temporal)
    (1, 16, (2, 4, 4), (2, 2, 2), True),
    (2, 32, (2, 8, 8), (2, 4, 4), True),
    (2, 16, (1, 7, 7), (1, 7, 7), True),
    (1, 32, (2, 6, 6), (2, 6, 6), False),
]


@pytest.mark.parametrize("heads,hd,q_shape,k_shape,temporal", CASES)
def test_bias_builder_matches_jax_in_bf16(heads, hd, q_shape, k_shape,
                                          temporal):
    q, rel, cot = _case(heads * 7 + hd, heads, hd, q_shape, k_shape,
                        temporal)
    names = sorted(k for k, v in rel.items() if v is not None)
    n_k = int(np.prod(k_shape)) + 3

    def jax_fn(qg, *tables):
        kw = dict(zip(names, tables), **{k: None for k in rel
                                         if rel[k] is None})
        bias, _ = pa.build_bias_inputs_grid(qg, heads, q_shape, k_shape, n_k,
                                            **kw)
        return bias[..., :-1]            # the port drops the mask channel

    qj = jnp.asarray(q).astype(jnp.bfloat16)
    tj = [jnp.asarray(rel[k]) for k in names]
    want, vjp = jax.vjp(jax_fn, qj, *tj)
    want_grads = vjp(jnp.asarray(cot).astype(jnp.bfloat16))

    qt = torch.tensor(q).to(BF).requires_grad_()
    tt = {k: torch.tensor(rel[k]).requires_grad_() for k in names}
    got = ta.build_bias_inputs_grid(
        qt, heads, q_shape, k_shape,
        **{k: tt.get(k) for k in ("rel_pos_h", "rel_pos_w", "rel_pos_t")})
    assert got.dtype == BF and got.shape == tuple(want.shape)
    _ulps(got.detach().float().numpy(),
          np.asarray(want.astype(jnp.float32)), 1)
    got.backward(torch.tensor(cot).to(BF))
    assert qt.grad.dtype == BF
    _ulps(qt.grad.float().numpy(),
          np.asarray(want_grads[0].astype(jnp.float32)), 2)
    for name, g in zip(names, want_grads[1:]):
        assert tt[name].grad.dtype == torch.float32
        _ulps(tt[name].grad.numpy(), np.asarray(g), 1)


def test_bias_builder_takes_no_f32_products():
    """Every product of the builder and of its gradient takes bf16
    operands: no upcast of the queries or the tables."""
    q, rel, cot = _case(3, 2, 16, (2, 4, 4), (2, 2, 2))
    seen = []
    real = ta._bmm

    def record(a, b):
        seen.append((a.dtype, b.dtype))
        return real(a, b)

    qt = torch.tensor(q).to(BF).requires_grad_()
    tables = {k: torch.tensor(v).requires_grad_() for k, v in rel.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ta, "_bmm", record)
        out = ta.build_bias_inputs_grid(qt, 2, (2, 4, 4), (2, 2, 2),
                                        **tables)
        out.backward(torch.tensor(cot).to(BF))
    assert len(seen) == 3 * 3 and set(seen) == {(BF, BF)}, seen
