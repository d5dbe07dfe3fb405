"""``fused_ffn`` (LN + MLP, no residual) against JAX ``pf.fused_ffn``.

The JAX side runs its Pallas kernel in interpret mode on the CPU; the port's
wrapper takes its plain version (two K1 calls' twins) because the tensors lie
on the CPU.  Same numpy inputs, f32 on both sides.  Tolerances are the JAX
package's own for this kernel (``tests/test_pallas_attention.py``): 2e-4 on
the output, 1e-3 on the gradients.  The JAX kernel's GELU uses the A&S erf
(|err| <= 1.5e-7); the port's is exact, far inside both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.ops import pallas_ffn as pf
from svit_tpu_torch.ops import ln_linear as tl


def _inputs(seed, B, N, C, H):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(B, N, C).astype(np.float32) * 0.3,
        ls=1 + rng.randn(C).astype(np.float32) * 0.1,
        lb=rng.randn(C).astype(np.float32) * 0.1,
        w1=rng.randn(C, H).astype(np.float32) * 0.05,   # flax [in, out]
        b1=rng.randn(H).astype(np.float32) * 0.05,
        w2=rng.randn(H, C).astype(np.float32) * 0.05,
        b2=rng.randn(C).astype(np.float32) * 0.05)


def _port_args(d, grad=False):
    t = {k: torch.from_numpy(v.T.copy() if k in ("w1", "w2") else v)
         for k, v in d.items()}                        # port: [out, in]
    for k in ("x", "ls", "w1"):
        t[k].requires_grad_(grad)
    return t


@pytest.mark.parametrize("B,N,C,H", [(2, 300, 64, 256), (1, 77, 96, 384)])
def test_fused_ffn_forward_matches_jax(B, N, C, H):
    d = _inputs(0, B, N, C, H)
    ref = pf.fused_ffn(*(jnp.asarray(d[k]) for k in
                         ("x", "ls", "lb", "w1", "b1", "w2", "b2")))
    t = _port_args(d)
    out = tl.fused_ffn(t["x"], t["ls"], t["lb"], t["w1"], t["b1"], t["w2"],
                       t["b2"])
    assert out.shape == (B, N, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_fused_ffn_gradients_match_jax():
    d = _inputs(1, 2, 300, 64, 256)
    lb, b1, w2, b2 = (jnp.asarray(d[k]) for k in ("lb", "b1", "w2", "b2"))

    def loss(x, ls, w1):
        return (pf.fused_ffn(x, ls, lb, w1, b1, w2, b2) ** 2).sum()

    gx, gls, gw1 = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(d["x"]), jnp.asarray(d["ls"]), jnp.asarray(d["w1"]))
    t = _port_args(d, grad=True)
    out = tl.fused_ffn(t["x"], t["ls"], t["lb"], t["w1"], t["b1"], t["w2"],
                       t["b2"])
    (out ** 2).sum().backward()
    for got, want in ((t["x"].grad, gx), (t["ls"].grad, gls),
                      (t["w1"].grad.T, gw1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3)


def test_fused_ffn_is_two_k1_calls_of_its_twin():
    """The port's ``fused_ffn`` and ``ffn_reference`` (the extras' plain
    FFN) are the same function: bit for bit in bf16 on the CPU."""
    d = _inputs(2, 2, 50, 96, 384)
    t = {k: v.to(torch.bfloat16) if k in ("x", "w1", "w2") else v.detach()
         for k, v in _port_args(d).items()}
    args = [t[k] for k in ("x", "ls", "lb", "w1", "b1", "w2", "b2")]
    torch.testing.assert_close(tl.fused_ffn(*args), tl.ffn_reference(*args),
                               atol=0, rtol=0)
