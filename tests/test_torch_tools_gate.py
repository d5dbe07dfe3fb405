"""The port's numerics gate (``svit_tpu_torch/tools/check_kernels_hw.py``)
against the JAX package's (``tools/check_kernels_hw.py``), on the CPU.

- The fault hook: ``pooled_attention`` with ``SVIT_PALLAS_FAULT=1`` against
  JAX's in interpret mode on the same seeded inputs (f32, 1e-5 of the
  output's scale, as ``tests/test_torch_ops.py``), and unset against set:
  a roll by one channel, exactly.
- ``_rel_err`` and ``_gate_one``: the same errors (1e-12 relative; both
  sum in f64) and verdicts as JAX's on the same numpy arrays.
- ``fixed_params``: bit for bit JAX ``_fixed_params``' tree carried
  across by the converter; the f32 forward's four gated outputs on them
  against JAX's (5e-5 of the scale, as the model tests).
- ``run_gate(small=True, check_bwd=False)``: ``ok`` in both packages, and
  not ``ok`` in both under the fault; the port's self-test trips.
- ``run_gate(check_fwd=False)``: the backward gates alone, equal to the
  whole gate's.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.ops import pallas_attention as pa
from svit_tpu_torch.ops import attention as ta
from svit_tpu_torch.tools import check_kernels_hw as gate
from svit_tpu_torch.tools import common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jgate():
    spec = importlib.util.spec_from_file_location(
        "jax_check_kernels_hw", os.path.join(REPO, "tools",
                                             "check_kernels_hw.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(port, ref, atol):
    ref = np.asarray(ref, np.float32)
    got = port.detach().float().numpy()
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=atol * scale, rtol=atol)


@pytest.mark.parametrize("heads", [1, 2])
def test_fault_hook_matches_jax(monkeypatch, heads):
    rs = np.random.RandomState(6)
    hd, B, C = 16, 2, 16 * heads
    q_shape, k_shape = (2, 4, 4), (2, 2, 2)
    q_grid = rs.randn(B, *q_shape, C).astype(np.float32)
    kv = rs.randn(B, 8 + 5, 2 * C).astype(np.float32)
    rel = dict(rel_pos_h=(rs.randn(7, hd) * 0.3).astype(np.float32),
               rel_pos_w=(rs.randn(7, hd) * 0.3).astype(np.float32),
               rel_pos_t=(rs.randn(3, hd) * 0.3).astype(np.float32))
    bias_j, scatter = pa.build_bias_inputs_grid(
        jnp.asarray(q_grid), heads, q_shape, k_shape, kv.shape[1],
        **{k: jnp.asarray(v) for k, v in rel.items()})
    bias_t = ta.build_bias_inputs_grid(
        _t(q_grid), heads, q_shape, k_shape,
        **{k: _t(v) for k, v in rel.items()})
    q = q_grid.reshape(B, -1, C)
    clean = ta.pooled_attention(_t(q), _t(kv), bias_t, k_shape, hd ** -0.5,
                                heads)
    monkeypatch.setenv("SVIT_PALLAS_FAULT", "1")
    assert ta.fault_injected()
    ref = pa.pooled_attention(jnp.asarray(q), jnp.asarray(kv), bias_j,
                              scatter, heads=heads, scale=hd ** -0.5)
    out = ta.pooled_attention(_t(q), _t(kv), bias_t, k_shape, hd ** -0.5,
                              heads)
    _close(out, ref, 1e-5)
    assert torch.equal(out, torch.roll(clean, 1, dims=-1))
    monkeypatch.setenv("SVIT_PALLAS_FAULT", "0")
    assert torch.equal(ta.pooled_attention(_t(q), _t(kv), bias_t, k_shape,
                                           hd ** -0.5, heads), clean)


def test_gate_arithmetic_matches_jax(jgate):
    rs = np.random.RandomState(0)
    f32 = rs.randn(3, 50).astype(np.float32)
    plain = f32 + 1e-3 * rs.randn(3, 50).astype(np.float32)
    cases = {"equal": f32.copy(), "close": f32 + 2e-3 * rs.randn(3, 50),
             "fault": np.roll(f32, 1, axis=-1), "zero": np.zeros_like(f32)}
    mine, theirs = {}, {}
    for name, prod in cases.items():
        assert gate._rel_err(prod, f32) == pytest.approx(
            jgate._rel_err(prod, f32), rel=1e-12, abs=1e-15)
        ok = gate._gate_one(name, prod, plain, f32, mine)
        want = jgate._gate_one(name, prod, plain, f32, theirs)
        assert bool(ok) == bool(want), name
        assert mine[name]["ok"] == theirs[name]["ok"], name
        for a, b in (("err_kernels_vs_f32", "err_pallas_vs_f32"),
                     ("err_plain_bf16_vs_f32", "err_xla_bf16_vs_f32")):
            assert round(mine[name][a], 6) == theirs[name][b], (name, a)
    assert not mine["fault"]["ok"]
    # torch tensors (the card's path) give the numpy errors
    assert gate._rel_err(torch.from_numpy(cases["close"]),
                         torch.from_numpy(f32)) == pytest.approx(
        jgate._rel_err(cases["close"], f32), rel=1e-12)


def test_fixed_params_match_jax(jgate):
    """The port's fixed parameters are JAX ``_fixed_params``' draws, bit
    for bit, and the f32 forward's gated outputs on them agree."""
    from svit_tpu.config import assert_and_infer_cfg as jax_infer
    from svit_tpu.config import get_cfg as jax_get_cfg
    from svit_tpu.models import build_model as jax_build
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.utils import converter

    cfg = gate.gate_cfg(small=True)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(gate.CFG)
    for key, value in gate.SMALL.items():
        node, leaf = jcfg, key.split(".")
        for k in leaf[:-1]:
            node = node[k]
        node[leaf[-1]] = value
    jax_infer(jcfg)
    jm, _ = jax_build(jcfg, dtype=jnp.float32, use_pallas=False)
    rs = np.random.RandomState(0)
    x = rs.randn(gate.BATCH, 4, 56, 56, 3).astype(np.float32)
    jparams = jgate._fixed_params(jm, jnp.asarray(x))
    want = converter.params_from_jax(jax.device_get(jparams))

    model, _ = build_model(cfg, dtype=torch.float32, use_kernels=False,
                           device="cpu")
    common.fixed_params(model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    ref = jax.device_get(jgate._forward_outputs(jm, jparams, jnp.asarray(x)))
    outs = gate.forward_outputs(model, torch.from_numpy(x))
    assert set(outs) == set(ref)
    for k in ref:
        _close(outs[k], ref[k], 5e-5)


def test_run_gate_small_ok_and_trips_in_both_packages(jgate, monkeypatch):
    mine = gate.run_gate(check_bwd=False, small=True, device="cpu")
    theirs = jgate.run_gate(check_bwd=False, small=True)
    assert mine["ok"] and theirs["ok"]
    keys = {k for k in theirs if k.startswith("fwd.")}
    assert keys == {k for k in mine if k.startswith("fwd.")} and len(keys) == 4
    monkeypatch.setenv("SVIT_PALLAS_FAULT", "1")
    theirs = jgate.run_gate(check_bwd=False, small=True)
    monkeypatch.delenv("SVIT_PALLAS_FAULT")
    mine = gate.selftest(small=True, device="cpu")
    assert not theirs["ok"] and not mine["ok"] and mine["tripped"]
    # the fault shows where JAX's shows it: in the grid, and in the logits
    for k in ("fwd.grid_final", "fwd.raw_logits"):
        assert not theirs[k]["ok"] and not mine[k]["ok"], k
    assert os.environ.get("SVIT_PALLAS_FAULT") is None


def test_run_gate_backward_parts_alone():
    """``check_fwd=False`` (``chip_smoke.py`` phase 15, where phase 3 has
    gated the forward outputs) runs the backward and drop-path gates
    alone, with the same errors as the whole gate (bit for bit: the same
    draws on the CPU)."""
    part = gate.run_gate(check_bwd=True, check_fwd=False, small=True,
                         device="cpu")
    whole = gate.run_gate(check_bwd=True, small=True, device="cpu")
    assert part["ok"] and whole["ok"]
    assert not [k for k in part if k.startswith("fwd.")]
    for k in ("bwd.grads_global", "train.grads_global", "bwd.worst_leaf",
              "train.masks"):
        assert part[k] == whole[k], k
