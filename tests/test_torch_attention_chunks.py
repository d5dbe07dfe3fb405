"""K4 and K5 at key grids past 128 (pure Python, no card): a block without
k|v pooling at 16 x 256 (8 + 64 + 64 = 136) or 16 x 320 (8 + 80 + 80 =
168) takes the chunked instance (``RK_CHUNKED``: R padded to 256, K5's
dbias in two 128-column chunks).

- ``attention_plan`` takes these calls at batch 1 and 8, forward and
  backward, within the shared memory of a block and of an SM, and its
  sums equal the ``.cu``'s own (``fwd_smem``, ``bwd_q_smem``,
  ``bwd_kv_smem``, read from ``csrc/attention.cu`` and evaluated here).
- The kernels' arithmetic at R = 136 and 168 in f32: the logits' bias as
  one product with the 256-column one-hot map against the gather; dbias
  as K5's query side takes it, chunk by chunk (each 128 columns of the
  one-hot map, dS split into two bf16 parts), against the scatter.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models.svit import SViTArch
from svit_tpu_torch.ops import attention as ta
from tests.test_torch_attention_plan import SMS, attention_calls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(REPO, "svit_tpu_torch", "csrc", "attention.cu")


def _cu_smem():
    """``fwd_smem``, ``bwd_q_smem`` and ``bwd_kv_smem`` of the ``.cu`` as
    Python functions of (hd, rk, stages)."""
    src = open(CU).read()
    bk = int(re.search(r"constexpr int BK = (\d+);", src).group(1))
    fns = {}
    for name in ("fwd_smem", "bwd_q_smem", "bwd_kv_smem"):
        body = re.search(
            name + r"\(int hd, int rk, int stages\) \{\s*return (.*?);\s*\}",
            src, re.S).group(1)
        expr = " ".join(body.split()).replace("BK", str(bk))
        fns[name[:-5]] = eval("lambda hd, rk, stages: " + expr)
    return fns


def _no_kv_pool_arch(size):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = size
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = None
    cfg.MVIT.POOL_KV_STRIDE = [[1, 1, 2, 2]]
    return SViTArch.from_cfg(cfg)


def test_the_cu_sums_are_read():
    cu = _cu_smem()
    for kind in ("fwd", "bwd_q", "bwd_kv"):
        for hd, rk, stages in ((96, 3, 4), (64, 8, 2), (128, 16, 1)):
            assert cu[kind](hd, rk, stages) == ta.attention_smem(
                kind, hd, rk, stages), (kind, hd, rk, stages)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("size,R", [(256, 136), (320, 168)])
def test_plan_takes_a_key_grid_past_128(size, R, backward):
    """The first block's key grid is 8 x (size / 4)^2: R = 136 at 256 px
    and 168 at 320.  Every call of the forward at batch 1 and 8 plans
    without raising; the grids past 128 take ``RK_CHUNKED``; the shared
    memory is the ``.cu``'s and fits."""
    cu = _cu_smem()
    arch = _no_kv_pool_arch(size)
    kind = "bwd_q" if backward else "fwd"
    for B in (1, 8):
        calls = attention_calls(arch, B, 16)
        assert max(c[6] for c in calls) == R
        for use, B_, Nq, Nk, C, heads, R_ in calls:
            p = ta.attention_plan(B_, Nq, Nk, C, heads, R_,
                                  backward=backward, sms=SMS)
            what = f"B={B} {use} Nq={Nq} Nk={Nk} C={C} R={R_}: {p}"
            hd = C // heads
            want_rk = (ta.RK_CHUNKED if R_ > 128 else ta.RK_WIDE if R_ > 48
                       else p.rk)
            assert p.rk == want_rk and 16 * p.rk >= R_, what
            assert p.smem == cu[kind](hd, p.rk, p.stages), what
            assert p.smem <= ta.SMEM_BLOCK, what
            assert p.blocks_per_sm * (p.smem + ta.SMEM_RESERVED) \
                <= ta.SMEM_SM, what
            if backward:
                assert p.kv_smem == cu["bwd_kv"](hd, p.rk, p.kv_stages), what
                assert p.kv_smem + ta.SMEM_RESERVED <= ta.SMEM_SM, what
                loads = (1 + ta.chunks(p.rk)) * -(-Nk // ta.BQ)
                assert 1 <= p.stages <= min(ta.STAGES_MAX, loads), what


def test_chunks():
    assert [ta.chunks(rk) for rk in (0, 1, 3, ta.RK_WIDE, ta.RK_CHUNKED)] \
        == [1, 1, 1, 1, 2]
    with pytest.raises(ValueError, match="two 128-column chunks"):
        ta.attention_plan(1, 64, 64, 96, 1, 16 * ta.RK_CHUNKED + 1)


@pytest.mark.parametrize("k_shape", [(8, 64, 64), (8, 80, 80)])
def test_chunked_bias_product_and_gradient(k_shape):
    """R = 136 and 168 with the chunked instance's padding: the logits'
    bias product against the gather (1e-6 relative), and dbias taken 128
    columns at a time (each chunk its own hi + lo pair of bf16 products
    against its columns of the one-hot map) within 1e-4 of the f32
    scatter, its columns past R zero."""
    R = sum(k_shape)
    n_k = math.prod(k_shape) + 65
    rk = ta.attention_plan(1, 40, n_k, 96, 1, R, backward=True).rk
    assert rk == ta.RK_CHUNKED
    rs = np.random.RandomState(R)
    bias = torch.tensor(rs.randn(1, 2, 40, R), dtype=torch.float32).to(
        torch.bfloat16)
    mt = ta.onehot_mt(k_shape, n_k, 16 * rk)
    padded = torch.nn.functional.pad(bias.float(), (0, 16 * rk - R))
    torch.testing.assert_close(padded @ mt.T,
                               ta._gather_bias(bias, k_shape, n_k),
                               rtol=1e-6, atol=1e-6)

    ds = torch.tensor(rs.randn(1, 2, 40, n_k) * 1e-2, dtype=torch.float32)
    hi = ds.to(torch.bfloat16).float()
    lo = (ds - hi).to(torch.bfloat16).float()
    width = 16 * ta.RK_WIDE
    chunks = [hi @ mt[:, c * width:(c + 1) * width]
              + lo @ mt[:, c * width:(c + 1) * width]
              for c in range(ta.chunks(rk))]
    dbias = torch.cat(chunks, dim=-1)
    assert not dbias[..., R:].any()
    want = ta._bias_grad(ds, k_shape)
    assert float((dbias[..., :R] - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
