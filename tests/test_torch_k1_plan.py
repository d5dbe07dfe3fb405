"""K1's launch plan (``ops/ln_linear.py:ln_linear_plan``) for every K1 call
of the SViT-B/16 forwards: the serving forward at batch 8 and batch 1, the
image forward (batch 8, one frame) and the train step's 128-frame
consistency forward.  Pure Python: the shapes come from the port's own
block schedule of ``configs/ssv2.yaml``."""

import dataclasses
import math
import os

import pytest

from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models.svit import SViTArch
from svit_tpu_torch.ops import ln_linear as tl
from svit_tpu_torch.ops.pooling import out_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132          # the H100 SXM's SMs


def _arch():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    return SViTArch.from_cfg(cfg)


def k1_calls(arch, B, frames):
    """(use, M, N, K, prologue, split) of every K1 launch of one forward,
    in the order of ``models/attention.py``."""
    t_lat = arch.patch_dims[0] if frames > 1 else 1
    size = (t_lat, *arch.patch_dims[1:])
    extras = int(arch.cls_embed_on) + frames * arch.num_obj_per_frame
    calls = []
    for s in arch.blocks:
        M = B * math.prod(size)
        C, hidden = s.dim_out, int(s.dim_out * arch.mlp_ratio)
        calls.append(("qkv", M, 3 * C, s.dim, True, C))
        if s.dim != C:
            calls.append(("dense", M, C, s.dim, True, None))
        size = tuple(out_size(d, k, st) for d, k, st in
                     zip(size, s.kernel_q, s.stride_q))
        Mq = B * math.prod(size)
        calls += [("projection", Mq, C, C, False, None),
                  ("projection (extras)", B * extras, C, C, False, None),
                  ("fc1", Mq, hidden, C, True, None),
                  ("fc2", Mq, C, hidden, False, None)]
    return calls


FORWARDS = {"video batch 8": (8, 16), "video batch 1": (1, 16),
            "image batch 8": (8, 1), "consistency 128 frames": (128, 1)}


def test_the_call_list_is_the_forward_s():
    """83 K1 launches per forward, as ``chip_smoke.py`` counts them; the
    first block's fc1 is the 200,704-row [M, 96] -> 384."""
    calls = k1_calls(_arch(), 8, 16)
    assert len(calls) == 83
    assert ("fc1", 200704, 384, 96, True, None) in calls
    assert ("fc2", 3136, 768, 3072, False, None) in calls


@pytest.mark.parametrize("forward", list(FORWARDS))
def test_plan_fits_covers_and_fills(forward):
    B, frames = FORWARDS[forward]
    for use, M, N, K, prologue, split in k1_calls(_arch(), B, frames):
        p = tl.ln_linear_plan(M, N, K, prologue=prologue, split=split,
                              sms=SMS)
        what = f"{forward} {use} M={M} N={N} K={K}: {p}"
        # shared memory: one block within 227 KB, and the blocks per SM the
        # plan counts on fit the SM's 228 KB
        assert p.smem == tl.ln_linear_smem(p.bm, p.panel, -(-K // tl.BK),
                                           p.stages, p.ncw), what
        assert p.smem <= tl.SMEM_BLOCK, what
        assert p.blocks_per_sm * (p.smem + tl.SMEM_RESERVED) <= tl.SMEM_SM, what
        assert 2 <= p.stages <= tl.STAGES_MAX, what
        # the tiles cover M and N, and no split is left without a tile
        assert p.panel == prologue, what
        assert (p.ncw, p.bm) in ((1, 64), (2, 64), (2, 128)), what
        assert p.blocks_per_sm <= tl.BLOCKS_BY_REGS[p.ncw], what
        if (p.ncw, p.bm) == (2, 64):   # ping: half of the ring each
            assert p.stages % 2 == 0 and p.stages >= 4, what
        assert (p.m_tiles - 1) * p.bm < M <= p.m_tiles * p.bm, what
        assert (p.n_tiles - 1) * tl.BN < N <= p.n_tiles * tl.BN, what
        assert (p.splits - 1) * p.tiles_per_split < p.n_tiles \
            <= p.splits * p.tiles_per_split, what
        if prologue:
            assert p.bm * -(-K // tl.BK) * tl.BK <= (384 if p.bm == 128
                                                      else tl.PANEL_K_MAX) * p.bm
        # at least one block per SM, or the N sweep split among blocks
        assert p.blocks >= SMS or p.splits > 1 or p.n_tiles == 1, what
        # the q | kv split: a multiple of 8 inside N, so every 16-byte
        # chunk of a row goes whole to one output
        if split is not None:
            assert split % 8 == 0 and 0 < split < N and (N - split) % 8 == 0


def test_plan_refuses_what_the_kernel_cannot_take():
    # a prologue past the LN panel is a pass of its own, then the GEMM path
    p = tl.ln_linear_plan(64, 128, 1536, prologue=True)
    assert not p.panel and p.rows_pass is not None
    with pytest.raises(ValueError, match="split"):
        tl.ln_linear_plan(64, 288, 96, prologue=True, split=100)
    with pytest.raises(ValueError, match="multiples of 8"):
        tl.ln_linear_plan(64, 100, 96, prologue=False)
    # without a prologue any K streams
    assert not tl.ln_linear_plan(64, 128, 3072, prologue=False).panel


# ---- the prologue pass past the panel (MViTv2-L's widths) ---------------

CU = os.path.join(REPO, "svit_tpu_torch", "csrc", "ln_linear.cu")


def _cu_rows_smem():
    """``rows_smem`` of the ``.cu`` evaluated here, with its
    ``rows_stride`` (a row of K / 8 16-byte units, padded to an odd
    count)."""
    import re

    src = open(CU).read()
    assert "16 * (units % 2 ? units : units + 1)" in src
    smem = re.search(r"int rows_smem\(int K, int R, int parts\) \{\s*"
                     r"return (.*?);\s*\}", src, re.S).group(1)

    def rows_stride(K):
        units = K // 8
        return 16 * (units if units % 2 else units + 1)

    return lambda K, R, parts: eval(" ".join(smem.split()), {
        "rows_stride": rows_stride, "K": K, "R": R, "parts": parts})


def _mvitv2_l_arch():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.MVIT.EMBED_DIM, cfg.MVIT.NUM_HEADS = 144, 2
    return SViTArch.from_cfg(cfg)


@pytest.mark.parametrize("forward", list(FORWARDS))
def test_past_the_panel_the_prologue_is_a_pass(forward):
    """At MViTv2-L's widths (C 144 to 1152) every K1 call plans: the LN
    prologues at K = 1152 (the last stage's qkv and fc1; its dense is at
    576) take the pass, then the streaming GEMM; the pass's shared memory
    is the ``.cu``'s and fits a block."""
    B, frames = FORWARDS[forward]
    cu = _cu_rows_smem()
    seen = set()
    for use, M, N, K, prologue, split in k1_calls(_mvitv2_l_arch(), B,
                                                  frames):
        p = tl.ln_linear_plan(M, N, K, prologue=prologue, split=split,
                              sms=SMS)
        what = f"{forward} {use} M={M} N={N} K={K}: {p}"
        past = prologue and K > tl.PANEL_K_MAX
        assert (p.rows_pass is not None) == past, what
        assert p.panel == (prologue and not past), what
        if past:
            seen.add(use)
            rp = p.rows_pass
            assert rp.parts == tl.PASS_PARTS and rp.rows * rp.parts <= 128
            assert rp.smem == cu(K, rp.rows, rp.parts) <= tl.SMEM_BLOCK, what
            gemm = tl.ln_linear_plan(M, N, K, prologue=False, split=split,
                                     sms=SMS)
            assert p == dataclasses.replace(gemm, rows_pass=rp), what
    assert seen == {"qkv", "fc1"}


def _panel_ln(s, g, b, parts, eps=tl.EPS):
    """The LN of ``csrc/ln_linear.cu`` in f32, sum by sum: part h of a row
    sums its 8-column groups h * per .. in order, the parts meet in part
    order; then the centred squares the same way; rounded to bf16."""
    import numpy as np

    rows, K = s.shape
    G, per = K // 8, -(-(K // 8) // parts)
    f = np.float32
    out = np.empty_like(s)
    for r in range(rows):
        sums = []
        for h in range(parts):
            acc = f(0)
            for v in s[r, 8 * h * per:8 * min(G, (h + 1) * per)]:
                acc = f(acc + v)
            sums.append(acc)
        tot = f(0)
        for v in sums:
            tot = f(tot + v)
        mean = f(tot / f(K))
        sqs = []
        for h in range(parts):
            acc = f(0)
            for v in s[r, 8 * h * per:8 * min(G, (h + 1) * per)]:
                d = f(v - mean)
                acc = f(acc + f(d * d))
            sqs.append(acc)
        tot = f(0)
        for v in sqs:
            tot = f(tot + v)
        rstd = f(1 / np.sqrt(f(tot / f(K)) + f(eps)))
        out[r] = (s[r] - mean) * rstd * g + b
    return out


@pytest.mark.parametrize("M,N,K", [(3137, 2304, 768), (1000, 3072, 768),
                                   (333, 96, 768), (200, 288, 96)])
def test_a_forced_pass_sums_as_the_panel(M, N, K):
    """Where the panel takes the K, a forced pass (the card's bit-equality
    check) takes the panel's order: its parts are the panel plan's consumer
    threads over its rows, and the emulated LN of both orders is the same
    to the bit (and the plain LN's within f32 rounding)."""
    import numpy as np
    import torch

    panel = tl.ln_linear_plan(M, N, K, prologue=True, sms=SMS)
    forced = tl.ln_linear_plan(M, N, K, prologue=True, sms=SMS,
                               force_pass=True)
    assert panel.panel and not forced.panel
    assert forced.rows_pass.parts == panel.ncw * 128 // panel.bm
    rs = np.random.RandomState(K)
    s = torch.from_numpy(rs.randn(3, K).astype(np.float32)).bfloat16(
        ).float().numpy()
    g = (1 + 0.1 * rs.randn(K)).astype(np.float32)
    b = (0.1 * rs.randn(K)).astype(np.float32)
    one = _panel_ln(s, g, b, panel.ncw * 128 // panel.bm)
    two = _panel_ln(s, g, b, forced.rows_pass.parts)
    assert np.array_equal(one, two)
    want = tl.layer_norm(torch.from_numpy(s), torch.from_numpy(g),
                         torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(one, want, rtol=1e-5, atol=1e-5)
