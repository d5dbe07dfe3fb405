"""K4 and K5's launch plan and the rel-pos bias as a product (pure Python,
no card): ``ops/attention.py:attention_plan`` for every pooled-attention
call of the SViT-B/16 forwards (video batch 8 and 1, image batch 8, the
train step's 128-frame consistency forward) and of the step's backward; the
one-hot map ``onehot_mt`` against the JAX package's ``_scatter_matrix``; and
the kernels' arithmetic for the bias (logits by product) and its gradient
(dS split into two bf16 parts against the exact one-hot) against the plain
twin's gather and scatter, in f32."""

import math
import os

import numpy as np
import pytest
import torch

from svit_tpu.ops.pallas_attention import _scatter_matrix
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models.svit import SViTArch
from svit_tpu_torch.ops import attention as ta
from svit_tpu_torch.ops.pooling import out_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132          # the H100 SXM's SMs


def _arch():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    return SViTArch.from_cfg(cfg)


def attention_calls(arch, B, frames):
    """(use, B, Nq, Nk, C, heads, R) of every K4 launch of one forward (and
    so of every K5 launch of its backward), in the order of
    ``models/attention.py``: the grid queries with the rel-pos bias, then
    the extras (cls and object tokens) with none."""
    t_lat = arch.patch_dims[0] if frames > 1 else 1
    size = (t_lat, *arch.patch_dims[1:])
    extras = int(arch.cls_embed_on) + frames * arch.num_obj_per_frame
    calls = []
    def pooled(kernel, stride):   # a block without a pool keeps the grid
        if not kernel:
            return size
        return tuple(out_size(d, k, st)
                     for d, k, st in zip(size, kernel, stride))

    for s in arch.blocks:
        q_shape = pooled(s.kernel_q, s.stride_q)
        k_shape = pooled(s.kernel_kv, s.stride_kv)
        Nk = math.prod(k_shape) + extras
        C = s.dim_out
        calls += [("grid", B, math.prod(q_shape), Nk, C, s.num_heads,
                   sum(k_shape)),
                  ("extras", B, extras, Nk, C, s.num_heads, 0)]
        size = q_shape
    return calls


FORWARDS = {"video batch 8": (8, 16), "video batch 1": (1, 16),
            "image batch 8": (8, 1), "consistency 128 frames": (128, 1)}


def test_the_call_list_is_the_forward_s():
    """32 K4 launches per forward, at the main path's shapes."""
    video = attention_calls(_arch(), 8, 16)
    assert len(video) == 32
    assert {c[3] for c in video} == {457, 1633}
    assert {c[2] for c in video} == {25088, 6272, 1568, 392, 65}
    assert {c[6] for c in video} == {0, 22, 36}
    image = attention_calls(_arch(), 8, 1)
    assert {c[3] for c in image} == {54, 201}
    assert {c[2] for c in image} == {3136, 784, 196, 49, 5}
    assert {c[6] for c in image} == {0, 15, 29}


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("forward", list(FORWARDS))
def test_plan_fits_and_covers(forward, backward):
    B, frames = FORWARDS[forward]
    for use, B_, Nq, Nk, C, heads, R in attention_calls(_arch(), B, frames):
        p = ta.attention_plan(B_, Nq, Nk, C, heads, R, backward=backward,
                              sms=SMS)
        what = f"{forward} {use} Nq={Nq} Nk={Nk} C={C} R={R}: {p}"
        hd = C // heads
        # the bias product's k-steps hold R; none without a bias
        assert (p.rk == 0) == (R == 0) and 16 * p.rk >= R, what
        assert 16 * p.rk < R + 16 or hd != 96, what
        # shared memory: the layout's sum, within one block's 227 KB, and
        # the blocks per SM the plan counts on fit the SM's 228 KB
        kind = "bwd_q" if backward else "fwd"
        assert p.smem == ta.attention_smem(kind, hd, p.rk, p.stages), what
        assert p.smem <= ta.SMEM_BLOCK, what
        assert 1 <= p.blocks_per_sm <= ta.BLOCKS_BY_REGS[kind], what
        assert p.blocks_per_sm * (p.smem + ta.SMEM_RESERVED) <= ta.SMEM_SM, what
        assert 1 <= p.stages <= ta.STAGES_MAX, what
        # the grid covers every query row of every (clip, head)
        assert p.blocks == -(-Nq // 64) * heads * B_, what
        if not backward:
            continue
        assert p.kv_smem == ta.attention_smem("bwd_kv", hd, p.rk,
                                              p.kv_stages), what
        assert p.kv_smem + ta.SMEM_RESERVED <= ta.SMEM_SM, what
        # K5's query splits: at least one, each with a tile, covering all
        q_tiles = -(-Nq // 64)
        assert p.splits >= 1, what
        assert (p.splits - 1) * p.tiles_per_split < q_tiles \
            <= p.splits * p.tiles_per_split, what
        assert p.kv_blocks == -(-Nk // 64) * heads * B_ * p.splits, what
        if p.splits > 1:   # the f32 partials stay bounded
            assert p.splits * B_ * Nk * 2 * C * 4 <= ta.PARTIAL_BYTES_MAX, what
        assert 1 <= p.kv_stages <= max(1, p.tiles_per_split), what


def test_plan_refuses_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="head_dim"):
        ta.attention_plan(8, 64, 64, 80 * 2, 2, 15)
    with pytest.raises(ValueError, match="kT"):
        ta.attention_plan(8, 64, 64, 96, 1, 16 * ta.RK_CHUNKED + 1)
    # other head widths pad R to 48: one bias instance each
    assert ta.attention_plan(8, 64, 64, 128, 1, 15).rk == 3
    # past 48 every head width pads R to 128, past 128 to 256
    for C in (64, 96, 128):
        assert ta.attention_plan(8, 64, 64, C, 1, 49).rk == ta.RK_WIDE
        assert ta.attention_plan(8, 64, 64, C, 1,
                                 16 * ta.RK_WIDE + 1).rk == ta.RK_CHUNKED


def _no_kv_pool_arch(frames):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.NUM_FRAMES = frames
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = None
    cfg.MVIT.POOL_KV_STRIDE = [[1, 1, 2, 2]]
    return SViTArch.from_cfg(cfg)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("frames,R", [(4, 114), (16, 120)])
def test_plan_takes_a_key_grid_past_48(frames, R, backward):
    """A block without k|v pooling at 224 px: the first block's key grid
    is (frames / 2) x 56 x 56, so R = 114 at 4 frames and 120 at 16.  The
    plan takes the wide instance (R padded to 128) within the shared memory
    of a block and of an SM, at batch 1 and 8; the main path's grids keep
    their own instances (``test_plan_fits_and_covers``)."""
    arch = _no_kv_pool_arch(frames)
    for B in (1, 8):
        calls = attention_calls(arch, B, frames)
        assert max(c[6] for c in calls) == R
        for use, B_, Nq, Nk, C, heads, R_ in calls:
            p = ta.attention_plan(B_, Nq, Nk, C, heads, R_,
                                  backward=backward, sms=SMS)
            what = f"B={B} {use} Nq={Nq} Nk={Nk} C={C} R={R_}: {p}"
            hd = C // heads
            assert (p.rk == ta.RK_WIDE) == (R_ > 48), what
            assert 16 * p.rk >= R_, what
            kind = "bwd_q" if backward else "fwd"
            assert p.smem == ta.attention_smem(kind, hd, p.rk, p.stages), what
            assert p.blocks_per_sm * (p.smem + ta.SMEM_RESERVED) \
                <= ta.SMEM_SM, what
            if backward:
                assert p.kv_smem + ta.SMEM_RESERVED <= ta.SMEM_SM, what


@pytest.mark.parametrize("k_shape", [(8, 7, 7), (8, 14, 14), (1, 7, 7),
                                     (1, 14, 14)])
@pytest.mark.parametrize("extras", [65, 5])
def test_onehot_matches_jax_scatter_matrix(k_shape, extras):
    """M^T: the JAX one-hot map's bias rows [:R], transposed, at exact Nk;
    zero columns past R; and its tiles in the kernels' core-matrix order."""
    R = sum(k_shape)
    n_k = math.prod(k_shape) + extras
    n_k_pad = -(-n_k // 128) * 128
    ref = np.asarray(_scatter_matrix(k_shape, n_k, n_k_pad, 0))[:R, :n_k].T
    mt = ta.onehot_mt(k_shape, n_k, 48)
    np.testing.assert_array_equal(mt[:, :R].numpy(), ref)
    assert not mt[:, R:].any()
    tiles = ta.tile_onehot(mt).float()
    rows = -(-n_k // 64) * 64
    assert tiles.shape == (rows // 64, 6, 64, 8)
    back = tiles.transpose(1, 2).reshape(rows, 48)
    assert torch.equal(back[:n_k], mt) and not back[n_k:].any()


@pytest.mark.parametrize("k_shape", [(1, 7, 7), (8, 7, 7), (1, 14, 14),
                                     (8, 14, 14), (2, 56, 56)])
def test_bias_product_and_hi_lo_gradient(k_shape):
    """R = 15, 22, 29, 36 and 114 (the wide instance, R padded to 128).  Logits: the kernels add bias_src @ M^T (the
    one-hot factor exact, f32 accumulation) where the twin gathers three
    terms; only the order of three f32 additions differs, so 1e-6
    relative.  dbias: the kernels take round(dS) @ M and round(dS -
    round(dS)) @ M, two bf16 products against the exact one-hot, which
    carry dS to about 2^-16 of itself; summed in f32 over the keys that is
    within 1e-4 of the twin's f32 scatter."""
    R = sum(k_shape)
    n_k = math.prod(k_shape) + 65
    rk = ta.attention_plan(1, 40, n_k, 96, 1, R).rk
    rs = np.random.RandomState(R)
    bias = torch.tensor(rs.randn(2, 3, 40, R), dtype=torch.float32).to(
        torch.bfloat16)
    mt = ta.onehot_mt(k_shape, n_k, 16 * rk)
    padded = torch.nn.functional.pad(bias.float(), (0, 16 * rk - R))
    by_product = padded @ mt.T
    gathered = ta._gather_bias(bias, k_shape, n_k)
    torch.testing.assert_close(by_product, gathered, rtol=1e-6, atol=1e-6)

    ds = torch.tensor(rs.randn(2, 3, 40, n_k) * 1e-2, dtype=torch.float32)
    hi = ds.to(torch.bfloat16).float()
    lo = (ds - hi).to(torch.bfloat16).float()
    dbias = (hi @ mt + lo @ mt)[..., :R]
    want = ta._bias_grad(ds, k_shape)
    assert float((dbias - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    # one bf16 product alone would not do
    one = (hi @ mt)[..., :R]
    assert float((one - want).abs().max()) > 1e-4 * float(want.abs().max())
