"""K3's backward launch plan (``ops/pool.py:max_bwd_plan``; pure Python, no
card).

The route by shape: the tuned instance (``csrc/pool.cu:
pool_max_bwd_tile_kernel``) takes the main path's skip pool, kernel
(1, 3, 3) at stride (1, 2, 2) with C a multiple of 96; the general gather
every other call.  The tuned plan's shared memory fits a block and its TMA
boxes are legal; its tile walk, enumerated block by block as the kernel
walks it (tiles ``blockIdx.x + k grid``, each consumer thread's (row,
column, 16-byte chunk) items, the stores masked past odd edges), writes
every dx chunk of the main path's calls and of odd grids exactly once.
Then an emulation of the kernel's arithmetic, tile by tile (the two boxes
with TMA's zero fill, each cell's (window, tap) pairs in the kernel's
order, g masked to +0.0 where the tap is not the argmax, f32 sums rounded
once), held bit for bit against the plain twin
(``pool_max_backward_reference``) on random, three-level and signed-zero
cotangents."""

import os

import numpy as np
import pytest
import torch

from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models.svit import SViTArch
from svit_tpu_torch.ops import pool as tp
from svit_tpu_torch.ops.pooling import out_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132          # the H100 SXM's SMs
SKIP = ((1, 3, 3), (1, 2, 2))
CHUNKS = tp.SLAB // 8
# each dx cell of a base position: (dh, dw) in the cell, then its (window
# offset (dm, dn), tap) pairs in the kernel's adding order
CELLS = (((0, 0), (((0, 0), 4),)),
         ((0, 1), (((0, 0), 5), ((0, 1), 3))),
         ((1, 0), (((0, 0), 7), ((1, 0), 1))),
         ((1, 1), (((0, 0), 8), ((0, 1), 6), ((1, 0), 2), ((1, 1), 0))))


def skip_calls():
    """dx shapes of the train step's ``pool_max_bwd`` calls: the skip pool
    of each block with a q stride, in the video (batch 8, 8 latent frames)
    and the image (batch 8, one frame) backward."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    arch = SViTArch.from_cfg(cfg)
    calls = []
    for B, frames in ((8, arch.patch_dims[0]), (8, 1)):
        size = (frames, *arch.patch_dims[1:])
        for s in arch.blocks:
            if int(np.prod(s.stride_q)) > 1:
                kernel = tuple(k + 1 if k > 1 else k for k in s.stride_q)
                calls.append(((B, *size, s.dim_out), kernel,
                              tuple(s.stride_q)))
            size = tuple(out_size(d, k, st) for d, k, st in
                         zip(size, s.kernel_q, s.stride_q))
    return calls


def test_the_skip_calls_are_the_step_s():
    """Six calls a step, all at the skip pool the tuned instance takes."""
    calls = skip_calls()
    assert sorted(shape for shape, _, _ in calls) == sorted(
        [(8, 8, 56, 56, 192), (8, 8, 28, 28, 384), (8, 8, 14, 14, 768),
         (8, 1, 56, 56, 192), (8, 1, 28, 28, 384), (8, 1, 14, 14, 768)])
    assert {(k, s) for _, k, s in calls} == {SKIP}


@pytest.mark.parametrize("C", [96, 192, 384, 768])
def test_route_tuned_at_the_skip_pool(C):
    for shape in ((8, 8, 56, 56, C), (2, 1, 7, 9, C), (1, 2, 57, 55, C)):
        plan = tp.max_bwd_plan(shape, *SKIP, sms=SMS)
        assert plan.route == "tile", shape
        assert tp.max_bwd_plan(shape, *SKIP, sms=SMS,
                               general=True).route == "gather"


# the card tests' other K3 cases (tests/test_torch_kernels_cuda.py
# POOL_MAX_CASES), and the skip pool at channel counts that are not
# multiples of 96
@pytest.mark.parametrize("shape,kernel,stride", [
    ((2, 5, 9, 11, 16), (3, 3, 3), (2, 2, 2)),
    ((1, 2, 9, 9, 8), (1, 5, 5), (1, 4, 4)),
    ((2, 4, 7, 9, 96), (3, 3, 3), (1, 2, 2)),
    ((2, 4, 14, 14, 96), (1, 3, 3), (1, 1, 1)),
    ((2, 4, 14, 14, 16), (1, 3, 3), (1, 2, 2)),
    ((2, 4, 14, 14, 64), (1, 3, 3), (1, 2, 2)),
])
def test_route_general_elsewhere(shape, kernel, stride):
    assert tp.max_bwd_plan(shape, kernel, stride, sms=SMS).route == "gather"


def _check_plan(plan, shape):
    B, T, H, W, C = shape
    Ho, Wo = out_size(H, 3, 2), out_size(W, 3, 2)
    what = f"{shape} {plan}"
    assert plan.smem <= tp.SMEM_BLOCK_MAX, what
    assert plan.smem == tp.max_bwd_smem(plan.rows, plan.cols, plan.ring)[-1]
    assert plan.per_sm >= 1 and 2 <= plan.ring <= 8, what
    assert plan.per_sm * (plan.smem + tp.SMEM_RESERVED) <= tp.SMEM_SM, what
    assert 1 <= plan.rows <= 8 and plan.threads == 32 * plan.rows + 32, what
    assert all(1 <= d <= 256 for d in plan.box), what
    # the inner box is 96 bf16 (192 bytes) of g and 96 bytes of the
    # argmax: both multiples of 16, as TMA wants; so are the global strides
    assert plan.box[0] * 2 % 16 == 0 and plan.box[0] % 16 == 0, what
    assert C % 16 == 0, what
    assert plan.g_bytes % 128 == 0 and plan.stage_bytes % 128 == 0, what
    assert plan.tiles == (B, T, -(-Ho // plan.rows), -(-Wo // plan.cols))
    assert 1 <= plan.grid <= plan.items
    assert plan.slabs == C // tp.SLAB
    # one wave at most
    assert plan.grid * plan.slabs <= max(plan.per_sm * SMS, plan.slabs)


@pytest.mark.parametrize("shape", [c[0] for c in skip_calls()])
def test_main_path_plans_fit(shape):
    plan = tp.max_bwd_plan(shape, *SKIP, sms=SMS)
    _check_plan(plan, shape)
    # the tile keeps the halo small: at most 2 x 1.25 windows loaded a
    # base position
    assert (plan.rows + 1) * (plan.cols + 1) <= 2.5 * plan.rows * plan.cols


def test_sweep_tiles_fit_or_raise():
    shape = (8, 8, 56, 56, 192)
    for rows in range(1, 9):
        for cols in (4, 7, 8, 14, 16, 28):
            for ring in (2, 3, 4):
                try:
                    plan = tp.max_bwd_plan(shape, *SKIP, sms=SMS, rows=rows,
                                           cols=cols, ring=ring)
                except ValueError:
                    assert tp.max_bwd_smem(rows, cols, ring)[-1] > \
                        tp.SMEM_BLOCK_MAX
                    continue
                _check_plan(plan, shape)
    with pytest.raises(ValueError):
        tp.max_bwd_plan(shape, *SKIP, rows=9)


def tile_of(plan, item, Ho, Wo):
    """(b, t, m0, n0) of tile ``item``: w tiles fastest, then h tiles, the
    frame, the clip (``csrc/pool.cu:max_bwd_item``)."""
    _, T, nh, nw = plan.tiles
    n0 = item % nw * plan.cols
    r = item // nw
    m0 = r % nh * plan.rows
    r //= nh
    return r // T, r % T, m0, n0


def walk(plan, shape):
    """Every (block, tile, consumer item) the kernel runs, as arrays: the
    tile's (b, t, m0, n0) and the item's (r, j, k), for one slab (every
    slab walks alike)."""
    B, T, H, W, C = shape
    Ho, Wo = out_size(H, 3, 2), out_size(W, 3, 2)
    cons = 32 * plan.rows
    out = []
    for block in range(plan.grid):
        for item in range(block, plan.items, plan.grid):
            b, t, m0, n0 = tile_of(plan, item, Ho, Wo)
            nrows, ncols = min(plan.rows, Ho - m0), min(plan.cols, Wo - n0)
            # thread x takes items x, x + cons, ...: together all of them
            e = np.concatenate([np.arange(x, nrows * ncols * CHUNKS, cons)
                                for x in range(cons)])
            k, q = e % CHUNKS, e // CHUNKS
            out.append((np.full(e.shape, b), np.full(e.shape, t),
                        m0 + q // ncols, n0 + q % ncols, k))
    return [np.concatenate(a) for a in zip(*out)]


@pytest.mark.parametrize("shape", [c[0] for c in skip_calls()]
                         + [(1, 2, 57, 55, 96), (2, 1, 9, 7, 192),
                            (1, 1, 2, 3, 96), (1, 1, 1, 1, 96)])
def test_tile_walk_writes_every_dx_chunk_once(shape):
    """Brute force: count the 16-byte dx chunks the walk stores (masked
    past odd H and W, as the kernel's stores are); each exactly once, and
    every base position's windows lie in its tile's box."""
    B, T, H, W, C = shape
    plan = tp.max_bwd_plan(shape, *SKIP, sms=SMS)
    b, t, m, n, k = walk(plan, shape)
    Ho, Wo = out_size(H, 3, 2), out_size(W, 3, 2)
    assert (m < Ho).all() and (n < Wo).all()
    count = np.zeros((B, T, H + 1, W + 1, CHUNKS), np.int32)
    for dh, dw in ((0, 0), (0, 1), (1, 0), (1, 1)):
        h, w = 2 * m + dh, 2 * n + dw
        keep = (h < H) & (w < W)          # the kernel's store predicates
        np.add.at(count, (b[keep], t[keep], h[keep], w[keep], k[keep]), 1)
    assert (count[:, :, :H, :W] == 1).all()
    assert count[:, :, H:].sum() == 0 and count[:, :, :, W:].sum() == 0


def emulate(g, arg, plan, in_shape):
    """The tuned kernel's arithmetic on CPU tensors, tile by tile: the g and
    argmax boxes of (rows + 1) x (cols + 1) windows from the tile's corner
    with zero fill past the grid, every base position's four cells summed
    in f32 from +0.0 in the kernel's (window, tap) order, g masked to +0.0
    bits where the tap is not the window's argmax, rounded once to bf16;
    cells past odd H or W dropped."""
    B, T, H, W, C = in_shape
    Ho, Wo = g.shape[2:4]
    R, K = plan.rows, plan.cols
    gp = torch.zeros((B, T, Ho + R + 1, Wo + K + 1, C), dtype=g.dtype)
    ap = torch.zeros(gp.shape, dtype=torch.uint8)
    gp[:, :, :Ho, :Wo] = g
    ap[:, :, :Ho, :Wo] = arg
    dx = torch.full((B, T, 2 * Ho + 2 * R, 2 * Wo + 2 * K, C), float("nan"),
                    dtype=g.dtype)
    for item in range(plan.items):
        b, t, m0, n0 = tile_of(plan, item, Ho, Wo)
        gbox = gp[b, t, m0:m0 + R + 1, n0:n0 + K + 1].float()
        abox = ap[b, t, m0:m0 + R + 1, n0:n0 + K + 1]
        for (dh, dw), pairs in CELLS:
            acc = torch.zeros((R, K, C), dtype=torch.float32)
            for (dm, dn), tap in pairs:
                v = gbox[dm:dm + R, dn:dn + K]
                hit = abox[dm:dm + R, dn:dn + K] == tap
                acc = acc + torch.where(hit, v, torch.zeros(()))
            dx[b, t, 2 * m0 + dh:2 * m0 + 2 * R:2,
               2 * n0 + dw:2 * n0 + 2 * K:2] = acc.to(g.dtype)
    return dx[:, :, :H, :W].contiguous()


@pytest.mark.parametrize("levels", [0, 3])
@pytest.mark.parametrize("shape,tile", [
    ((2, 2, 14, 14, 96), None),
    ((1, 2, 57, 55, 96), None),
    ((2, 1, 9, 11, 192), (2, 3)),
    ((1, 1, 7, 5, 96), (1, 1)),
])
def test_emulated_tile_kernel_equals_the_twin(shape, tile, levels):
    """Bit for bit against the plain twin, on bf16 grids of random or three
    levels (ties in most windows: the first maximum takes g) and a
    cotangent of widely spread magnitudes with signed zeros, at odd H and W
    and tiles whose columns do not divide Wo."""
    B, T, H, W, C = shape
    rs = np.random.RandomState(7)
    x = (rs.randint(0, levels, shape) if levels else rs.randn(*shape))
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    arg = tp.pool_max_argmax_reference(x, *SKIP)
    # magnitudes 2^-24 .. 2^24 apart: the f32 sums of a cell's bf16 terms
    # round, so any other adding order shows
    g = (rs.randn(*arg.shape) * 2.0 ** rs.randint(-24, 25, arg.shape)
         ).astype(np.float32)
    g[rs.rand(*g.shape) < 0.2] = -0.0
    g = torch.from_numpy(g).to(torch.bfloat16)
    rows, cols = tile or (None, None)
    plan = tp.max_bwd_plan(shape, *SKIP, sms=SMS, rows=rows, cols=cols)
    got = emulate(g, arg, plan, shape)
    want = tp.pool_max_backward_reference(g, arg, *SKIP, shape)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # the wrapper on a CPU tensor is the twin, whatever the route
    assert torch.equal(tp.pool_max_bwd(g, arg, *SKIP, shape), want)
    assert torch.equal(tp.pool_max_bwd(g, arg, *SKIP, shape, general=True),
                       want)
