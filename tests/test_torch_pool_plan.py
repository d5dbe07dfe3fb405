"""K2 and K7's launch plan (pure Python, no card).

``ops/pool.py:pool_plan`` for every K2 call (the q and k|v pools) of the
SViT-B/16 forwards (video batch 8 and 1, image batch 8, the train step's
128-frame consistency forward) and every K7 call of the step's backward:
the shared memory fits a block, the TMA boxes are legal, the tiles cover
each output position once.  Then an emulation in f32 of what the kernels
do with the plan, block by block and tile by tile (the boxes' signed
origins, traversal strides and zero fill, the frame window, the slide
along W, the tap order of the sparse boxes, K7's partials added in block
order), held against the plain twins at reduced size."""

import math
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
FORWARDS = {"video batch 8": (8, 16), "video batch 1": (1, 16),
            "image batch 8": (8, 1), "consistency 128 frames": (128, 1)}
BACKWARD = ("video batch 8", "image batch 8")


def _arch(**small):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    for key, v in small.items():
        node, leaf = key.split(".")
        cfg[node][leaf] = v
    return SViTArch.from_cfg(cfg)


def pool_calls(arch, B, frames):
    """(input shape, kernel, stride) of every K2 launch of one forward: the
    q pool, then the fused k|v pool of each block."""
    size = (arch.patch_dims[0] if frames > 1 else 1, *arch.patch_dims[1:])
    calls = []
    for s in arch.blocks:
        calls += [((B, *size, s.dim_out), tuple(s.kernel_q),
                   tuple(s.stride_q)),
                  ((B, *size, 2 * s.dim_out), tuple(s.kernel_kv),
                   tuple(s.stride_kv))]
        size = tuple(out_size(d, k, st) for d, k, st in
                     zip(size, s.kernel_q, s.stride_q))
    return calls


def test_the_call_list_is_the_forward_s():
    """32 K2 launches per forward at the main path's (C, stride, grid)."""
    video = pool_calls(_arch(), 8, 16)
    assert len(video) == 32
    got = {(shape[-1], stride[1], shape[2]) for shape, _, stride in video}
    assert got == {(96, 1, 56), (192, 2, 56), (192, 1, 28), (384, 2, 28),
                   (384, 1, 14), (768, 2, 14), (768, 1, 7), (192, 8, 56),
                   (384, 4, 56), (384, 4, 28), (768, 2, 28), (768, 2, 14),
                   (1536, 1, 14), (1536, 1, 7)}
    assert {k for _, k, _ in video} == {(3, 3, 3)}
    assert {shape[1] for shape, _, _ in pool_calls(_arch(), 8, 1)} == {1}


def _check_plan(plan, shape, kernel, stride):
    B, T, H, W, C = shape
    To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                  zip((T, H, W), kernel, stride))
    what = f"{shape} {stride} {plan}"
    assert plan.smem <= tp.SMEM_BLOCK_MAX, what
    assert plan.per_sm >= 1, what
    assert plan.smem == tp.pool_smem(plan.kind, kernel[0], plan.rows,
                                     plan.cols, plan.ring, stride)[-1]
    assert all(1 <= d <= 256 for d in plan.box), what
    assert plan.box[0] * 2 % 16 == 0, what            # inner box bytes
    assert all(1 <= s <= 8 for s in plan.step), what
    assert plan.landed == tuple(-(-b // s) for b, s in
                                zip(plan.box, plan.step)), what
    assert plan.ring >= kernel[0], what
    assert plan.slabs == C // tp.SLAB, what
    assert 1 <= plan.grid <= plan.items, what
    # the tiles cover each output position once: the tile counts are the
    # least that reach the extent, so no tile starts past it
    for n, size, ext in zip(plan.tiles, (1, plan.frames, plan.rows,
                                         plan.cols), (B, To, Ho, Wo)):
        assert n * size >= ext and (n - 1) * size < ext, what
    assert plan.items == math.prod(plan.tiles), what
    threads = (32 * plan.rows if plan.kind == "pool"
               else -(-48 * plan.rows // 32) * 32) + 32
    assert plan.threads == threads <= 224, what


@pytest.mark.parametrize("forward", list(FORWARDS))
def test_pool_plan_fits_and_covers(forward):
    """K2 (both modes share the plan) at every call of each forward."""
    B, frames = FORWARDS[forward]
    for shape, kernel, stride in pool_calls(_arch(), B, frames):
        _check_plan(tp.pool_plan(shape, kernel, stride, "pool", sms=SMS),
                    shape, kernel, stride)


@pytest.mark.parametrize("forward", BACKWARD)
def test_dk_plan_fits_and_covers(forward):
    """K7 at every call of the train step's backward; its partial count
    (the grid) depends on the shape only."""
    B, frames = FORWARDS[forward]
    for shape, kernel, stride in pool_calls(_arch(), B, frames):
        plan = tp.pool_plan(shape, kernel, stride, "dk", sms=SMS)
        _check_plan(plan, shape, kernel, stride)
        again = tp.pool_plan(tuple(shape), tuple(kernel), tuple(stride), "dk",
                             sms=SMS)
        assert again == plan


def test_plan_rejects_what_the_kernels_do_not_take():
    """Outside the stated set: C no multiple of 8, a kernel side of 7 or an
    even one, a T stride of 3, a spatial stride past 8, an LN head width
    past 128, not a multiple of 8 or not dividing C, and K7 at a T stride
    of 2 or sH != sW off the tuned instance's shapes."""
    with pytest.raises(ValueError, match="multiple of 8"):
        tp.pool_plan((2, 4, 8, 8, 100), (3, 3, 3), (1, 1, 1))   # C
    with pytest.raises(ValueError, match="kernels"):
        tp.pool_plan((2, 4, 8, 8, 96), (3, 7, 7), (1, 1, 1))    # kernel
    with pytest.raises(ValueError, match="kernels"):
        tp.pool_plan((2, 4, 8, 8, 96), (3, 4, 4), (1, 1, 1))    # even
    with pytest.raises(ValueError, match="T stride"):
        tp.pool_plan((2, 4, 8, 8, 96), (3, 3, 3), (3, 1, 1))    # T stride
    with pytest.raises(ValueError, match="strides 1 to 8"):
        tp.pool_plan((2, 4, 8, 8, 96), (3, 3, 3), (1, 9, 9))    # > 8
    for C, hd, rule in ((272, 136, "up to 128"), (96, 12, "multiple of 8"),
                        (96, 40, "divides C")):
        with pytest.raises(ValueError, match=rule):
            tp.pool_plan((2, 4, 8, 8, C), (3, 3, 3), (1, 1, 1),
                         head_dim=hd)
    for stride in ((2, 2, 2), (1, 2, 1)):
        with pytest.raises(ValueError, match="_dk_pallas"):
            tp.pool_plan((2, 4, 8, 8, 128), (3, 5, 5), stride, "dk")
    with pytest.raises(ValueError, match="kind"):
        tp.pool_plan((2, 4, 8, 8, 96), (3, 3, 3), (1, 1, 1), "max")


# ---- the emulation -------------------------------------------------------

def tma_box(x, origin, box, step):
    """A TMA load of a 5-D map over [C, W, H, T, B] (innermost first) from
    ``x`` [B, T, H, W, C]: ``box`` elements traversed from the signed
    ``origin`` at traversal strides ``step``, everything outside the tensor
    zero.  Returns [H', W', C'] (the T and B extents are 1)."""
    B, T, H, W, C = x.shape
    c, w, h, t, b = origin
    idx = [torch.arange(o, o + n, s) for o, n, s in zip(origin, box, step)]
    cs, ws, hs = idx[0], idx[1], idx[2]
    out = x.new_zeros((len(hs), len(ws), len(cs)))
    if not (0 <= t < T and 0 <= b < B):
        return out
    hm = (hs >= 0) & (hs < H)
    wm = (ws >= 0) & (ws < W)
    cm = (cs >= 0) & (cs < C)
    sub = x[b, t][hs[hm]][:, ws[wm]][:, :, cs[cm]]
    out[torch.nonzero(hm).flatten()[:, None, None],
        torch.nonzero(wm).flatten()[None, :, None],
        torch.nonzero(cm).flatten()[None, None, :]] = sub
    return out


def item_of(plan, item, To, T, kT):
    """csrc/pool.cu item_of: (b, t_lo, t_hi, h0, w0, f_lo, f_hi)."""
    nb, ntc, nh, nw = plan.tiles
    wx = item % nw
    r = item // nw
    hy = r % nh
    r //= nh
    tc = r % ntc
    b = r // ntc
    t_lo = tc * plan.frames
    t_hi = min(To, t_lo + plan.frames)
    pT = kT // 2
    return (b, t_lo, t_hi, hy * plan.rows, wx * plan.cols, max(0, t_lo - pT),
            min(T - 1, t_hi - 1 - pT + kT - 1))


def frame_slot(x, plan, b, f, h0, w0, c0, stride):
    """What the producer lands for input frame ``f`` of a tile: one dense
    halo box [bh, bw, 96], or the nine strided boxes [9, rows, cols, 96]."""
    _, sH, sW = stride
    if not plan.sparse:
        return tma_box(x, (c0, w0 * sW - 1, h0 * sH - 1, f, b), plan.box,
                       plan.step)
    return torch.stack([tma_box(x, (c0, w0 * sW - 1 + dw, h0 * sH - 1 + dh,
                                    f, b), plan.box, plan.step)
                        for dh in range(3) for dw in range(3)])


def tap(slot, plan, r, o, dh, dw, stride):
    """csrc/pool.cu tap_at: the slab vector of tap (dh, dw) of output (r, o)."""
    _, sH, sW = stride
    if plan.sparse:
        return slot[dh * 3 + dw, r, o]
    return slot[sH * r + dh, sW * o + dw]


def walk(x, plan, kernel, stride, visit):
    """Every block of the grid, its tiles in order, each tile's output
    frames with the slots of their window's frames in the clip:
    ``visit(block, c0, b, to, h0, w0, ncols, slots)`` with ``slots`` a list
    of (dt, slot)."""
    B, T, H, W, C = x.shape
    kT = kernel[0]
    To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                  zip((T, H, W), kernel, stride))
    for slab in range(plan.slabs):
        c0 = slab * tp.SLAB
        for block in range(plan.grid):
            for item in range(block, plan.items, plan.grid):
                b, t_lo, t_hi, h0, w0, f_lo, f_hi = item_of(plan, item, To,
                                                            T, kT)
                ncols = min(plan.cols, Wo - w0)
                frames = {f: frame_slot(x, plan, b, f, h0, w0, c0, stride)
                          for f in range(f_lo, f_hi + 1)}
                for to in range(t_lo, t_hi):
                    slots = [(dt, frames[to - kT // 2 + dt])
                             for dt in range(kT)
                             if f_lo <= to - kT // 2 + dt <= f_hi]
                    visit(block, c0, b, to, h0, w0, ncols, slots)


def emulate_pool(x, weight, ln_w, ln_b, stride, apply_ln):
    """K2 by the plan, in f32: the conv from the slots, then the LN per slab
    (or none).  Also counts the writes of each output position."""
    B, T, H, W, C = x.shape
    kernel = tuple(weight.shape[2:])
    plan = tp.pool_plan(x.shape, kernel, stride, "pool", sms=2)
    To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                  zip((T, H, W), kernel, stride))
    taps = weight.reshape(C, -1).t()               # [kT*9, C], tap-major
    out = x.new_zeros((B, To, Ho, Wo, C))
    writes = torch.zeros((B, To, Ho, Wo, C // tp.SLAB), dtype=torch.int64)

    def visit(block, c0, b, to, h0, w0, ncols, slots):
        for r in range(plan.rows):
            if h0 + r >= Ho:
                continue
            for o in range(ncols):
                acc = x.new_zeros(tp.SLAB)
                for dt, slot in slots:
                    for dh in range(3):
                        for dw in range(3):
                            k = (dt * 3 + dh) * 3 + dw
                            acc += (tap(slot, plan, r, o, dh, dw, stride)
                                    * taps[k, c0:c0 + tp.SLAB])
                if apply_ln:
                    m = acc.mean()
                    d = acc - m
                    acc = (d * torch.rsqrt(d.square().mean() + tp.EPS)
                           * ln_w[c0:c0 + tp.SLAB] + ln_b[c0:c0 + tp.SLAB])
                out[b, to, h0 + r, w0 + o, c0:c0 + tp.SLAB] = acc
                writes[b, to, h0 + r, w0 + o, c0 // tp.SLAB] += 1

    walk(x, plan, kernel, stride, visit)
    return out, writes


def emulate_dk(x, g, kernel, stride):
    """K7 by the plan, in f32: each block's partial [taps, C] from its
    tiles (x slots against the g tile), then the partials added in block
    order."""
    B, T, H, W, C = x.shape
    plan = tp.pool_plan(x.shape, kernel, stride, "dk", sms=2)
    kT = kernel[0]
    partial = x.new_zeros((plan.grid, kT * 9, C))

    def visit(block, c0, b, to, h0, w0, ncols, slots):
        g_tile = tma_box(g, (c0, w0, h0, to, b),
                         (tp.SLAB, plan.cols, plan.rows, 1, 1), (1,) * 5)
        for r in range(plan.rows):
            for o in range(plan.cols):       # zero-filled past the grid
                gv = g_tile[r, o]
                for dt, slot in slots:
                    for dh in range(3):
                        for dw in range(3):
                            k = (dt * 3 + dh) * 3 + dw
                            partial[block, k, c0:c0 + tp.SLAB] += (
                                tap(slot, plan, r, min(o, ncols - 1), dh, dw,
                                    stride) * gv)

    walk(x, plan, kernel, stride, visit)
    dk = x.new_zeros((kT * 9, C))
    for block in range(plan.grid):
        dk += partial[block]
    return dk.t().reshape(C, 1, *kernel)


EMU_STRIDES = [(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 8, 8)]
# reduced size: a 2-frame clip and an image (T = 1 with kT = 3), 2 slabs,
# H and W that no tile divides
EMU_SHAPES = {"clip": (2, 2, 13, 17, 192), "image": (2, 1, 10, 9, 192)}


def _inputs(shape, kernel, stride, seed=0):
    rs = np.random.RandomState(seed)
    B, T, H, W, C = shape
    To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                  zip((T, H, W), kernel, stride))
    f = (lambda *s, scale=1.0: torch.from_numpy(
        (scale * rs.randn(*s)).astype(np.float32)))
    return (f(*shape), f(C, 1, *kernel, scale=0.2), 1 + f(C, scale=0.1),
            f(C, scale=0.1), f(B, To, Ho, Wo, C))


def _close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(
        b.abs().max()))


@pytest.mark.parametrize("apply_ln", [True, False])
@pytest.mark.parametrize("what", list(EMU_SHAPES))
@pytest.mark.parametrize("stride", EMU_STRIDES)
def test_emulated_pool_matches_the_twin(stride, what, apply_ln):
    """K2's plan and layout, emulated in f32, against pool_ln_reference
    (LN mode) and depthwise_conv_reference (bare mode); each output
    position written once.  1e-5 relative: the order of the sums."""
    x, w, ls, lb, _ = _inputs(EMU_SHAPES[what], (3, 3, 3), stride)
    got, writes = emulate_pool(x, w, ls, lb, stride, apply_ln)
    assert bool((writes == 1).all())
    want = (tp.pool_ln_reference(x, w, ls, lb, stride, tp.SLAB) if apply_ln
            else tp.depthwise_conv_reference(x, w, stride))
    _close(got, want)


@pytest.mark.parametrize("what", list(EMU_SHAPES))
@pytest.mark.parametrize("stride", EMU_STRIDES)
def test_emulated_dk_matches_the_twin(stride, what):
    """K7's plan, tiles, partials and their order, emulated in f32, against
    depthwise_conv_dk_reference."""
    x, _, _, _, g = _inputs(EMU_SHAPES[what], (3, 3, 3), stride)
    _close(emulate_dk(x, g, (3, 3, 3), stride),
           tp.depthwise_conv_dk_reference(x, g, (3, 3, 3), stride))


def test_emulated_kernels_with_one_frame_taps():
    """kT = 1 (the bare conv and K7 take it)."""
    stride = (1, 2, 2)
    x, w, ls, lb, _ = _inputs((2, 3, 11, 12, 96), (1, 3, 3), stride)
    got, writes = emulate_pool(x, w, ls, lb, stride, False)
    assert bool((writes == 1).all())
    _close(got, tp.depthwise_conv_reference(x, w, stride))
    g = _inputs((2, 3, 11, 12, 96), (1, 3, 3), stride, seed=1)[-1]
    _close(emulate_dk(x, g, (1, 3, 3), stride),
           tp.depthwise_conv_dk_reference(x, g, (1, 3, 3), stride))


@pytest.mark.parametrize("stride", EMU_STRIDES)
def test_reduced_model_calls_are_covered_once(stride):
    """At the reduced size of tests/conftest.py (4 frames, 56 px: a 2 x 14
    x 14 grid), enumerate every tile of the plan for each K2 and K7 call of
    that stride: each output position is in exactly one tile."""
    arch = _arch(**{"DATA.NUM_FRAMES": 4, "DATA.TRAIN_CROP_SIZE": 56,
                    "DATA.TEST_CROP_SIZE": 56})
    calls = [c for c in pool_calls(arch, 2, 4) + pool_calls(arch, 2, 1)
             if tuple(c[2]) == stride]
    if stride == (1, 4, 4):
        # the reduced schedule has no (1,4,4) pool: take the 14x14 grid
        calls = [((2, 2, 14, 14, 192), (3, 3, 3), stride)]
    assert calls
    for shape, kernel, st in calls:
        B, T, H, W, C = shape
        To, Ho, Wo = (out_size(d, k, s) for d, k, s in
                      zip((T, H, W), kernel, st))
        for kind in ("pool", "dk"):
            plan = tp.pool_plan(shape, kernel, st, kind, sms=SMS)
            seen = np.zeros((B, To, Ho, Wo), np.int64)
            for block in range(plan.grid):
                for item in range(block, plan.items, plan.grid):
                    b, t_lo, t_hi, h0, w0, _, _ = item_of(plan, item, To, T,
                                                          kernel[0])
                    seen[b, t_lo:t_hi, h0:h0 + plan.rows,
                         w0:w0 + plan.cols] += 1
            assert (seen == 1).all(), (shape, st, kind, plan)


# ---- the general instance (K2 at other shapes, K6, K7 at other shapes) ---

def gen_walk(inp, plan, visit):
    """Every block of the general instance's grid, its tiles in order, each
    base frame with the slots of its window's frames in the clip: ``visit(
    block, c0, b, to, h0, w0, ncols, slots)`` with ``slots`` {dt: slot}.
    ``inp`` is what the ring loads (x, or K6's g)."""
    at, ah, aw = plan.axes
    Tin = inp.shape[1]
    nb, ntc, nh, nw = plan.tiles
    for slab in range(plan.slabs):
        c0 = slab * plan.slab
        for block in range(plan.grid):
            for item in range(block, plan.items, plan.grid):
                wx, r = item % nw, item // nw
                hy, r = r % nh, r // nh
                tc, b = r % ntc, r // ntc
                t_lo = tc * plan.frames
                t_hi = min(at.base, t_lo + plan.frames)
                h0, w0 = hy * plan.rows, wx * plan.cols
                f_lo = max(0, t_lo * at.step + at.org)
                f_hi = min(Tin - 1, (t_hi - 1) * at.step + at.org
                           + at.span - 1)
                frames = {f: tma_box(inp, (c0, w0 * aw.step + aw.org,
                                           h0 * ah.step + ah.org, f, b),
                                     plan.box, plan.step)
                          for f in range(f_lo, f_hi + 1, plan.fstep)}
                for to in range(t_lo, t_hi):
                    slots = {dt: frames[f] for dt in range(at.span)
                             if (f := to * at.step + at.org + dt) in frames}
                    visit(block, c0, b, to, h0, w0,
                          min(plan.cols, aw.base - w0), slots)


def _tap_index(kernel, ut, uh, uw):
    return (ut * kernel[1] + uh) * kernel[2] + uw


def emulate_gen(inp, weight, ln_w, ln_b, plan, apply_ln):
    """The general K2 / K6 kernel by the plan, in f32: per base position
    and class, the class's taps from the slots, the LN over the slab (or
    none).  Also counts the writes of each output position."""
    at, ah, aw = plan.axes
    kernel = tuple(weight.shape[2:])
    C, S = inp.shape[-1], plan.slab
    taps = weight.reshape(C, -1).t()
    out = inp.new_zeros((inp.shape[0], at.out, ah.out, aw.out, C))
    writes = torch.zeros(out.shape[:4] + (C // S,), dtype=torch.int64)

    def visit(block, c0, b, to, h0, w0, ncols, slots):
        for r in range(plan.rows):
            qh = h0 + r
            if qh >= ah.base:
                continue
            for o in range(ncols):
                for rt, ct in enumerate(at.classes):
                    ot = to * at.out_step + rt
                    for rh, ch in enumerate(ah.classes):
                        oh = qh * ah.out_step + rh
                        for rw, cw in enumerate(aw.classes):
                            ow = (w0 + o) * aw.out_step + rw
                            if ot >= at.out or oh >= ah.out or ow >= aw.out:
                                continue
                            acc = inp.new_zeros(S)
                            for dt, ut in ct:
                                if dt not in slots:
                                    continue
                                for dh, uh in ch:
                                    for dw, uw in cw:
                                        acc += (slots[dt][r * ah.step + dh,
                                                          o * aw.step + dw]
                                                * taps[_tap_index(
                                                    kernel, ut, uh, uw),
                                                    c0:c0 + S])
                            if apply_ln:
                                d = acc - acc.mean()
                                acc = (d * torch.rsqrt(d.square().mean()
                                                       + tp.EPS)
                                       * ln_w[c0:c0 + S] + ln_b[c0:c0 + S])
                            out[b, ot, oh, ow, c0:c0 + S] = acc
                            writes[b, ot, oh, ow, c0 // S] += 1

    gen_walk(inp, plan, visit)
    return out, writes


def emulate_gen_dk(x, g, kernel, stride):
    """The general K7 by the plan, in f32: each block's partial from its
    tiles (every tap against the g tile at each base position), then the
    partials added in block order."""
    C = x.shape[-1]
    plan = tp.pool_plan(x.shape, kernel, stride, "dk", sms=2)
    assert plan.route == "gen"
    at, ah, aw = plan.axes
    S = plan.slab
    partial = x.new_zeros((plan.grid, math.prod(kernel), C))

    def visit(block, c0, b, to, h0, w0, ncols, slots):
        g_tile = tma_box(g, (c0, w0, h0, to, b), (S, plan.cols, plan.rows,
                                                  1, 1), (1,) * 5)
        nrows = min(plan.rows, ah.base - h0)
        for dt, ut in at.classes[0]:
            if dt not in slots:
                continue
            for dh, uh in ah.classes[0]:
                for dw, uw in aw.classes[0]:
                    k = _tap_index(kernel, ut, uh, uw)
                    for r in range(nrows):
                        for o in range(ncols):
                            partial[block, k, c0:c0 + S] += (
                                slots[dt][r * ah.step + dh, o * aw.step + dw]
                                * g_tile[r, o])

    gen_walk(x, plan, visit)
    dk = x.new_zeros(partial.shape[1:])
    for block in range(plan.grid):
        dk += partial[block]
    return dk.t().reshape(C, 1, *kernel)


# (shape, kernel, stride, head_dim) of the widened K2: head widths 64 and
# 128, a (3, 5, 5) kernel, strides that differ between H and W, T stride 2
GEN_POOL = [((2, 3, 9, 11, 128), (3, 3, 3), (1, 1, 1), 64),
            ((2, 3, 9, 11, 128), (3, 3, 3), (1, 2, 2), 128),
            ((1, 4, 10, 9, 128), (3, 5, 5), (1, 2, 1), 64),
            ((1, 5, 9, 10, 128), (3, 3, 3), (2, 2, 2), 128),
            ((1, 5, 8, 9, 192), (1, 5, 3), (2, 1, 3), 96),
            ((1, 2, 17, 13, 128), (3, 5, 5), (1, 4, 4), None),
            ((2, 1, 19, 17, 64), (3, 3, 5), (1, 8, 8), None),
            # the widths past 64, 96 and 128: the LN over one head of 32,
            # 48 or 72 channels (q and k|v pools), bare mode at C = 32 and
            # 144 (slabs 32 and 72)
            ((2, 3, 9, 11, 32), (3, 3, 3), (1, 2, 2), 32),
            ((1, 3, 9, 10, 64), (3, 3, 3), (1, 1, 1), 32),
            ((2, 3, 9, 11, 96), (3, 3, 3), (1, 2, 2), 48),
            ((1, 3, 10, 9, 192), (3, 3, 3), (1, 4, 4), 48),
            ((2, 3, 9, 11, 144), (3, 3, 3), (1, 2, 2), 72),
            ((1, 3, 17, 13, 288), (3, 3, 3), (1, 8, 8), 72),
            ((2, 3, 9, 11, 32), (3, 3, 3), (1, 1, 1), None),
            ((1, 3, 9, 11, 144), (3, 3, 3), (1, 4, 4), None)]


@pytest.mark.parametrize("shape,kernel,stride,hd", GEN_POOL)
def test_emulated_general_pool_matches_the_twin(shape, kernel, stride, hd):
    """The general K2 instance, emulated in f32, against pool_ln_reference
    (with ``hd``) or depthwise_conv_reference; each output written once."""
    x, w, ls, lb, _ = _inputs(shape, kernel, stride)
    plan = tp.pool_plan(shape, kernel, stride, "pool", head_dim=hd, sms=2)
    assert plan.route == "gen" and plan.slab == (hd or plan.slab)
    _check_gen_plan(plan)
    got, writes = emulate_gen(x, w, ls, lb, plan, hd is not None)
    assert bool((writes == 1).all())
    want = (tp.pool_ln_reference(x, w, ls, lb, stride, hd) if hd
            else tp.depthwise_conv_reference(x, w, stride))
    _close(got, want)


def _check_gen_plan(plan):
    assert plan.smem <= tp.SMEM_BLOCK_MAX and plan.per_sm >= 1
    assert all(1 <= d <= 256 for d in plan.box), plan
    assert plan.box[0] * 2 % 16 == 0
    assert plan.ring >= max(plan.axes[0].span, 2)
    assert 1 <= plan.grid <= plan.items == math.prod(plan.tiles)
    assert plan.threads <= (224 if plan.kind == "dk" else 160)
    # every tap in one class of each axis
    for a in plan.axes:
        taps = sorted(u for c in a.classes for _, u in c)
        assert taps == sorted(set(taps))


# K6 at the main path's strides and others, on ragged grids; stride 1 of a
# (1|3, 3, 3) kernel on 96-channel slabs is the tuned K2 bare loop
DX_CASES = [((2, 3, 13, 17, 192), (3, 3, 3), (1, 2, 2)),
            ((2, 2, 17, 19, 96), (3, 3, 3), (1, 4, 4)),
            ((1, 2, 19, 23, 96), (3, 3, 3), (1, 8, 8)),
            ((2, 1, 9, 10, 96), (3, 3, 3), (1, 2, 2)),
            ((1, 5, 9, 10, 128), (3, 5, 5), (2, 2, 1)),
            ((1, 4, 8, 9, 64), (1, 3, 5), (2, 3, 2)),
            ((1, 3, 9, 8, 128), (3, 5, 3), (1, 1, 1)),
            ((2, 3, 13, 11, 32), (3, 3, 3), (1, 2, 2)),
            ((1, 3, 17, 19, 144), (3, 3, 3), (1, 4, 4)),
            ((1, 3, 9, 10, 144), (3, 3, 3), (1, 1, 1))]


@pytest.mark.parametrize("shape,kernel,stride", DX_CASES)
def test_emulated_dx_matches_the_twin(shape, kernel, stride):
    """K6's parity classes by the plan, emulated in f32, against
    depthwise_conv_dx_reference (JAX ``_pdc_bwd``'s zero-stuffed, flipped
    conv); every dx position written once, the empty classes as zeros."""
    x, w, _, _, g = _inputs(shape, kernel, stride)
    plan = tp.pool_plan(shape, kernel, stride, "dx", sms=2)
    assert plan.route == "gen"
    _check_gen_plan(plan)
    got, writes = emulate_gen(g, w, None, None, plan, False)
    assert bool((writes == 1).all())
    _close(got, tp.depthwise_conv_dx_reference(g, w, stride, shape))


def test_dx_at_stride_one_is_the_flipped_bare_conv():
    """The tuned route of K6: K2's bare loop on the flipped filter over g
    (emulated with K2's plan) is dx."""
    shape, stride = (2, 3, 13, 17, 192), (1, 1, 1)
    assert tp.pool_plan(shape, (3, 3, 3), stride, "dx").route == "tuned"
    _, w, _, _, g = _inputs(shape, (3, 3, 3), stride)
    got, writes = emulate_pool(g, w.flip(2, 3, 4), None, None, stride, False)
    assert bool((writes == 1).all())
    _close(got, tp.depthwise_conv_dx_reference(g, w, stride, shape))


def test_dx_parity_classes_at_the_main_strides():
    """At k = 3: stride 2 has classes of 1 and 2 taps (1, 2, 2, 4 in H x
    W); at strides 4 and 8 the classes that touch no tap are empty."""
    for s, sizes in ((2, [1, 2]), (4, [1, 1, 0, 1]),
                     (8, [1, 1, 0, 0, 0, 0, 0, 1])):
        a = tp.conv_axis(56, 3, s, "dx")
        assert [len(c) for c in a.classes] == sizes
        assert (a.step, a.span, a.out_step, a.base) == (1, 2, s, 56 // s)


GEN_DK = [((2, 3, 9, 11, 128), (3, 5, 5), (1, 2, 2)),
          ((1, 3, 13, 10, 64), (3, 3, 3), (1, 1, 1)),
          ((1, 2, 17, 19, 128), (1, 5, 5), (1, 4, 4)),
          ((2, 3, 9, 11, 32), (3, 3, 3), (1, 2, 2)),
          ((1, 3, 17, 13, 144), (3, 3, 3), (1, 8, 8)),
          ((1, 3, 9, 10, 144), (3, 3, 3), (1, 1, 1))]


@pytest.mark.parametrize("shape,kernel,stride", GEN_DK)
def test_emulated_general_dk_matches_the_twin(shape, kernel, stride):
    """The general K7 instance's groups of taps and partials, emulated in
    f32, against depthwise_conv_dk_reference."""
    x, _, _, _, g = _inputs(shape, kernel, stride)
    _close(emulate_gen_dk(x, g, kernel, stride),
           tp.depthwise_conv_dk_reference(x, g, kernel, stride))


@pytest.mark.parametrize("C,hd,slab", [(32, None, 32), (144, None, 72),
                                       (48, None, 48), (40, None, 40),
                                       (288, 72, 72), (96, 48, 48),
                                       (64, 32, 32), (256, 128, 128)])
def test_general_slab_and_lanes(C, hd, slab):
    """The general instance's slab: the head with the LN, else 96, 128 or
    64 where one divides C, else the widest multiple of 8 up to 128 that
    does.  ``csrc/pool.cu:halo_gen_kernel<NP>`` (NP = 1 up to 64 channels,
    2 up to 128): lane l holds the pairs 64 i + 2 l, + 1 for i < NP that
    lie in the slab, so its lanes hold each channel once; K7's groups take
    S / 2 threads, one pair each, within its 224 threads."""
    kernel, stride = (3, 3, 5), (1, 2, 2)     # no tuned instance
    plan = tp.pool_plan((1, 3, 9, 11, C), kernel, stride, head_dim=hd)
    assert (plan.route, plan.slab) == ("gen", slab if hd is None else hd)
    S = plan.slab
    NP = 1 if S <= 64 else 2
    held = [64 * i + 2 * lane + e for i in range(NP) for lane in range(32)
            for e in (0, 1) if 64 * i + 2 * lane < S]
    assert sorted(held) == list(range(S))
    dk = tp.pool_plan((1, 3, 9, 11, C), (3, 3, 3), (1, 2, 2), "dk")
    if dk.route == "gen":
        assert dk.threads - 32 >= dk.slab // 2 and dk.threads <= 224
