"""K3's forward (``csrc/pool.cu:pool_max_kernel``; pure Python, no card).

The main path's forward calls: three skip pools a forward, kernel (1, 3,
3) at stride (1, 2, 2), the serving instance three times a forward and the
argmax instance six times a train step.  Then an emulation of the gather's
arithmetic on CPU tensors, held bit for bit against the plain twins
(``pool_max_reference``, ``pool_max_argmax_reference``): each output
cell's window clipped to the grid before its loops, the argmax begun at
the first tap inside it, the taps walked in (t, h, w) scan order and
folded by the kernel's select on bf16 bits (take where the tap is greater
or NaN and the maximum so far is not NaN; no conversion back).  Grids:
random, three-level (ties in most windows), all-negative (the border
windows must never see a zero), NaN-bearing and -inf-bearing (some windows
all -inf), at the skip pool on even and odd grids and at other kernels and
strides.  The kernel's NaN is its winning tap's own bits (every NaN here is
torch's, 0x7fc0); the plain twin on the CPU does not keep a NaN's bits on
every path, so against it a NaN is compared by position."""

import os

import numpy as np
import pytest
import torch

from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models.svit import SViTArch
from svit_tpu_torch.ops import pool as tp
from svit_tpu_torch.ops.pooling import out_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP = ((1, 3, 3), (1, 2, 2))
GRIDS = ["random", "three", "negative", "nan", "-inf"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread for this file's small tensors, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def forward_calls():
    """(x shape, with the argmax) of every K3 forward call on the main
    path: the serving forward (batch 8, 8 latent frames), the train step's
    video and image forwards (batch 8, with the argmax) and its no-grad
    consistency forward (128 frames, one each)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    arch = SViTArch.from_cfg(cfg)
    calls = []
    for B, frames, with_arg in ((8, arch.patch_dims[0], False),
                                (8, arch.patch_dims[0], True),
                                (8, 1, True), (128, 1, False)):
        size = (frames, *arch.patch_dims[1:])
        for s in arch.blocks:
            if int(np.prod(s.stride_q)) > 1:
                kernel = tuple(k + 1 if k > 1 else k for k in s.stride_q)
                assert (kernel, tuple(s.stride_q)) == SKIP
                calls.append(((B, *size, s.dim_out), with_arg))
            size = tuple(out_size(d, k, st) for d, k, st in
                         zip(size, s.kernel_q, s.stride_q))
    return calls


def test_the_forward_calls_are_the_main_path_s():
    """Three skip pools a forward: the serving instance three times a
    forward, the argmax instance six times a step."""
    calls = forward_calls()
    assert [c for c in calls if not c[1]][:3] == [
        ((8, 8, 56, 56, 192), False), ((8, 8, 28, 28, 384), False),
        ((8, 8, 14, 14, 768), False)]
    assert sorted(s for s, a in calls if a) == sorted(
        [(8, 8, 56, 56, 192), (8, 8, 28, 28, 384), (8, 8, 14, 14, 768),
         (8, 1, 56, 56, 192), (8, 1, 28, 28, 384), (8, 1, 14, 14, 768)])


def make_grid(shape, grid, seed=7):
    """A bf16 grid: random, three levels, all negative, with NaN, or with
    -inf (the first windows all -inf)."""
    rs = np.random.RandomState(seed)
    if grid == "three":
        x = rs.randint(0, 3, shape).astype(np.float32)
    else:
        x = rs.randn(*shape).astype(np.float32)
    if grid == "negative":
        x = -0.5 - np.abs(x)
    elif grid == "-inf":
        x[rs.rand(*shape) < 0.3] = -np.inf
        x[:, :, :3, :3] = -np.inf
    x = torch.from_numpy(x).to(torch.bfloat16)
    if grid == "nan":    # torch's NaN bits, whatever the conversion gives
        x.view(torch.int16)[torch.from_numpy(rs.rand(*shape) < 0.05)] = 0x7fc0
    return x


def canon(t):
    """bf16 bits, every NaN as 0x7fc0."""
    return torch.where(t.isnan(), torch.tensor(0x7fc0, dtype=torch.int16),
                       t.view(torch.int16))


def emulate(x, kernel, stride):
    """The gather's arithmetic, all output cells at once: per axis, each
    output index's window start s o - k // 2 and its cells inside the grid
    [max(start, 0), min(start + k, size)); the argmax begun at the first of
    them; the taps walked in scan order, each inside all three ranges
    folded in."""
    B, T, H, W, C = x.shape
    axes = []
    for d, k, s in zip((T, H, W), kernel, stride):
        start = torch.arange(out_size(d, k, s)) * s - k // 2
        axes.append((start, start.clamp(min=0) - start,
                     torch.minimum(start + k, torch.tensor(d)) - start))
    (t0, ta, tb), (h0, ha, hb), (w0, wa, wb) = axes
    kT, kH, kW = kernel
    view = lambda v, a: v.view([-1 if i == a else 1 for i in range(3)])
    first = ((view(ta, 0) * kH + view(ha, 1)) * kW + view(wa, 2))
    To, Ho, Wo = len(t0), len(h0), len(w0)
    mx = torch.full((B, To, Ho, Wo, C), float("-inf"), dtype=x.dtype)
    am = first.to(torch.uint8)[None, ..., None].expand(mx.shape).clone()
    for dt in range(kT):
        for dh in range(kH):
            for dw in range(kW):
                ok = ((view((ta <= dt) & (dt < tb), 0)
                       & view((ha <= dh) & (dh < hb), 1)
                       & view((wa <= dw) & (dw < wb), 2))[None, ..., None])
                v = x[:, (t0 + dt).clamp(0, T - 1)][
                    :, :, (h0 + dh).clamp(0, H - 1)][
                    :, :, :, (w0 + dw).clamp(0, W - 1)]
                vf, mf = v.float(), mx.float()
                take = ok & ~(vf <= mf) & (mf == mf)
                mx = torch.where(take, v, mx)
                am = torch.where(take, torch.tensor((dt * kH + dh) * kW + dw,
                                                    dtype=torch.uint8), am)
    return mx, am


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("shape,kernel,stride", [
    ((2, 2, 14, 14, 96), *SKIP),
    ((1, 2, 57, 55, 16), *SKIP),
    ((2, 1, 9, 11, 8), *SKIP),
    ((1, 1, 2, 1, 8), *SKIP),
    ((2, 4, 7, 9, 8), (3, 3, 3), (1, 2, 2)),
    ((2, 5, 9, 11, 16), (3, 3, 3), (2, 2, 2)),
    ((1, 2, 9, 9, 8), (1, 5, 5), (1, 4, 4)),
])
def test_emulated_gather_equals_the_twins(shape, kernel, stride, grid):
    """Bit for bit against the plain twins: the output's bf16 bits (NaN by
    position, its bits the input's) and the argmax bytes; the wrapper on a
    CPU tensor is the twin."""
    x = make_grid(shape, grid)
    got, got_arg = emulate(x, kernel, stride)
    want = tp.pool_max_reference(x, kernel, stride)
    want_arg = tp.pool_max_argmax_reference(x, kernel, stride)
    assert torch.equal(canon(got), canon(want))
    assert torch.equal(got.view(torch.int16), canon(got))
    assert torch.equal(got_arg, want_arg)
    if grid == "nan":
        assert want.isnan().any()
    out, arg = tp._pool_max(x, kernel, stride, with_arg=True)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    assert torch.equal(arg, want_arg)
