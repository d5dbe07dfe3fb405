"""LayerNorm-prologue GEMM: kernel K1 and its uses (counterpart of
``svit_tpu/ops/pallas_ffn.py``).

``ln_linear`` computes ``epilogue(prologue(x) @ w.T)`` in one launch of
``csrc/ln_linear.cu``:

- prologue: ``s = x (+ x_add)`` in the IO dtype; with ``ln`` the row is
  normalised in f32 (eps 1e-6) and rounded to the IO dtype before the
  product;
- epilogue: either ``acc + bias`` in f32, optionally exact GELU, then one
  rounding to the IO dtype; or (``round_then_bias``) the f32 product is
  rounded first and the bias added in the IO dtype, as the attention
  projection does; then optionally ``+ residual`` in the IO dtype; or
  (``out_f32``) the f32 product alone, unrounded: the partial of a
  tensor-parallel fc2, summed across ranks before its bias
  (``parallel/tensor.py``).

Weights keep the PyTorch ``[out, in]`` layout.  On a CPU tensor the wrapper
runs the plain version ``ln_linear_reference``; on a CUDA tensor it launches
the kernel or raises.  ``ln_linear_plan`` picks the launch (path, rows per
block, consumer warpgroups, ring stages, blocks per row panel) from the
shapes alone.  A prologue past the resident panel (K > ``PANEL_K_MAX``:
MViTv2-L's last stage) runs as a pass of its own first (``ln_rows_kernel``,
counted as ``ln_linear_prologue``), which writes ``s`` and the LN'd rows
bit for bit as the panel forms them; the GEMM path then takes those rows.
The uses
below are the JAX package's fused kernels: ``fused_ln_qkv``,
``fused_ln_dense``, ``fused_ffn_residual`` (two launches: the hidden
activation goes through device memory) and its drop-path form
``fused_ffn_residual_masked``, which scales ``a`` by ``mask_add / keep`` in
the prologue and the output by ``mask_out / keep`` before the residual, each
op rounded to the IO dtype, and ``fused_ffn`` (two launches, no residual).
Each use is differentiable.  Its backward recomputes from the saved inputs,
as the JAX package's custom VJPs do (``jax.vjp`` of ``_ffn_reference`` and
its siblings): the sum ``x + x_add`` with its drop-path scaling, the LN
statistics in f32 and ``xn`` rounded to the IO dtype; then every product
(the recomputed forward product where a GELU needs it, dX = g W and dW =
g^T xn) takes its operands in the IO dtype, the cotangent rounded to it
once, and accumulates in f32 (``_mm``): bf16 GEMMs on the tensor cores on
the card, as the reference's dots take ``xn.astype(w.dtype)`` with
``preferred_element_type=f32``.  The GELU, LN and drop-path backward are
elementwise torch ops in the reference's op order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from svit_tpu_torch.ops import _lib
from svit_tpu_torch.ops.vjp import kernel_vjp

EPS = 1e-6

_BIAS_NONE, _BIAS_F32, _BIAS_IO = 0, 1, 2


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """Last-axis LN computed in f32, returned in ``x``'s dtype (eps 1e-6,
    not torch's default 1e-5)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _split(y: torch.Tensor, split: Optional[int]):
    if split is None:
        return y
    return y[..., :split].contiguous(), y[..., split:].contiguous()


def drop_path_scale(t, mask, keep: float, rows: int = 1):
    """``t / keep * mask`` in ``t``'s dtype, op by op (JAX's IO-dtype ops
    with the python ``keep`` weakly typed, so rounded to that dtype first).
    ``t`` is [B * rows, ...] and ``mask`` [B] 0/1, one entry per sample."""
    kq = float(torch.tensor(keep, dtype=t.dtype))
    m = mask.to(t.dtype).view(-1, *([1] * t.dim()))
    return (t.view(m.shape[0], rows, *t.shape[1:]) / kq * m).view(t.shape)


# The kernel's tiles (csrc/ln_linear.cu): BN output columns per tile, K in
# TMA boxes of BK, and the card's shared memory.
BN, BK = 128, 64
PANEL_K_MAX = 1024          # K of the resident LN panel (64 rows of it)
SMEM_BLOCK = 232448         # dynamic shared memory one block may use
SMEM_SM = 233472            # shared memory of one SM
SMEM_RESERVED = 1024        # what the system keeps per block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ln_linear_smem(bm: int, panel: bool, kc: int, stages: int,
                   ncw: int) -> int:
    """Dynamic shared memory of one block, as ``csrc/ln_linear.cu:Layout``
    lays it out: the panel (``bm`` rows by ``kc`` chunks of 64 bf16), the
    ring (a W tile, plus an A tile without a panel), per consumer warpgroup
    the bf16 output tile (four 64 x 32 sub-tiles) and the tile's bias, the
    LN weight and bias (panel) and the mbarriers (full and empty per
    slot)."""
    slot = BN * 128 + (0 if panel else bm * 128)
    return ((bm * kc * 128 + kc * BK * 8 if panel else 0) + stages * slot
            + ncw * (BN * 128 + BN * 4) + 8 * (2 * stages + 3))


@dataclasses.dataclass(frozen=True)
class Plan:
    panel: bool          # the LN / x_add prologue on a resident row panel
    bm: int              # rows per block
    ncw: int             # consumer warpgroups (plus one producer warp)
    stages: int          # TMA ring slots
    splits: int          # blocks sharing one row panel's N sweep
    tiles_per_split: int
    m_tiles: int
    n_tiles: int
    smem: int            # dynamic shared memory per block, bytes
    blocks_per_sm: int   # what the shared memory and registers admit
    rows_pass: Optional["RowsPass"] = None   # the prologue's own pass first

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.splits


@dataclasses.dataclass(frozen=True)
class RowsPass:
    """K1's prologue pass (``csrc/ln_linear.cu:ln_rows_kernel``): the
    panel's partial sums a row (``parts``, in the panel's order), rows a
    block (``rows``: ``parts * rows`` threads) and its shared memory."""
    parts: int
    rows: int
    smem: int


PASS_PARTS = 4      # a row's partial sums where no panel takes the K


def rows_pass_smem(K: int, rows: int, parts: int) -> int:
    """Shared memory of a prologue-pass block, as ``csrc/ln_linear.cu:
    rows_smem`` counts it: the staged rows (each an odd number of 16-byte
    units), the partial sums and each row's mean and rstd in f32."""
    units = K // 8
    return rows * 16 * (units if units % 2 else units + 1) + 4 * (
        parts * rows + 2 * rows)


def rows_pass_plan(M: int, N: int, K: int, split: Optional[int] = None,
                   sms: int = 132) -> RowsPass:
    """The prologue pass of an ``[M, K]`` LN or ``x_add`` prologue: the
    sums in the order of the panel that ``ln_linear_plan`` would launch at
    this K (``ncw * 128 / bm`` parts a row), or ``PASS_PARTS`` past it;
    ``128 / parts`` rows a block, halved while they do not fit."""
    kc = _cdiv(K, BK)
    if kc * BK <= PANEL_K_MAX:
        panel = ln_linear_plan(M, N, K, prologue=True, split=split, sms=sms)
        parts = panel.ncw * 128 // panel.bm
    else:
        parts = PASS_PARTS
    rows = 128 // parts
    while rows > 1 and rows_pass_smem(K, rows, parts) > SMEM_BLOCK:
        rows //= 2
    smem = rows_pass_smem(K, rows, parts)
    if smem > SMEM_BLOCK:
        raise ValueError(f"ln_linear's prologue pass: a row of K={K} does "
                         f"not fit shared memory")
    return RowsPass(parts, rows, smem)


# the most blocks an SM holds by their registers (launch bounds of
# csrc/ln_linear.cu: 160 threads for one consumer warpgroup, three blocks;
# 288 for two, one block)
BLOCKS_BY_REGS = {1: 3, 2: 1}
STAGES_MAX = 6


@functools.lru_cache(maxsize=None)
def ln_linear_plan(M: int, N: int, K: int, *, prologue: bool,
                   split: Optional[int] = None, sms: int = 132,
                   force_pass: bool = False) -> Plan:
    """The launch of K1 for an ``[M, K] @ [N, K].T`` call.

    With a prologue (LN or ``x_add``) a block keeps ``bm`` rows of all of K
    resident (K up to ``PANEL_K_MAX``); without one, A streams with W.
    Past ``PANEL_K_MAX`` (or with ``force_pass``, to hold the two against
    each other) the prologue is a pass of its own (``rows_pass_plan``) and
    this is the streaming launch on its rows (``Plan.rows_pass``).
    The streaming GEMM and panels of K <= 192 take 64-row blocks of one
    consumer warpgroup, up to three an SM, so that one block's prologue and
    epilogue run under another's products.  Wider panels take one block an
    SM with two consumer warpgroups: on long sweeps (12 N tiles or more)
    64 rows whose two warpgroups take alternate N tiles ("ping", each with
    half of the ring), so that one's epilogue runs under the other's
    products; else 128 rows that share each W tile.  The ring then takes
    the most stages (up to ``STAGES_MAX``) that keep those blocks.  Where
    the row panels leave SMs idle, blocks split a panel's N tiles between
    them (each loads the panel): the fewest waves times (tiles per block +
    the panel's prologue, about kc / 2 tiles), at least two splits where
    panels are fewer than SMs."""
    if K % 8 or N % 8 or K <= 0 or N <= 0:
        raise ValueError(f"ln_linear needs K and N multiples of 8 (K={K}, N={N})")
    if split is not None and (split % 8 or not 0 < split <= N):
        raise ValueError(f"split {split} must be a multiple of 8 in (0, {N}]")
    kc = _cdiv(K, BK)
    if prologue and (force_pass or kc * BK > PANEL_K_MAX):
        return dataclasses.replace(
            ln_linear_plan(M, N, K, prologue=False, split=split, sms=sms),
            rows_pass=rows_pass_plan(M, N, K, split, sms))
    n_tiles = _cdiv(N, BN)

    def per_sm(bm, ncw, stages):   # blocks an SM holds
        fit = SMEM_SM // (ln_linear_smem(bm, prologue, kc, stages, ncw)
                          + SMEM_RESERVED)
        return min(fit, BLOCKS_BY_REGS[ncw])

    if not prologue or kc <= 3:
        ncw, bm = 1, 64
    elif (n_tiles < 12 or not per_sm(64, 2, 4)) and per_sm(128, 2, 2):
        ncw, bm = 2, 128
    elif per_sm(64, 2, 4):
        ncw, bm = 2, 64
    else:
        ncw, bm = 1, 64
    # ping (two warpgroups on alternate N tiles) halves the ring between
    # them: an even number of slots, two each at least
    depths = (range(4, STAGES_MAX + 1, 2) if (ncw, bm) == (2, 64)
              else range(2, STAGES_MAX + 1))
    blocks = per_sm(bm, ncw, depths[0])
    if blocks < 1:
        raise ValueError(f"ln_linear: K={K} does not fit shared memory")
    stages = max(s for s in depths if per_sm(bm, ncw, s) >= blocks)
    m_tiles = _cdiv(M, bm)
    if prologue:
        slots = blocks * sms
        pers = range(1, n_tiles if m_tiles < sms and n_tiles > 1
                     else n_tiles + 1)
        per = min(pers, key=lambda t: (
            _cdiv(m_tiles * _cdiv(n_tiles, t), slots) * (t + kc / 2), -t))
    else:
        per = 1
    return Plan(prologue, bm, ncw, stages, _cdiv(n_tiles, per), per, m_tiles,
                n_tiles, ln_linear_smem(bm, prologue, kc, stages, ncw), blocks)


@functools.lru_cache(maxsize=None)
def _round_bf16(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.bfloat16))


def ln_linear_reference(x, w, bias=None, *, ln=None, x_add=None, gelu=False,
                        round_then_bias=False, residual=None, split=None,
                        mask_add=None, mask_out=None, keep=1.0, rows=1,
                        out_f32=False):
    """Plain PyTorch twin of ``ln_linear`` with the kernel's rounding.

    x: [M, K]; w: [N, K]; bias: [N] (f32); ln: (weight, bias) of size K;
    x_add, residual: like x and like the output; mask_add, mask_out: [M /
    rows] per-sample 0/1 drop-path masks with keep probability ``keep``.
    Returns ``y`` ([M, N], or the pair ``y[:, :split], y[:, split:]``), and
    ``(y, s)`` when ``x_add`` is given, ``s = x + x_add``."""
    dt = x.dtype
    if x_add is not None and mask_add is not None:
        x_add = drop_path_scale(x_add, mask_add, keep, rows)
    s = x if x_add is None else x + x_add
    xn = s if ln is None else layer_norm(s, ln[0], ln[1])
    acc = xn.float() @ w.to(dt).float().t()
    if out_f32:
        _check_f32_out(ln, x_add, bias, gelu, round_then_bias, residual,
                       split, mask_out)
        return acc
    if round_then_bias:
        y = acc.to(dt)
        if bias is not None:
            y = y + bias.to(dt)
    else:
        if bias is not None:
            acc = acc + bias.float()
        if gelu:
            acc = F.gelu(acc)
        y = acc.to(dt)
    if mask_out is not None:
        y = drop_path_scale(y, mask_out, keep, rows)
    if residual is not None:
        y = y + residual
    y = _split(y, split)
    return y if x_add is None else (y, s)


def _check_f32_out(ln, x_add, bias, gelu, round_then_bias, residual, split,
                   mask_out):
    if (ln is not None or x_add is not None or bias is not None or gelu
            or round_then_bias or residual is not None or split is not None
            or mask_out is not None):
        raise ValueError("out_f32 takes the product alone: no LN, x_add, "
                         "bias, GELU, residual, split or output mask")


def ln_linear_mm(x, w, bias=None, *, ln=None, gelu=False,
                 round_then_bias=False):
    """``ln_linear_reference``'s arithmetic with the product on IO-dtype
    operands and an f32 sum (``_mm``), rounded once: the plain ops of the
    extras stream and of the options that the JAX package leaves to XLA
    (flax ``Dense(dtype=...)``: a bf16 dot with f32 accumulation).  No
    autograd of its own; ``dense`` and ``ffn`` differentiate it."""
    dt = x.dtype
    xn = x if ln is None else layer_norm(x, ln[0], ln[1])
    acc = _mm(xn, w.to(dt).t())
    if round_then_bias:
        y = acc.to(dt)
        return y if bias is None else y + bias.to(dt)
    if bias is not None:
        acc = acc + bias.float()
    return (F.gelu(acc) if gelu else acc).to(dt)


def ln_linear(x, w, bias=None, *, ln=None, x_add=None, gelu=False,
              round_then_bias=False, residual=None, split=None,
              mask_add=None, mask_out=None, keep=1.0, rows=1, out_f32=False,
              force_pass=False):
    """Kernel K1 (``csrc/ln_linear.cu``); same contract as
    ``ln_linear_reference``.  Takes bf16 activations and weights, f32 LN
    parameters and bias.  With ``ln`` or ``x_add`` past ``PANEL_K_MAX``
    (or with ``force_pass``) the prologue pass runs first (counted as
    ``ln_linear_prologue``).  A launch with a mask counts as
    ``ln_linear_masked``."""
    if x.device.type == "cpu":
        return ln_linear_reference(
            x, w, bias, ln=ln, x_add=x_add, gelu=gelu,
            round_then_bias=round_then_bias, residual=residual, split=split,
            mask_add=mask_add, mask_out=mask_out, keep=keep, rows=rows,
            out_f32=out_f32)
    if out_f32:
        _check_f32_out(ln, x_add, bias, gelu, round_then_bias, residual,
                       split, mask_out)
    if gelu and round_then_bias:
        raise ValueError("gelu applies before the rounding; "
                         "round_then_bias has none")
    M, K = x.shape
    N = w.shape[0]
    dt = torch.bfloat16
    _lib.check(x, "x", dt)
    _lib.check(w, "w", dt, (N, K), x.device)
    plan = ln_linear_plan(M, N, K, prologue=ln is not None or x_add is not None,
                          split=split, sms=_lib.sm_count(x.device),
                          force_pass=force_pass)
    if x_add is not None:
        _lib.check(x_add, "x_add", dt, (M, K), x.device)
    if residual is not None:
        _lib.check(residual, "residual", dt, (M, N), x.device)
    if bias is not None:
        _lib.check(bias, "bias", torch.float32, (N,), x.device)
    if ln is not None:
        _lib.check(ln[0], "ln weight", torch.float32, (K,), x.device)
        _lib.check(ln[1], "ln bias", torch.float32, (K,), x.device)
    n_split = N if split is None else int(split)
    f32 = (torch.empty((M, N), dtype=torch.float32, device=x.device)
           if out_f32 else None)
    out0 = (torch.empty((M, n_split), dtype=dt, device=x.device)
            if f32 is None else None)
    out1 = (torch.empty((M, N - n_split), dtype=dt, device=x.device)
            if n_split < N else None)
    s = s_ret = torch.empty_like(x) if x_add is not None else None
    masks = [m for m in (mask_add, mask_out) if m is not None]
    if mask_add is not None and x_add is None:
        raise ValueError("mask_add scales x_add, which is missing")
    for m in masks:
        if M % rows:
            raise ValueError(f"{M} rows are not whole samples of {rows}")
        _lib.check(m, "mask", torch.float32, (M // rows,), x.device)
    mode = (_BIAS_NONE if bias is None
            else _BIAS_IO if round_then_bias else _BIAS_F32)
    counter = "ln_linear_masked" if masks else "ln_linear"
    if plan.rows_pass is not None:   # the prologue's rows, then the GEMM
        xn = (torch.empty_like(x) if ln is not None else None)
        if M:
            rp = plan.rows_pass
            _lib.launch(
                "svit_ln_rows", "ln_linear_prologue", _lib.ptr(x),
                _lib.ptr(x_add), _lib.ptr(mask_add), _round_bf16(keep),
                int(rows), _lib.ptr(ln[0]) if ln else None,
                _lib.ptr(ln[1]) if ln else None, EPS, _lib.ptr(s),
                _lib.ptr(xn), M, K, rp.parts, rp.rows, rp.smem,
                _lib.stream())
        x = xn if xn is not None else s
        ln = x_add = s = mask_add = None
    if M:
        _lib.launch(
            "svit_ln_linear", counter,
            _lib.ptr(x), _lib.ptr(x_add), _lib.ptr(s),
            _lib.ptr(ln[0]) if ln else None, _lib.ptr(ln[1]) if ln else None,
            EPS, _lib.ptr(w), _lib.ptr(bias), mode, int(gelu),
            _lib.ptr(residual), _lib.ptr(out0), _lib.ptr(out1),
            _lib.ptr(f32), n_split, M, N, K, _lib.ptr(mask_add),
            _lib.ptr(mask_out),
            _round_bf16(keep), int(rows),
            plan.bm, plan.ncw, plan.stages, plan.splits, _lib.stream())
    y = f32 if out_f32 else out0 if split is None else (out0, out1)
    return y if s_ret is None else (y, s_ret)


# ---------------------------------------------------------------------------
# The JAX package's fused kernels as uses of K1, each with its plain twin.
# Activations are [B, N, C]; weights [out, in] in the IO dtype; LN params and
# biases f32.
# ---------------------------------------------------------------------------

def _flat(x):
    return x.reshape(-1, x.shape[-1])


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the operands in their (IO) dtype and the sum in f32,
    returned in f32: on the card cuBLAS's GEMM with an f32 output (bf16 on
    the tensor cores), on the CPU the f32 product of the same values."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _dense_bwd(xn, w, gacc, want_w=True):
    """Gradients of ``acc = xn @ w.T`` (f32 sum of IO-dtype operands) from
    the f32 cotangent ``gacc`` [M, N]: (dxn, dw) in the IO dtype, the
    cotangent rounded to it once before both products."""
    gd = gacc.to(xn.dtype)
    dxn = _mm(gd, w).to(xn.dtype)
    dw = _mm(gd.t(), xn).to(w.dtype) if want_w else None
    return dxn, dw


def _prologue(x, x_add=None, ln=None, mask_add=None, keep=1.0, rows=1):
    """Recompute ``s = x (+ x_add / keep * mask)`` and ``xn = LN(s)`` (or s)
    under autograd from detached leaves; returns (leaves, s, xn) with
    leaves (x, x_add, ln weight, ln bias), None where absent."""
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in (x, x_add, *(ln or (None, None)))]
    lx, la, lw, lb = leaves
    with torch.enable_grad():
        if la is not None and mask_add is not None:
            la_s = drop_path_scale(la, mask_add, keep, rows)
        else:
            la_s = la
        s = lx if la is None else lx + la_s
        xn = s if ln is None else layer_norm(s, lw, lb)
    return leaves, s, xn


def _prologue_grads(leaves, outs, grads, wanted):
    """The prologue's gradients: ``outs`` (xn, and s where it is also an
    output) against ``grads``, for the ``wanted`` leaves."""
    take = [t for t, w in zip(leaves, wanted) if t is not None and w]
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    got = iter(torch.autograd.grad([o for o, _ in pairs], take,
                                   [g for _, g in pairs], allow_unused=True)
               if take else ())
    return [next(got) if t is not None and w else None
            for t, w in zip(leaves, wanted)]


def _gelu_bwd(dh, z):
    """d gelu(z) (exact erf) times the cotangent ``dh``, in f32."""
    return torch.ops.aten.gelu_backward(dh.float(), z)


def _ln_dense_vjp(tensors, static, grads, wanted):
    """Backward of ``fused_ln_qkv`` (split output) and ``fused_ln_dense``:
    LN, then ``xn @ w.T + b`` (f32) rounded."""
    x, ln_w, ln_b, w, b = tensors
    split = static[0]
    leaves, _, xn = _prologue(_flat(x), ln=(ln_w, ln_b))
    if split is None:
        gy = _flat(grads[0])
    else:
        M, N = xn.shape[0], w.shape[0]
        gy = torch.cat([xn.new_zeros(M, n) if g is None else _flat(g)
                        for g, n in zip(grads, (split, N - split))], dim=-1)
    gacc = gy.float()
    dxn, dw = _dense_bwd(xn.detach(), w, gacc, wanted[3])
    gx, _, glw, glb = _prologue_grads(leaves, [xn], [dxn],
                                      [wanted[0], False, *wanted[1:3]])
    db = gacc.sum(0) if b is not None and wanted[4] else None
    return [None if gx is None else gx.view(x.shape), glw, glb, dw, db]


def _ffn_vjp(residual):
    """Backward of ``fused_ffn_residual(_masked)`` (``residual``) and
    ``fused_ffn``: the prologue, ``z = xn @ w1.T + b1`` recomputed (f32),
    ``h = gelu(z)`` rounded, ``y = h @ w2.T + b2`` rounded (drop-path
    scaled, plus the residual s)."""
    def backward(tensors, static, grads, wanted):
        if residual:
            x_res, a, ln_w, ln_b, w1, b1, w2, b2, *masks = tensors
            ma, my = masks if masks else (None, None)
            keep = static[0] if masks else 1.0
            rows = x_res[0].numel() // x_res.shape[-1]
            leaves, s, xn = _prologue(_flat(x_res), _flat(a), (ln_w, ln_b),
                                      ma, keep, rows)
            want_pro = wanted[:4]
            wb = wanted[4:8]
        else:
            x, ln_w, ln_b, w1, b1, w2, b2 = tensors
            my, keep, rows = None, 1.0, 1
            leaves, s, xn = _prologue(_flat(x), ln=(ln_w, ln_b))
            want_pro = [wanted[0], False, wanted[1], wanted[2]]
            wb = wanted[3:7]
        xd = xn.detach()
        z = _mm(xd, w1.t()) + b1.float()
        h = torch.nn.functional.gelu(z).to(xd.dtype)
        g = _flat(grads[0])
        gy = g if my is None else drop_path_scale(g, my, keep, rows)
        gacc2 = gy.float()
        dh, dw2 = _dense_bwd(h, w2, gacc2, wb[2])
        dz = _gelu_bwd(dh, z)
        dxn, dw1 = _dense_bwd(xd, w1, dz, wb[0])
        outs, cots = ([xn, s], [dxn, g]) if residual else ([xn], [dxn])
        gp = _prologue_grads(leaves, outs, cots, want_pro)
        db1 = dz.sum(0) if wb[1] else None
        db2 = gacc2.sum(0) if wb[3] else None
        lead = (x_res if residual else x).shape
        gp = [None if t is None else t.view(lead) if i < 2 else t
              for i, t in enumerate(gp)]
        if residual:
            return [gp[0], gp[1], gp[2], gp[3], dw1, db1, dw2, db2,
                    *[None] * (len(tensors) - 8)]
        return [gp[0], gp[2], gp[3], dw1, db1, dw2, db2]
    return backward


def _dense_vjp(tensors, static, grads, wanted):
    """Backward of ``dense``: the LN (if any) recomputed, then the product's
    gradients on IO-dtype operands (``_dense_bwd``); the bias gradient summed
    in the IO dtype, in which the bias was added."""
    x, ln_w, ln_b, w, b = tensors
    ln = None if ln_w is None else (ln_w, ln_b)
    leaves, _, xn = _prologue(_flat(x), ln=ln)
    gy = _flat(grads[0])
    dxn, dw = _dense_bwd(xn.detach(), w, gy.float(), wanted[3])
    gx, _, glw, glb = _prologue_grads(leaves, [xn], [dxn],
                                      [wanted[0], False, *wanted[1:3]])
    db = gy.sum(0).to(b.dtype) if b is not None and wanted[4] else None
    return [None if gx is None else gx.view(x.shape), glw, glb, dw, db]


def dense(x, w, b=None, ln=None):
    """A dense layer on a stream of any rank in plain PyTorch with the
    products on IO-dtype operands (``ln_linear_mm``): ``x`` [..., K] (LN'd
    first with ``ln``), ``w`` [N, K] cast to ``x``'s dtype.  The product is
    rounded and the bias added in the IO dtype (flax ``Dense(dtype=...)``).
    Differentiable with the same operand types."""
    ln_w, ln_b = ln if ln is not None else (None, None)
    return kernel_vjp(
        lambda x, lw, lb, w, b: ln_linear_mm(
            _flat(x), w, b, ln=None if lw is None else (lw, lb),
            round_then_bias=True).view(*x.shape[:-1], w.shape[0]),
        _dense_vjp, (x, ln_w, ln_b, w.to(x.dtype), b))


def ffn(x, ln_w, ln_b, w1, b1, w2, b2):
    """LN + MLP without residual in plain PyTorch (the extras' FFN, JAX
    ``ffn_reference``): ``ffn_reference``'s rounding with the products on
    IO-dtype operands; its backward is ``fused_ffn``'s."""
    return kernel_vjp(lambda *t: _ffn(ln_linear_mm, *t), _ffn_vjp(False),
                      (x, ln_w, ln_b, w1, b1, w2, b2))


def _proj_vjp(tensors, static, grads, wanted):
    """Backward of ``linear_proj``: ``xn @ w.T`` rounded, ``+ b`` in the IO
    dtype."""
    x, w, b = tensors
    gy = _flat(grads[0])
    dx, dw = _dense_bwd(_flat(x), w, gy.float(), wanted[1])
    db = gy.sum(0).to(b.dtype) if wanted[2] else None
    return [dx.view(x.shape), dw, db]


def _fused_ln_qkv(op, x, ln_w, ln_b, w_qkv, b_qkv, dim_out
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    q, kv = op(_flat(x), w_qkv, b_qkv, ln=(ln_w, ln_b), split=dim_out)
    lead = x.shape[:-1]
    return q.view(*lead, dim_out), kv.view(*lead, 2 * dim_out)


def ln_qkv_reference(x, ln_w, ln_b, w_qkv, b_qkv, dim_out):
    return _fused_ln_qkv(ln_linear_reference, x, ln_w, ln_b, w_qkv, b_qkv,
                         dim_out)


def fused_ln_qkv(x, ln_w, ln_b, w_qkv, b_qkv, dim_out):
    """norm1 + the q and k|v projections in one launch over ``[Wq | Wkv]``:
    x is read once, q and kv are written as two outputs."""
    return kernel_vjp(lambda *a: _fused_ln_qkv(ln_linear, *a), _ln_dense_vjp,
                      (x, ln_w, ln_b, w_qkv, b_qkv), dim_out)


def ln_dense_reference(x, ln_w, ln_b, w, b):
    return ln_linear_reference(_flat(x), w, b, ln=(ln_w, ln_b)).view(
        *x.shape[:-1], w.shape[0])


def _ln_dense(x, ln_w, ln_b, w, b):
    return ln_linear(_flat(x), w, b, ln=(ln_w, ln_b)).view(
        *x.shape[:-1], w.shape[0])


def fused_ln_dense(x, ln_w, ln_b, w, b):
    """LN + one dense layer (bias added in f32, then rounded)."""
    return kernel_vjp(lambda *a: _ln_dense(*a[:5]), _ln_dense_vjp,
                      (x, ln_w, ln_b, w, b), None)


def _fused_ffn_residual(op, x_res, a, ln_w, ln_b, w1, b1, w2, b2,
                        ma=None, my=None, keep=1.0):
    rows = x_res[0].numel() // x_res.shape[-1]
    h, s = op(_flat(x_res), w1, b1, ln=(ln_w, ln_b), x_add=_flat(a),
              gelu=True, mask_add=ma, keep=keep, rows=rows)
    return op(h, w2, b2, residual=s, mask_out=my, keep=keep,
              rows=rows).view(*x_res.shape[:-1], w2.shape[0])


def ffn_residual_reference(x_res, a, ln_w, ln_b, w1, b1, w2, b2):
    return _fused_ffn_residual(ln_linear_reference, x_res, a, ln_w, ln_b,
                               w1, b1, w2, b2)


def fused_ffn_residual(x_res, a, ln_w, ln_b, w1, b1, w2, b2):
    """The block's residual tail ``x = x_res + a; out = x + mlp(ln2(x))`` as
    two K1 launches: (x_res + a) -> LN -> fc1 + b1 -> GELU writes h and x;
    then h @ W2 + b2 is rounded and x added in the IO dtype."""
    return kernel_vjp(
        lambda *t: _fused_ffn_residual(ln_linear, *t), _ffn_vjp(True),
        (x_res, a, ln_w, ln_b, w1, b1, w2, b2))


def ffn_residual_masked_reference(keep, x_res, a, ln_w, ln_b, w1, b1, w2, b2,
                                  ma, my):
    """Plain twin of ``fused_ffn_residual_masked`` (JAX
    ``_ffn_res_reference_masked``): ``x = x_res + a / keep * ma; out = x +
    mlp(ln2(x)) / keep * my``, every op in the IO dtype."""
    return _fused_ffn_residual(ln_linear_reference, x_res, a, ln_w, ln_b,
                               w1, b1, w2, b2, ma, my, keep)


def fused_ffn_residual_masked(keep, x_res, a, ln_w, ln_b, w1, b1, w2, b2,
                              ma, my):
    """The residual tail under stochastic depth (JAX
    ``fused_ffn_residual_masked``): ``ma`` and ``my`` are the block's two
    per-sample 0/1 masks [B] (f32), ``keep`` the keep probability.  Two K1
    launches in masked mode."""
    return kernel_vjp(
        lambda *t: _fused_ffn_residual(ln_linear, *t), _ffn_vjp(True),
        (x_res, a, ln_w, ln_b, w1, b1, w2, b2, ma, my), keep)


def _ffn(op, x, ln_w, ln_b, w1, b1, w2, b2):
    h = op(_flat(x), w1, b1, ln=(ln_w, ln_b), gelu=True)
    return op(h, w2, b2).view(*x.shape[:-1], w2.shape[0])


def ffn_reference(x, ln_w, ln_b, w1, b1, w2, b2):
    """LN + MLP without residual, in plain PyTorch (the extras' FFN)."""
    return _ffn(ln_linear_reference, x, ln_w, ln_b, w1, b1, w2, b2)


def fused_ffn(x, ln_w, ln_b, w1, b1, w2, b2):
    """LN + MLP without residual (JAX ``fused_ffn``, ``_ffn_kernel``'s op
    order) as two K1 launches: LN -> fc1 + b1 in f32 -> exact GELU -> one
    rounding; then fc2 + b2 in f32 and one rounding.  No model path calls
    it, as in the JAX package: the extras take ``ffn``."""
    return kernel_vjp(lambda *t: _ffn(ln_linear, *t), _ffn_vjp(False),
                      (x, ln_w, ln_b, w1, b1, w2, b2))


def linear_proj(x, w, b):
    """The attention out-projection: the f32 product is rounded to the IO
    dtype, then the bias is added in the IO dtype."""
    return kernel_vjp(
        lambda x, w, b: ln_linear(_flat(x), w, b, round_then_bias=True).view(
            *x.shape[:-1], w.shape[0]), _proj_vjp, (x, w, b))


def linear_proj_reference(x, w, b):
    return ln_linear_reference(_flat(x), w, b, round_then_bias=True).view(
        *x.shape[:-1], w.shape[0])
