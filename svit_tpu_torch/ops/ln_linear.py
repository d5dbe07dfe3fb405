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
  projection does; then optionally ``+ residual`` in the IO dtype.

Weights keep the PyTorch ``[out, in]`` layout.  On a CPU tensor the wrapper
runs the plain version ``ln_linear_reference``; on a CUDA tensor it launches
the kernel or raises.  ``ln_linear_plan`` picks the launch (path, rows per
block, consumer warpgroups, ring stages, blocks per row panel) from the
shapes alone.  The uses
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

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.splits


# the most blocks an SM holds by their registers (launch bounds of
# csrc/ln_linear.cu: 160 threads for one consumer warpgroup, three blocks;
# 288 for two, one block)
BLOCKS_BY_REGS = {1: 3, 2: 1}
STAGES_MAX = 6


@functools.lru_cache(maxsize=None)
def ln_linear_plan(M: int, N: int, K: int, *, prologue: bool,
                   split: Optional[int] = None, sms: int = 132) -> Plan:
    """The launch of K1 for an ``[M, K] @ [N, K].T`` call.

    With a prologue (LN or ``x_add``) a block keeps ``bm`` rows of all of K
    resident (K up to ``PANEL_K_MAX``); without one, A streams with W.
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
    if prologue and kc * BK > PANEL_K_MAX:
        raise ValueError(f"ln_linear's LN panel holds K <= {PANEL_K_MAX} "
                         f"(K={K})")
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
                        mask_add=None, mask_out=None, keep=1.0, rows=1):
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


def ln_linear(x, w, bias=None, *, ln=None, x_add=None, gelu=False,
              round_then_bias=False, residual=None, split=None,
              mask_add=None, mask_out=None, keep=1.0, rows=1):
    """Kernel K1 (``csrc/ln_linear.cu``); same contract as
    ``ln_linear_reference``.  Takes bf16 activations and weights, f32 LN
    parameters and bias; with ``ln`` or ``x_add``, K up to ``PANEL_K_MAX``.
    A launch with a mask counts as ``ln_linear_masked``."""
    if x.device.type == "cpu":
        return ln_linear_reference(
            x, w, bias, ln=ln, x_add=x_add, gelu=gelu,
            round_then_bias=round_then_bias, residual=residual, split=split,
            mask_add=mask_add, mask_out=mask_out, keep=keep, rows=rows)
    if gelu and round_then_bias:
        raise ValueError("gelu applies before the rounding; "
                         "round_then_bias has none")
    M, K = x.shape
    N = w.shape[0]
    dt = torch.bfloat16
    _lib.check(x, "x", dt)
    _lib.check(w, "w", dt, (N, K), x.device)
    plan = ln_linear_plan(M, N, K, prologue=ln is not None or x_add is not None,
                          split=split, sms=_lib.sm_count(x.device))
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
    out0 = torch.empty((M, n_split), dtype=dt, device=x.device)
    out1 = (torch.empty((M, N - n_split), dtype=dt, device=x.device)
            if n_split < N else None)
    s = torch.empty_like(x) if x_add is not None else None
    masks = [m for m in (mask_add, mask_out) if m is not None]
    if mask_add is not None and x_add is None:
        raise ValueError("mask_add scales x_add, which is missing")
    for m in masks:
        if M % rows:
            raise ValueError(f"{M} rows are not whole samples of {rows}")
        _lib.check(m, "mask", torch.float32, (M // rows,), x.device)
    mode = (_BIAS_NONE if bias is None
            else _BIAS_IO if round_then_bias else _BIAS_F32)
    if M:
        _lib.launch(
            "svit_ln_linear", "ln_linear_masked" if masks else "ln_linear",
            _lib.ptr(x), _lib.ptr(x_add), _lib.ptr(s),
            _lib.ptr(ln[0]) if ln else None, _lib.ptr(ln[1]) if ln else None,
            EPS, _lib.ptr(w), _lib.ptr(bias), mode, int(gelu),
            _lib.ptr(residual), _lib.ptr(out0), _lib.ptr(out1), n_split,
            M, N, K, _lib.ptr(mask_add), _lib.ptr(mask_out),
            _round_bf16(keep), int(rows),
            plan.bm, plan.ncw, plan.stages, plan.splits, _lib.stream())
    y = out0 if split is None else (out0, out1)
    return y if x_add is None else (y, s)


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
    it, as in the JAX package: the extras keep ``ffn_reference``."""
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
