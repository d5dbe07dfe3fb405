"""Pooled attention: kernel K4 and the rel-pos bias inputs (counterpart of
``svit_tpu/ops/pallas_attention.py``).

``pooled_attention`` computes, per head,

    out = softmax((q * scale) K^T + bias) V        (softmax in f32)

then rounds the head outputs to the IO dtype and, with ``q_residual``, adds
the unscaled q in the IO dtype (the reference's residual pooling).  q is
``[B, Nq, C]`` and the keys and values arrive as one ``[B, Nk, 2C]`` tensor
(keys in channels ``[0, C)``, values in ``[C, 2C)``), with ``C = heads *
head_dim``.

The decomposed rel-pos bias: for a patch key ``j < k_l`` with grid position
``(t, h, w)`` in ``k_shape`` the bias is ``bias_src[q, t] + bias_src[q, kT +
h] + bias_src[q, kT + kH + w]``; the keys after the patches (cls and object
tokens) get 0.  That is the JAX package's ``bias_src @ M`` with its one-hot
scatter matrix.  The plain twins gather it; the kernels take the product, on
the tensor cores, with the one-hot map ``onehot_mt`` (built once per
``(k_shape, Nk)`` on the device and cached, ``onehot_tiles``).
``bias_src=None`` is the extras launch: no rel-pos bias at all.  The launch
of K4 and K5 (ring stages, the bias product's k-steps, K5's query splits)
is the pure-Python ``attention_plan``.

``fused_attention_proj`` adds the out-projection as a separate K1 launch
(``ln_linear.linear_proj``): the product is rounded, then the bias is added
in the IO dtype, as the TPU kernel's epilogue did.

Both are differentiable.  The backward is kernel K5
(``pooled_attention_bwd``, ``csrc/attention.cu``): it recomputes the
probabilities from the saved q, kv and bias and returns dq, dkv and the
rel-pos bias gradient.  Around the projection it follows JAX ``_bwd_proj``:
``dbp`` and ``dwp`` in PyTorch, ``dbase = round(g @ wp)``, then K5 on dbase,
which under ``q_residual`` also adds ``dbase`` to dq.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Tuple

import torch

from svit_tpu_torch.ops import _lib, ln_linear
from svit_tpu_torch.ops import rel_pos as rp
from svit_tpu_torch.ops.vjp import needs_grad
from svit_tpu_torch.utils import tracing

Triple = Tuple[int, int, int]


def fault_injected() -> bool:
    """The numerics gate's deliberate fault (``python -m
    svit_tpu_torch.tools.check_kernels_hw --selftest``), read at every
    call: with ``SVIT_PALLAS_FAULT=1`` K4's output (both routes: the
    kernel, and the plain twin on a CPU tensor) is rolled by one channel on
    the last axis, as a lane-offset fault would shift it; an additive error
    would vanish in the LayerNorms downstream.  Unset, nothing changes."""
    return os.environ.get("SVIT_PALLAS_FAULT", "0") == "1"


def _faulted(out):
    return torch.roll(out, 1, dims=-1) if fault_injected() else out


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, with the operands in their (IO) dtype and the sum
    in f32, returned in f32: on the card cuBLAS's batched GEMM with an f32
    output (bf16 on the tensor cores), on the CPU the f32 product of the
    same values (``ln_linear._mm``'s rule)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _BiasTermFn(torch.autograd.Function):
    """One term of the bias: queries ``a [P, M, hd]`` grouped by the grid
    position ``P`` that picks the table row, times ``table [P, k, hd]``:
    ``round(a @ table^T)`` to the IO dtype from an f32 sum.  The gradient
    takes the same operand types, as JAX transposes a dot with
    ``preferred_element_type=f32``: each operand's cotangent is an f32 sum
    of IO-dtype products, rounded to that operand's dtype."""

    @staticmethod
    def forward(ctx, a, table):
        ctx.save_for_backward(a, table)
        return _bmm(a, table.transpose(1, 2)).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, table = ctx.saved_tensors
        g = g.to(a.dtype)
        da = dt = None
        if ctx.needs_input_grad[0]:
            da = _bmm(g, table).to(a.dtype)
        if ctx.needs_input_grad[1]:
            dt = _bmm(g.transpose(1, 2), a).to(table.dtype)
        return da, dt


def _bias_term(rq: torch.Tensor, table: torch.Tensor, axis: int):
    """The term of grid axis ``axis`` (0 t, 1 h, 2 w): ``rq [B, Tq, Hq, Wq,
    heads, hd]`` against ``table [q_n, k, hd]`` of that axis; returns
    ``[B, heads, Tq * Hq * Wq, k]``."""
    B, Tq, Hq, Wq, heads, hd = rq.shape
    lead = [1 + axis] + [d for d in range(5) if d != 1 + axis]
    a = rq.permute(*lead, 5).reshape(rq.shape[1 + axis], -1, hd)
    out = _BiasTermFn.apply(a, table)
    out = out.view(*[rq.shape[d] for d in lead], table.shape[1])
    order = [lead.index(d) for d in (0, 4, 1, 2, 3)]
    return out.permute(*order, 5).reshape(B, heads, Tq * Hq * Wq, -1)


def build_bias_inputs_grid(
    q_grid: torch.Tensor,         # [B, Tq, Hq, Wq, heads*hd], pooled + normed
    num_heads: int,
    q_shape: Triple,
    k_shape: Triple,
    *,
    rel_pos_h: Optional[torch.Tensor],
    rel_pos_w: Optional[torch.Tensor],
    rel_pos_t: Optional[torch.Tensor],
) -> torch.Tensor:
    """bias_src ``[B, heads, q_l, kT + kH + kW]`` in ``q_grid``'s dtype.

    Each term is a product of the queries and a rel-pos table in the IO
    dtype with f32 accumulation, rounded to the IO dtype once (JAX
    ``build_bias_inputs_grid``'s einsums with ``preferred_element_type``);
    a missing table gives zeros.  The builder is the owner ``bias``
    (``utils/tracing.py``), forward and backward."""
    B, Tq, Hq, Wq, C = q_grid.shape
    k_t, k_h, k_w = k_shape
    dt = q_grid.dtype
    q_l = Tq * Hq * Wq
    with tracing.owner("bias", sub=True) as own:
        q_grid, rel_pos_h, rel_pos_w, rel_pos_t = own.inputs(
            q_grid, rel_pos_h, rel_pos_w, rel_pos_t)
        rq = q_grid.reshape(B, Tq, Hq, Wq, num_heads, C // num_heads)
        zeros = q_grid.new_zeros

        def term(rel_pos, axis, k):
            if rel_pos is None:
                return zeros((B, num_heads, q_l, k))
            table = rp.rel_table(rel_pos, q_shape[axis], k).to(dt)
            return _bias_term(rq, table, axis)

        with_hw = rel_pos_h is not None
        terms = [term(rel_pos_t, 0, k_t),
                 term(rel_pos_h if with_hw else None, 1, k_h),
                 term(rel_pos_w if with_hw else None, 2, k_w)]
        return own.outputs(torch.cat(terms, dim=-1))


# ---------------------------------------------------------------------------
# The one-hot map and the launch plan of csrc/attention.cu
# ---------------------------------------------------------------------------

def onehot_mt(k_shape: Triple, n_k: int, r_pad: int) -> torch.Tensor:
    """M^T ``[n_k, r_pad]`` f32 (CPU): for patch key ``j < kT*kH*kW`` at grid
    position ``(t, h, w)`` ones at columns ``t``, ``kT + h`` and ``kT + kH +
    w``; zero rows for the extras keys, zero columns past ``kT + kH + kW``.
    The JAX package's ``_scatter_matrix`` rows ``[:R]``, transposed."""
    k_t, k_h, k_w = k_shape
    mt = torch.zeros(n_k, r_pad)
    j = torch.arange(k_t * k_h * k_w)
    for col in (j // (k_h * k_w), k_t + (j // k_w) % k_h, k_t + k_h + j % k_w):
        mt[j, col] = 1.0
    return mt


def tile_onehot(mt: torch.Tensor) -> torch.Tensor:
    """``mt [n_k, r_pad]`` as the kernels' one-hot tiles ``[tiles, r_pad /
    8, 64, 8]`` in bf16 (exact: 0 and 1): for each tile of 64 keys (zero rows
    past ``n_k``), chunk ``c`` (columns ``8c .. 8c + 7``) of every key row,
    so 8 rows of one chunk are one 128-byte wgmma core matrix."""
    n_k, r_pad = mt.shape
    rows = -(-n_k // BQ) * BQ
    padded = torch.nn.functional.pad(mt, (0, 0, 0, rows - n_k))
    return padded.view(rows // BQ, BQ, r_pad // 8, 8).transpose(1, 2) \
        .contiguous().to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def onehot_tiles(k_shape: Triple, n_k: int, r_pad: int,
                 device: str) -> torch.Tensor:
    """``tile_onehot(onehot_mt(...))`` on ``device``, built once per call
    shape."""
    return tile_onehot(onehot_mt(k_shape, n_k, r_pad)).to(device)


BQ = 64                    # rows of a block (queries or keys), keys of a tile
SMEM_BLOCK = 232448        # dynamic shared memory one block may use
SMEM_SM = 233472           # shared memory of one SM
SMEM_RESERVED = 1024       # what the system keeps per block
STAGES_MAX = 4
RK_WIDE = 8        # the bias product's k-steps for 48 < R <= 128
RK_CHUNKED = 16    # ... for 128 < R <= 256: two 128-column chunks
PARTIAL_BYTES_MAX = 1 << 28   # f32 dK | dV partials of K5's query splits
# blocks an SM the plan keeps (160 threads a block; ptxas at head_dim 96:
# the forward takes about 130 registers a thread, which would hold three
# blocks, but two keep a deeper ring; the query side 141-171; the key side
# 228-230, one block)
BLOCKS_BY_REGS = {"fwd": 2, "bwd_q": 2, "bwd_kv": 1}


HD_MAX = 128       # o, dq, dk, dv: HD / 2 f32 accumulators a thread, in registers


def head_instance(C: int, heads: int) -> Tuple[int, int]:
    """(hd, HD): a head's width and the compiled instance that runs it,
    ``HD = 32 ceil(hd / 32)`` (48 runs in 64, 72 in 96), or a ValueError
    naming the card's rule the shape breaks."""
    if heads < 1 or C % heads:
        raise ValueError(f"pooled attention needs C divisible by heads "
                         f"(C={C}, heads={heads})")
    hd = C // heads
    if hd % 8:
        raise ValueError(
            f"pooled attention takes head_dim a multiple of 8: TMA reads "
            f"each head through a tensor map whose strides are multiples of "
            f"16 bytes (head_dim={hd}, C={C}, heads={heads})")
    if hd > HD_MAX:
        raise ValueError(
            f"pooled attention takes head_dim up to {HD_MAX}: the output "
            f"and gradient accumulators (head_dim / 2 f32 a thread) live in "
            f"registers (head_dim={hd}, C={C}, heads={heads})")
    return hd, 32 * _cdiv(hd, 32)


def attention_smem(kind: str, hd: int, rk: int, stages: int) -> int:
    """Dynamic shared memory of one block of ``kind`` ("fwd", "bwd_q",
    "bwd_kv") of the instance ``hd`` (HD: a multiple of 32), as
    ``csrc/attention.cu`` lays it out (``fwd_smem``,
    ``bwd_q_smem``, ``bwd_kv_smem``): the resident tiles (the 64-row q tile
    and bias rows, with the dO tile on the query side; or the key side's K |
    V | one-hot tiles), the ring's slots (K | V | one-hot tiles of 64 keys;
    or q * scale | dO | the statistics | the bias rows of 64 queries), full
    and empty barriers per slot and one more."""
    tile, onehot = BQ * hd * 2, BQ * 32 * rk
    bars = 8 * (2 * stages + 1)
    if kind == "fwd":
        return tile + onehot + stages * (2 * tile + onehot) + bars
    if kind == "bwd_q":
        return 2 * tile + onehot + stages * (2 * tile + onehot) + bars
    if kind == "bwd_kv":
        return (2 * tile + onehot + stages * (2 * tile + BQ * 16 + onehot)
                + bars)
    raise ValueError(kind)


def chunks(rk: int) -> int:
    """128-column chunks of K5's dbias accumulator (``NCH`` in
    ``csrc/attention.cu:attn_bwd_q_kernel``): the query side passes over the
    key tiles once for the statistics and once per chunk."""
    return rk // RK_WIDE if rk > RK_WIDE else 1


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    stages: int         # ring slots (the forward, or K5's query side)
    rk: int             # k16 steps of the bias product (R padded to 16 rk)
    blocks: int         # blocks of the forward, or of K5's query side
    smem: int
    blocks_per_sm: int
    # K5's key side
    kv_stages: int = 0
    splits: int = 0
    tiles_per_split: int = 0
    kv_blocks: int = 0
    kv_smem: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _per_sm(kind: str, smem: int) -> int:
    return min(BLOCKS_BY_REGS[kind], SMEM_SM // (smem + SMEM_RESERVED))


def _stages(kind, hd, rk, loads):
    """The deepest ring (up to STAGES_MAX and the loads it carries) that
    keeps the blocks an SM that the registers allow, at least one slot."""
    want = _per_sm(kind, attention_smem(kind, hd, rk, 1))
    best = 1
    for s in range(1, min(STAGES_MAX, max(1, loads)) + 1):
        if _per_sm(kind, attention_smem(kind, hd, rk, s)) >= want:
            best = s
    return best


@functools.lru_cache(maxsize=None)
def attention_plan(B: int, Nq: int, Nk: int, C: int, heads: int, R: int, *,
                   backward: bool = False, sms: int = 132) -> AttnPlan:
    """The launch of K4 (or, ``backward``, K5) for a call's shapes; ``R`` is
    ``kT + kH + kW``, 0 without a bias.

    A block is one consumer warpgroup of 64 rows (queries; or keys on K5's
    key side) and the producer warp; keys come in tiles of 64.  A head of
    width hd (a multiple of 8 up to 128) runs in the instance ``HD = 32
    ceil(hd / 32)`` (``head_instance``), whose tiles TMA zero-fills past
    hd.  The bias product takes ``rk = ceil(R / 16)`` k-steps in the HD =
    96 instances (the compiled ones); the others pad R to 48 (``rk`` 3).  A
    key grid past 48 (a block without k|v pooling) pads R to 128
    (``RK_WIDE``) in every instance, and a grid past 128 (256 px or more)
    pads it to 256 (``RK_CHUNKED``): the scores take all 16 k-steps, and
    K5's query side takes dbias in two 128-column chunks, one more pass
    over the key tiles for the second (``chunks``).  Past 256 the plan
    raises.  The
    ring takes the most stages (up to ``STAGES_MAX``, and no more than it
    carries) that keep the blocks an SM that the registers allow.  K5's key
    side splits the query tiles until its blocks fill the card twice,
    within ``PARTIAL_BYTES_MAX`` of f32 partials."""
    _, inst = head_instance(C, heads)
    if R > 16 * RK_CHUNKED:
        raise ValueError(
            f"the rel-pos bias takes kT + kH + kW <= {16 * RK_CHUNKED}: K5's "
            f"query side keeps its dbias rows in registers, two 128-column "
            f"chunks at most (R={R})")
    if R > 16 * RK_WIDE:
        rk = RK_CHUNKED
    elif R > 48:
        rk = RK_WIDE
    else:
        rk = 0 if R == 0 else (_cdiv(R, 16) if inst == 96 else 3)
    n_kt, q_tiles = _cdiv(Nk, BQ), _cdiv(Nq, BQ)
    kind = "bwd_q" if backward else "fwd"
    stages = _stages(kind, inst, rk,
                     (1 + chunks(rk)) * n_kt if backward else n_kt)
    smem = attention_smem(kind, inst, rk, stages)
    blocks = q_tiles * heads * B
    if not backward:
        return AttnPlan(stages, rk, blocks, smem, _per_sm(kind, smem))
    key_blocks = n_kt * heads * B
    splits = max(1, min(q_tiles, _cdiv(2 * sms, key_blocks)))
    while splits > 1 and splits * B * Nk * 2 * C * 4 > PARTIAL_BYTES_MAX:
        splits -= 1
    per = _cdiv(q_tiles, splits)
    splits = _cdiv(q_tiles, per)          # no split without a tile
    kv_stages = _stages("bwd_kv", inst, rk, per)
    kv_smem = attention_smem("bwd_kv", inst, rk, kv_stages)
    return AttnPlan(stages, rk, blocks, smem, _per_sm(kind, smem), kv_stages,
                    splits, per, key_blocks * splits, kv_smem)


def _gather_bias(bias_src, k_shape, n_k):
    """The dense ``[B, heads, Nq, n_k]`` f32 bias of the gather rule."""
    k_t, k_h, k_w = k_shape
    j = torch.arange(k_t * k_h * k_w, device=bias_src.device)
    bf = bias_src.float()
    dense = (bf[..., j // (k_h * k_w)] + bf[..., k_t + (j // k_w) % k_h]
             + bf[..., k_t + k_h + j % k_w])
    return torch.nn.functional.pad(dense, (0, n_k - dense.shape[-1]))


def pooled_attention_reference(q, kv, bias_src, k_shape: Triple, scale: float,
                               heads: int, q_residual: bool = False):
    """Plain twin of ``pooled_attention`` (the JAX ``reference_attention``
    arithmetic: f32 logits, f32 softmax, probabilities rounded to the IO
    dtype before the value product)."""
    B, Nq, C = q.shape
    Nk = kv.shape[1]
    hd = C // heads
    dt = q.dtype

    def split_heads(t):
        return t.reshape(B, t.shape[1], heads, hd).transpose(1, 2)

    qh = split_heads(q) * torch.tensor(scale, dtype=dt)
    kh = split_heads(kv[..., :C])
    vh = split_heads(kv[..., C:])
    logits = qh.float() @ kh.float().transpose(-1, -2)
    if bias_src is not None:
        logits = logits + _gather_bias(bias_src, k_shape, Nk)
    p = torch.softmax(logits, dim=-1)
    out = (p.to(dt).float() @ vh.float()).to(dt)
    out = out.transpose(1, 2).reshape(B, Nq, C)
    return out + q if q_residual else out


def _checked(q, kv, bias_src, k_shape, heads):
    """Validate a kernel call; returns R = kT + kH + kW, 0 without a
    bias."""
    B, Nq, C = q.shape
    Nk = kv.shape[1]
    dt = torch.bfloat16
    _lib.check(q, "q", dt)
    _lib.check(kv, "kv", dt, (B, Nk, 2 * C), q.device)
    head_instance(C, heads)
    if bias_src is None:
        return 0
    k_t, k_h, k_w = k_shape
    _lib.check(bias_src, "bias_src", dt, (B, heads, Nq, k_t + k_h + k_w),
               q.device)
    if k_t * k_h * k_w > Nk:
        raise ValueError(f"k_shape {k_shape} holds more keys than Nk={Nk}")
    return k_t + k_h + k_w


def _tiles(bias_src, k_shape, Nk, rk, device):
    if bias_src is None:
        return None
    return onehot_tiles(tuple(k_shape), Nk, 16 * rk, str(device))


def pooled_attention_fwd(q, kv, bias_src, k_shape: Triple, scale: float,
                         heads: int, q_residual: bool = False):
    """Kernel K4 (``csrc/attention.cu``), the forward alone: online softmax
    over TMA-fed key tiles on ``wgmma``, the bias as a product with the
    one-hot map; launched as ``attention_plan`` says.  Returns [B, Nq, C]."""
    if q.device.type == "cpu":
        return _faulted(pooled_attention_reference(q, kv, bias_src, k_shape,
                                                   scale, heads, q_residual))
    B, Nq, C = q.shape
    Nk = kv.shape[1]
    R = _checked(q, kv, bias_src, k_shape, heads)
    out = torch.empty_like(q)
    if q.numel():
        plan = attention_plan(B, Nq, Nk, C, heads, R,
                              sms=_lib.sm_count(q.device))
        mt = _tiles(bias_src, k_shape, Nk, plan.rk, q.device)
        _lib.launch(
            "svit_pooled_attention", "pooled_attention",
            _lib.ptr(q), _lib.ptr(kv), _lib.ptr(bias_src), _lib.ptr(mt),
            _lib.ptr(out), B, Nq, Nk, C, heads, R, float(scale),
            int(q_residual), plan.stages, plan.rk, _lib.stream())
    return _faulted(out)


def _bias_grad(ds, k_shape: Triple):
    """JAX's ``dS M^T`` without the scatter matrix: ``ds [..., Nk]`` summed
    over the patch keys that share each temporal, row and column index."""
    k_t, k_h, k_w = k_shape
    grid = ds[..., :k_t * k_h * k_w].unflatten(-1, (k_t, k_h, k_w))
    return torch.cat([grid.sum((-2, -1)), grid.sum((-3, -1)),
                      grid.sum((-3, -2))], dim=-1)


def pooled_attention_bwd_reference(q, kv, bias_src, do, k_shape: Triple,
                                   scale: float, heads: int,
                                   q_residual: bool = False):
    """Plain twin of ``pooled_attention_bwd``, step by step as JAX
    ``_attn_bwd_kernel``: P recomputed in f32 from (q * scale in the IO
    dtype) K^T + bias; dP = dO V^T; delta = rowsum(dP o P); dS = P o (dP -
    delta); dq = round(dS) K * scale; dK = round(dS)^T (q * scale); dV =
    round(P)^T dO; dbias the scatter of dS (f32) onto the bias columns.
    Returns (dq, dkv, dbias or None) in the IO dtype; with ``q_residual``,
    dq + dO."""
    B, Nq, C = q.shape
    Nk = kv.shape[1]
    hd = C // heads
    dt = q.dtype

    def split_heads(t):
        return t.reshape(B, t.shape[1], heads, hd).transpose(1, 2).float()

    qs = split_heads(q * torch.tensor(scale, dtype=dt))
    kh, vh = split_heads(kv[..., :C]), split_heads(kv[..., C:])
    doh = split_heads(do)
    logits = qs @ kh.transpose(-1, -2)
    if bias_src is not None:
        logits = logits + _gather_bias(bias_src, k_shape, Nk)
    p = torch.softmax(logits, dim=-1)
    dp = doh @ vh.transpose(-1, -2)
    delta = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dsr = ds.to(dt).float()
    dq = (dsr @ kh) * scale
    dk = dsr.transpose(-1, -2) @ qs
    dv = p.to(dt).float().transpose(-1, -2) @ doh

    def merge(t):
        return t.transpose(1, 2).reshape(B, t.shape[2], C)

    dq = merge(dq).to(dt)
    if q_residual:
        dq = dq + do
    dkv = torch.cat([merge(dk), merge(dv)], dim=-1).to(dt)
    dbias = None if bias_src is None else _bias_grad(ds, k_shape).to(dt)
    return dq, dkv, dbias


def pooled_attention_bwd(q, kv, bias_src, do, k_shape: Triple, scale: float,
                         heads: int, q_residual: bool = False):
    """Kernel K5 (``csrc/attention.cu``): the gradient of
    ``pooled_attention`` with respect to q, kv and bias_src, for the output
    cotangent ``do`` [B, Nq, C].  Same contract as the plain twin.
    Launched as ``attention_plan(..., backward=True)`` says."""
    if q.device.type == "cpu":
        return pooled_attention_bwd_reference(q, kv, bias_src, do, k_shape,
                                              scale, heads, q_residual)
    B, Nq, C = q.shape
    Nk = kv.shape[1]
    R = _checked(q, kv, bias_src, k_shape, heads)
    _lib.check(do, "do", torch.bfloat16, (B, Nq, C), q.device)
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv)
    dbias = torch.empty_like(bias_src) if bias_src is not None else None
    if q.numel():
        plan = attention_plan(B, Nq, Nk, C, heads, R, backward=True,
                              sms=_lib.sm_count(q.device))
        mt = _tiles(bias_src, k_shape, Nk, plan.rk, q.device)
        nq_pad = _cdiv(Nq, BQ) * BQ
        stats = torch.empty((B, heads, nq_pad, 4), dtype=torch.float32,
                            device=q.device)
        qs = torch.empty_like(q)
        bias_tiles = (torch.empty((B, heads, nq_pad, 16 * plan.rk),
                                  dtype=q.dtype, device=q.device)
                      if bias_src is not None else None)
        partial = (torch.empty((plan.splits, B, Nk, 2 * C),
                               dtype=torch.float32, device=q.device)
                   if plan.splits > 1 else None)
        _lib.launch(
            "svit_pooled_attention_bwd", "pooled_attention_bwd",
            _lib.ptr(q), _lib.ptr(kv), _lib.ptr(bias_src), _lib.ptr(do),
            _lib.ptr(mt), _lib.ptr(dq), _lib.ptr(dkv), _lib.ptr(dbias),
            _lib.ptr(stats), _lib.ptr(qs), _lib.ptr(bias_tiles),
            _lib.ptr(partial), B, Nq, Nk, C,
            heads, R, float(scale), int(q_residual), plan.stages,
            plan.kv_stages, plan.rk, plan.splits, _lib.stream())
    return dq, dkv, dbias


class _AttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias_src, k_shape, scale, heads, q_residual):
        ctx.args = (tuple(k_shape), scale, heads, q_residual)
        ctx.save_for_backward(q, kv, bias_src)
        return pooled_attention_fwd(q, kv, bias_src, k_shape, scale, heads,
                                    q_residual)

    @staticmethod
    def backward(ctx, g):
        q, kv, bias_src = ctx.saved_tensors
        dq, dkv, dbias = pooled_attention_bwd(q, kv, bias_src, g.contiguous(),
                                              *ctx.args)
        return dq, dkv, dbias, None, None, None, None


def pooled_attention(q, kv, bias_src, k_shape: Triple, scale: float,
                     heads: int, q_residual: bool = False):
    """Kernel K4; differentiable through K5."""
    if not needs_grad(q, kv, bias_src):
        return pooled_attention_fwd(q, kv, bias_src, k_shape, scale, heads,
                                    q_residual)
    return _AttentionFn.apply(q, kv, bias_src, k_shape, scale, heads,
                              q_residual)


def _attention_then_proj(q, kv, bias_src, k_shape, wp, bp, scale, heads,
                         q_residual):
    """(K4's output, the projection of it): the owners ``core`` and
    ``proj``."""
    with tracing.owner("core", sub=True):
        base = pooled_attention_fwd(q, kv, bias_src, k_shape, scale, heads,
                                    q_residual)
    with tracing.owner("proj", sub=True):
        return base, ln_linear.linear_proj(base, wp, bp)


class _AttentionProjFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias_src, wp, bp, k_shape, scale, heads,
                q_residual):
        base, out = _attention_then_proj(q, kv, bias_src, k_shape, wp, bp,
                                         scale, heads, q_residual)
        ctx.args = (tuple(k_shape), scale, heads, q_residual)
        ctx.save_for_backward(q, kv, bias_src, wp, base)
        return out

    @staticmethod
    def backward(ctx, g):
        q, kv, bias_src, wp, base = ctx.saved_tensors
        want = ctx.needs_input_grad
        with tracing.owner("proj", sub=True):
            g2 = g.reshape(-1, g.shape[-1])
            dbp = g2.float().sum(0) if want[4] else None
            dwp = ((g2.t() @ base.reshape(-1, base.shape[-1])).to(wp.dtype)
                   if want[3] else None)
            dbase = (g2 @ wp).view(g.shape) if any(want[:3]) else None
        dq = dkv = dbias = None
        if dbase is not None:
            with tracing.owner("core", sub=True):
                dq, dkv, dbias = pooled_attention_bwd(q, kv, bias_src, dbase,
                                                      *ctx.args)
        return dq, dkv, dbias, dwp, dbp, None, None, None, None


def fused_attention_proj(q, kv, bias_src, k_shape, wp, bp, scale, heads,
                         q_residual=False):
    """Attention (K4) then the out-projection (K1): ``proj(att (+ q))``.
    Differentiable: the backward of JAX ``_bwd_proj``, with K5.  Each half
    is an owner (``core``, ``proj``), forward and backward."""
    if not needs_grad(q, kv, bias_src, wp, bp):
        return _attention_then_proj(q, kv, bias_src, k_shape, wp, bp, scale,
                                    heads, q_residual)[1]
    return _AttentionProjFn.apply(q, kv, bias_src, wp, bp, k_shape, scale,
                                  heads, q_residual)


def attention_proj_reference(q, kv, bias_src, k_shape, wp, bp, scale, heads,
                             q_residual=False):
    att = pooled_attention_reference(q, kv, bias_src, k_shape, scale, heads,
                                     q_residual)
    return ln_linear.linear_proj_reference(att, wp, bp)
