"""The yardstick: the card's peaks, the operations of a step, the least
time its hand-written kernels' work could take, and the names that sort a
trace's kernels.

- ``forward_flops`` / ``train_step_flops``: a frozen copy of the program's
  FLOP model (``svit_tpu_torch/utils/flops.py``): 2 FLOPs per
  multiply-add in matmuls and convolutions, backward = 2 x forward, the
  consistency forward counted, elementwise work and recompute not.
- ``kernel_ops``: the operations that the hand-written kernels K1 to K7
  serve in one forward, train forward and backward, or eval forward,
  enumerated from the block schedule at the cell's shapes, each with the
  bytes it must move (each input byte once, each output byte once, bf16
  activations, f32 biases and norms) and its tensor-core and CUDA-core
  operations: a frozen copy of ``chip_smoke.py:cost()``.  It counts the
  work, not the kernel that does it: a later kernel that merges two of
  these leaves the count as it is.
- ``KERNELS`` / ``family``: a frozen copy of ``tools/trace_attrib.py``'s
  name rules (with K1's row pass, ``ln_rows_kernel``).
"""

from __future__ import annotations

import math
import re
from typing import List, Optional

# NVIDIA H100 SXM, dense: bf16 tensor cores, f32 on the CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BPS = 3.35e12
BF16, F32 = 2, 4


# ---------------------------------------------------------------------------
# FLOPs (frozen copy of svit_tpu_torch/utils/flops.py)
# ---------------------------------------------------------------------------

def out_shape(thw, kernel, stride):
    return tuple((d + 2 * (k // 2) - k) // s + 1
                 for d, k, s in zip(thw, kernel, stride))


def _prod(t) -> int:
    r = 1
    for x in t:
        r *= int(x)
    return r


def _stem(arch, t_in):
    k, s, p = arch.patch_kernel, arch.patch_stride, arch.patch_padding
    return tuple((d + 2 * pp - kk) // ss + 1 for d, kk, ss, pp in
                 zip((t_in, arch.crop_size, arch.crop_size), k, s, p))


def forward_flops(arch, batch: int, t_in: int) -> float:
    """Matmul and convolution FLOPs of one forward of ``batch`` clips of
    ``t_in`` frames."""
    thw = _stem(arch, t_in)
    total = (2.0 * _prod(thw) * arch.embed_dim * _prod(arch.patch_kernel)
             * arch.in_channels)
    n_extras = (1 if arch.cls_embed_on else 0) + arch.num_obj_per_frame * t_in
    for spec in arch.blocks:
        dim = spec.dim
        att = spec.dim_out if arch.dim_mul_in_att else spec.dim
        n_in = _prod(thw) + n_extras
        total += 3 * 2.0 * n_in * dim * att
        q_shape = thw
        if spec.stride_q and _prod(spec.kernel_q) * _prod(spec.stride_q) != 1:
            q_shape = out_shape(thw, spec.kernel_q, spec.stride_q)
            total += 2.0 * _prod(q_shape) * att * _prod(spec.kernel_q)
        k_shape = thw
        if (spec.stride_kv
                and _prod(spec.kernel_kv) * _prod(spec.stride_kv) != 1):
            k_shape = out_shape(thw, spec.kernel_kv, spec.stride_kv)
            total += 2 * 2.0 * _prod(k_shape) * att * _prod(spec.kernel_kv)
        n_q, n_k = _prod(q_shape), _prod(k_shape) + n_extras
        if arch.rel_pos_temporal:
            total += 2.0 * n_q * att * k_shape[0]
        if arch.rel_pos_spatial:
            total += 2.0 * n_q * att * (k_shape[1] + k_shape[2])
        total += 2 * 2.0 * n_q * n_k * att
        total += 2 * 2.0 * n_extras * n_k * att
        total += 2.0 * (n_q + n_extras) * att * att
        if spec.dim != spec.dim_out:
            n_proj = n_in if arch.dim_mul_in_att else (n_q + n_extras)
            total += 2.0 * n_proj * dim * spec.dim_out
        hidden = int(att * arch.mlp_ratio)
        total += 2.0 * (n_q + n_extras) * (att * hidden
                                           + hidden * spec.dim_out)
        thw = q_shape
    d, O = arch.final_dim, arch.num_obj_per_frame
    total += 2.0 * d * int(arch.num_classes)
    total += 2.0 * t_in * O * d * (4 + 1)
    total += 2.0 * t_in * 2 * d * 5
    return float(total) * batch


def train_step_flops(arch, batch_video: int, batch_image: int, *,
                     with_consistency: bool = True) -> float:
    total = 3.0 * forward_flops(arch, batch_video, arch.num_frames)
    if batch_image:
        total += 3.0 * forward_flops(arch, batch_image, 1)
    if with_consistency:
        total += forward_flops(arch, batch_video * arch.num_frames, 1)
    return total


# ---------------------------------------------------------------------------
# The hand-written kernels' work (frozen copy of chip_smoke.py:cost())
# ---------------------------------------------------------------------------

def _touched(D, k, s) -> int:
    out = (D + 2 * (k // 2) - k) // s + 1
    return len({o * s - k // 2 + d for o in range(out) for d in range(k)}
               & set(range(D)))


def _window_bytes(shape, kernel, stride) -> int:
    """Bytes of a bf16 grid [B, T, H, W, C] at the positions some window of
    the pool reads."""
    B, T, H, W, C = shape
    return B * C * BF16 * math.prod(
        _touched(d, k, s) for d, k, s in zip((T, H, W), kernel, stride))


def _op(name, byts, tc=0.0, core=0.0):
    return (name, float(byts), float(tc), float(core))


def _ln_linear(name, M, K, N, *, ln=False, bias=True, x_add=False,
               residual=False):
    byts = M * K * BF16 + N * K * BF16 + (N * F32 if bias else 0) \
        + M * N * BF16
    if ln:
        byts += 2 * K * F32
    if x_add:
        byts += 2 * M * K * BF16          # x_add read, the sum written
    if residual:
        byts += M * N * BF16
    return _op(name, byts, 2.0 * M * N * K)


def _pool_ln(name, shape, kernel, stride, hd):
    B, T, H, W, C = shape
    taps = math.prod(kernel)
    out = B * C * math.prod(out_shape((T, H, W), kernel, stride))
    byts = (_window_bytes(shape, kernel, stride) + C * taps * F32
            + 2 * C * F32 + out * BF16)
    return _op(name, byts, 0.0, out * (2.0 * taps + 8))


def _pool_conv(shape, kernel, stride):
    B, T, H, W, C = shape
    taps = math.prod(kernel)
    out = B * C * math.prod(out_shape((T, H, W), kernel, stride))
    byts = _window_bytes(shape, kernel, stride) + C * taps * BF16 + out * BF16
    return _op("K2 pool_conv (recompute)", byts, 0.0, 2.0 * taps * out)


def _conv_dx(shape, kernel, stride):
    B, T, H, W, C = shape
    taps = math.prod(kernel)
    g = B * C * math.prod(out_shape((T, H, W), kernel, stride))
    byts = g * BF16 + C * taps * BF16 + math.prod(shape) * BF16
    return _op("K6 conv_dx", byts, 0.0, 2.0 * taps * g)


def _conv_dk(shape, kernel, stride):
    B, T, H, W, C = shape
    taps = math.prod(kernel)
    g = B * C * math.prod(out_shape((T, H, W), kernel, stride))
    byts = _window_bytes(shape, kernel, stride) + g * BF16 + F32 * taps * C
    return _op("K7 conv_dk", byts, 0.0, 2.0 * taps * g)


def _pool_max(shape, kernel, stride, with_arg):
    B, T, H, W, C = shape
    out = B * C * math.prod(out_shape((T, H, W), kernel, stride))
    per_out = 3 if with_arg else 2
    return _op("K3 pool_max", math.prod(shape) * BF16 + per_out * out, 0.0,
               float(out * math.prod(kernel)))


def _pool_max_bwd(shape, kernel, stride):
    B, T, H, W, C = shape
    g = B * C * math.prod(out_shape((T, H, W), kernel, stride))
    return _op("K3 pool_max_bwd", g * BF16 + g + math.prod(shape) * BF16,
               0.0, float(g))


def _attention(B, Nq, Nk, C, bias_cols):
    byts = (2 * B * Nq * C + B * Nk * 2 * C + bias_cols) * BF16
    return _op("K4 attention", byts, 4.0 * B * Nq * Nk * C)


def _attention_bwd(B, Nq, Nk, C, bias_cols):
    q, kv = B * Nq * C, B * Nk * 2 * C
    byts = (2 * (q + kv + bias_cols) + q) * BF16
    return _op("K5 attention_bwd", byts, 10.0 * B * Nq * Nk * C)


def kernel_ops(arch, batch: int, t_in: int, mode: str) -> List[tuple]:
    """(name, bytes, tensor-core ops, CUDA-core ops) of each operation that
    K1 to K7 serve in one forward of ``batch`` clips of ``t_in`` frames.
    ``mode``: ``eval`` (no masks), ``train_nograd`` (the consistency
    forward: masked tails, no argmax), ``train`` (the forward with its
    backward: the argmax, the attention backward, each pool's recompute,
    dx and dk, the max pool's backward; the last block's grid queries and
    q pool feed nothing that the losses read, so they take no backward)."""
    ops: List[tuple] = []
    grad = mode == "train"
    thw = _stem(arch, t_in)
    E = (1 if arch.cls_embed_on else 0) + arch.num_obj_per_frame * t_in
    last = len(arch.blocks) - 1
    for i, b in enumerate(arch.blocks):
        C, hd = b.dim_out, b.dim_out // b.num_heads
        M = batch * _prod(thw)
        ops.append(_ln_linear("K1 ln_qkv", M, b.dim, 3 * C, ln=True))
        q_shape = k_shape = thw
        pools = []
        if b.pool_q:
            q_shape = out_shape(thw, b.kernel_q, b.stride_q)
            pools.append(((batch, *thw, C), b.kernel_q, b.stride_q, i != last))
        if b.pool_kv:
            k_shape = out_shape(thw, b.kernel_kv, b.stride_kv)
            pools.append(((batch, *thw, 2 * C), b.kernel_kv, b.stride_kv,
                          True))
        for shape, kernel, stride, _ in pools:
            ops.append(_pool_ln("K2 pool_ln", shape, kernel, stride, hd))
        Nq, Nk = _prod(q_shape), _prod(k_shape) + E
        bias_cols = batch * b.num_heads * Nq * sum(k_shape)
        ops.append(_attention(batch, Nq, Nk, C, bias_cols))
        ops.append(_ln_linear("K1 out_proj", batch * Nq, C, C))
        ops.append(_attention(batch, E, Nk, C, 0))
        ops.append(_ln_linear("K1 out_proj", batch * E, C, C))
        if b.dim != b.dim_out:
            ops.append(_ln_linear("K1 ln_dense", M, b.dim, b.dim_out,
                                  ln=True))
        skip = None
        if b.stride_q and _prod(b.stride_q) > 1:
            skip = tuple(s + 1 if s > 1 else s for s in b.stride_q)
            ops.append(_pool_max((batch, *thw, b.dim_out), skip, b.stride_q,
                                 grad))
        Mq, hidden = batch * Nq, int(C * arch.mlp_ratio)
        ops.append(_ln_linear("K1 ffn_fc1", Mq, C, hidden, ln=True,
                              x_add=True))
        ops.append(_ln_linear("K1 ffn_fc2", Mq, hidden, b.dim_out,
                              residual=True))
        if grad:
            if i != last:
                ops.append(_attention_bwd(batch, Nq, Nk, C, bias_cols))
            ops.append(_attention_bwd(batch, E, Nk, C, 0))
            for shape, kernel, stride, back in pools:
                if back:
                    ops += [_pool_conv(shape, kernel, stride),
                            _conv_dx(shape, kernel, stride),
                            _conv_dk(shape, kernel, stride)]
            if skip is not None:
                ops.append(_pool_max_bwd((batch, *thw, b.dim_out), skip,
                                         b.stride_q))
        thw = q_shape
    return ops


def bound_s(ops) -> float:
    """The least time of ``ops`` on the card: each op's larger of bytes
    over the HBM's rate and operations over the units' peaks."""
    return sum(max(b / HBM_BPS, tc / PEAK_BF16, core / PEAK_F32)
               for _, b, tc, core in ops)


def train_step_ops(arch, batch_video, batch_image, with_consistency=True):
    ops = kernel_ops(arch, batch_video, arch.num_frames, "train")
    if batch_image:
        ops += kernel_ops(arch, batch_image, 1, "train")
    if with_consistency:
        ops += kernel_ops(arch, batch_video * arch.num_frames, 1,
                          "train_nograd")
    return ops


# ---------------------------------------------------------------------------
# Kernel names (frozen copy of tools/trace_attrib.py's rules)
# ---------------------------------------------------------------------------

KERNELS = {
    "ln_linear_kernel": "K1 ln_linear", "ln_rows_kernel": "K1 ln_linear",
    "pool_ln_kernel": "K2 pool_ln", "halo_gen_kernel": "K2 pool_ln",
    "pool_max_kernel": "K3 pool_max",
    "pool_max_bwd_kernel": "K3 pool_max_bwd",
    "pool_max_bwd_tile_kernel": "K3 pool_max_bwd",
    "attn_fwd_kernel": "K4 attention",
    "attn_bwd_q_kernel": "K5 attention_bwd",
    "attn_bwd_kv_kernel": "K5 attention_bwd",
    "attn_bwd_reduce_kernel": "K5 attention_bwd",
    "dx_kernel": "K6 conv_dx",
    "conv_dk_kernel": "K7 conv_dk", "conv_dk_reduce_kernel": "K7 conv_dk",
    "dk_gen_kernel": "K7 conv_dk",
}
HAND_WRITTEN = frozenset(KERNELS.values())
KERNEL_RE = re.compile(r"(?<![A-Za-z_])(" + "|".join(KERNELS) + ")")
FAMILY_RE = [
    (re.compile(r"(?i)nccl"), "NCCL"),
    (re.compile(r"(?i)^mem(cpy|set)\b"), "memcpy/memset"),
    (re.compile(r"CatArrayBatchedCopy"), "CatArrayBatchedCopy"),
    (re.compile(r"(?i)copy_kernel|_to_copy|\bcast"), "cast/copy"),
    (re.compile(r"(?i)fprop|dgrad|wgrad|cudnn|convolve|conv_depthwise"),
     "convolution"),
    (re.compile(r"(?i)nvjet|gemm|cutlass|xmma|cublas|splitkreduce"), "GEMM"),
    (re.compile(r"(?i)reduce|softmax|layer_norm|welford|norm_kernel"),
     "reduction"),
    (re.compile(r"(?i)elementwise|multi_tensor_apply|fill|index"),
     "elementwise"),
]


def kernel_name(text: str) -> Optional[str]:
    m = KERNEL_RE.search(text)
    return m.group(1) if m else None


def family(name: str, memop: bool = False) -> str:
    if memop:
        return "memcpy/memset"
    own = kernel_name(name)
    if own is not None:
        return KERNELS[own]
    for rx, fam in FAMILY_RE:
        if rx.search(name):
            return fam
    return "other"


def is_hand_written(fam: str) -> bool:
    return fam in HAND_WRITTEN


def short(name: str, n: int = 80) -> str:
    """A kernel's name cut to its function, for the breakdown."""
    base = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"^void ", "", base).split("(")[0]
    return base[:n]
