"""Analytic FLOP model for SViT (counterpart of ``svit_tpu/utils/flops.py``):
matmul and convolution FLOPs in the MFU convention, counted from the
static ``SViTArch`` block schedule.

Conventions (standard MFU accounting):
- 2 FLOPs per multiply-accumulate in matmuls and convolutions;
- elementwise ops, layernorms, softmax and the one-hot bias product (a
  kernel detail, not model semantics) are not counted;
- the rel-pos bias einsums ARE counted (reference model semantics:
  ``slowfast/models/attention.py:84-183``);
- the backward pass ~= 2x the forward's matmul and conv FLOPs, so a train
  forward and backward is 3x.

Pure Python: it keeps its own copy of the pool's output shape.
"""

from __future__ import annotations

from typing import Tuple

Triple = Tuple[int, int, int]


def out_shape(thw: Triple, kernel: Triple, stride: Triple) -> Triple:
    """Spatial output shape of a pool or conv with padding k // 2 (floor
    mode)."""
    return tuple(
        (d + 2 * (k // 2) - k) // s + 1 for d, k, s in zip(thw, kernel, stride)
    )


def _prod(t) -> int:
    r = 1
    for x in t:
        r *= int(x)
    return r


def forward_flops(arch, batch: int, t_in: int) -> float:
    """Matmul/conv FLOPs for one forward pass of ``batch`` clips of ``t_in``
    input frames (t_in=1 is the image path)."""
    # Stem: latent grid after the patch conv.
    k, s, p = arch.patch_kernel, arch.patch_stride, arch.patch_padding
    thw = tuple(
        (d + 2 * pp - kk) // ss + 1
        for d, kk, ss, pp in zip(
            (t_in, arch.crop_size, arch.crop_size), k, s, p
        )
    )
    total = 2.0 * _prod(thw) * arch.embed_dim * _prod(k) * arch.in_channels

    n_extras = (1 if arch.cls_embed_on else 0) + arch.num_obj_per_frame * t_in
    O = arch.num_obj_per_frame

    for spec in arch.blocks:
        dim, heads = spec.dim, spec.num_heads
        att_dim = spec.dim_out if arch.dim_mul_in_att else spec.dim
        q_l_in = _prod(thw)
        n_in = q_l_in + n_extras

        # qkv projection (3 matmuls over grid + extras tokens)
        total += 3 * 2.0 * n_in * dim * att_dim

        # pooling paths (depthwise convs; q once, k and v once each)
        q_shape = thw
        if spec.stride_q and _prod(spec.kernel_q) * _prod(spec.stride_q) != 1:
            q_shape = out_shape(thw, spec.kernel_q, spec.stride_q)
            total += 2.0 * _prod(q_shape) * att_dim * _prod(spec.kernel_q)
        k_shape = thw
        if spec.stride_kv and _prod(spec.kernel_kv) * _prod(spec.stride_kv) != 1:
            k_shape = out_shape(thw, spec.kernel_kv, spec.stride_kv)
            total += 2 * 2.0 * _prod(k_shape) * att_dim * _prod(spec.kernel_kv)

        n_q = _prod(q_shape)
        n_k = _prod(k_shape) + n_extras

        # rel-pos bias einsums (q x table per decomposed axis)
        if arch.rel_pos_temporal:
            total += 2.0 * n_q * att_dim * k_shape[0]
        if arch.rel_pos_spatial:
            total += 2.0 * n_q * att_dim * (k_shape[1] + k_shape[2])

        # attention: QK^T + PV for grid queries and extras queries
        total += 2 * 2.0 * n_q * n_k * att_dim
        total += 2 * 2.0 * n_extras * n_k * att_dim

        # output projection
        total += 2.0 * (n_q + n_extras) * att_dim * att_dim

        # dim-change projection: dim_mul_in_att applies it to the *input*
        # stream (pre-pool resolution); otherwise to the post-attention grid.
        if spec.dim != spec.dim_out:
            n_proj = n_in if arch.dim_mul_in_att else (n_q + n_extras)
            total += 2.0 * n_proj * dim * spec.dim_out

        # MLP
        hidden = int(att_dim * arch.mlp_ratio)
        total += 2.0 * (n_q + n_extras) * (
            att_dim * hidden + hidden * spec.dim_out
        )

        thw = q_shape

    # Head: cls projection + HAOG MLPs over object tokens.
    d = arch.final_dim
    nc = arch.num_classes
    if isinstance(nc, tuple):
        total += sum(2.0 * d * n for _, n in nc)
    else:
        total += 2.0 * d * int(nc)
    total += 2.0 * t_in * O * d * (4 + 1)  # boxes_mlp + boxes_bce_mlp
    total += 2.0 * t_in * 2 * d * 5        # contact_mlp (2 hand tokens)

    return float(total) * batch


def train_step_flops(
    arch,
    batch_video: int,
    batch_image: int,
    *,
    with_consistency: bool = True,
) -> float:
    """FLOPs of the fused train step: video fwd+bwd (3x fwd), image fwd+bwd,
    plus the no-grad frame-clip consistency forward (B*T single-frame passes,
    reference ``tools/train_net.py:105-110``)."""
    total = 3.0 * forward_flops(arch, batch_video, arch.num_frames)
    if batch_image:
        total += 3.0 * forward_flops(arch, batch_image, 1)
    if with_consistency:
        total += forward_flops(arch, batch_video * arch.num_frames, 1)
    return total
