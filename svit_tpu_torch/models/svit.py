"""SViT: MViTv2 video trunk + per-frame object tokens + HAOG head
(counterpart of ``svit_tpu/models/svit.py``).

- Token layout: the patch grid ``[B, T_lat, H, W, C]`` plus the extras
  ``[B, 1 + T_in*O, C]`` (cls, then O object tokens per *input* frame).
- Videos add a learned temporal pos-embed to the object tokens; single-frame
  (image) inputs do not.
- The block schedule (dim/head multipliers, q/kv pool strides with adaptive
  kv-stride propagation) is computed statically in ``SViTArch.from_cfg``.
- The head projects the cls token to class logits and the object tokens to
  HAOG predictions.

The model runs in ``dtype`` (parameters stay f32 master weights and are
cast at use, as the JAX package casts them) and, with ``use_kernels``,
through the hand-written CUDA kernels, forward and backward.  ``forward(x,
train=True, generator=g)`` (the default in train mode) is JAX's
``deterministic=False``: stochastic
depth, dropout and head dropout draw from ``g``, and the head returns raw
outputs (no softmax on the logits, no sigmoid on the presence logit, no
softmax on the contact logits), which the losses take.

``TPU.REMAT`` (``arch.remat``, flax ``nn.remat`` of each block in the JAX
package) runs each block under ``torch.utils.checkpoint`` whenever a
gradient is wanted: the forward keeps only the block's two input streams,
and the backward runs the block again through the same kernels (K1 to K4,
K3's argmax instance) before its backward kernels take the recomputed
values.  The block's random draws are kept from its forward and handed to
the recompute (``KeptDraws``), so the masks, the generator's state after
the step, the loss and the gradients are those of the step without remat,
bit for bit, eager and in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from svit_tpu_torch.models.attention import MultiScaleBlock
from svit_tpu_torch.models.common import KeptDraws, LayerNorm, dropout
from svit_tpu_torch.models.stem import PatchEmbed
from svit_tpu_torch.ops import ln_linear as ll

Triple = Tuple[int, int, int]


def round_width(width, multiplier, min_width=1, divisor=1):
    """MViT channel rounding (reference ``models/utils.py:16-29``)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    dim: int
    dim_out: int
    num_heads: int
    input_size: Triple
    kernel_q: Tuple[int, ...]
    kernel_kv: Tuple[int, ...]
    stride_q: Tuple[int, ...]
    stride_kv: Tuple[int, ...]
    drop_path: float


@dataclasses.dataclass(frozen=True)
class SViTArch:
    """Static architecture derived from a config (hashable)."""

    num_frames: int              # input frames (16)
    crop_size: int
    in_channels: int
    embed_dim: int
    depth: int
    num_obj_per_frame: int       # SVIT.O
    num_classes: Union[int, Tuple[Tuple[str, int], ...]]
    patch_kernel: Triple
    patch_stride: Triple
    patch_padding: Triple
    patch_dims: Triple           # latent (T, H, W)
    blocks: Tuple[BlockSpec, ...]
    final_dim: int
    mlp_ratio: float
    qkv_bias: bool
    mode: str
    cls_embed_on: bool
    use_abs_pos: bool
    sep_pos_embed: bool
    rel_pos_spatial: bool
    rel_pos_temporal: bool
    rel_pos_zero_init: bool
    residual_pooling: bool
    dim_mul_in_att: bool
    separate_qkv: bool
    norm_stem: bool
    drop_rate: float             # MVIT.DROPOUT_RATE
    head_dropout_rate: float     # MODEL.DROPOUT_RATE
    head_act: str
    forward_video_frames: bool
    remat: bool = False          # TPU.REMAT: recompute each block

    @classmethod
    def from_cfg(cls, cfg) -> "SViTArch":
        spatial = cfg.DATA.TRAIN_CROP_SIZE
        assert cfg.DATA.TRAIN_CROP_SIZE == cfg.DATA.TEST_CROP_SIZE
        temporal = cfg.DATA.NUM_FRAMES
        depth = cfg.MVIT.DEPTH
        embed_dim = cfg.MVIT.EMBED_DIM
        num_heads = cfg.MVIT.NUM_HEADS

        patch_stride = tuple(cfg.MVIT.PATCH_STRIDE)
        patch_dims = tuple(
            d // s
            for d, s in zip((temporal, spatial, spatial), patch_stride)
        )

        dim_mul = np.ones(depth + 1)
        head_mul = np.ones(depth + 1)
        for i, m in cfg.MVIT.DIM_MUL:
            dim_mul[i] = m
        for i, m in cfg.MVIT.HEAD_MUL:
            head_mul[i] = m

        pool_q = [()] * depth
        pool_kv = [()] * depth
        stride_q = [()] * depth
        stride_kv = [()] * depth
        for entry in cfg.MVIT.POOL_Q_STRIDE:
            i = entry[0]
            stride_q[i] = tuple(entry[1:])
            if cfg.MVIT.POOL_KVQ_KERNEL is not None:
                pool_q[i] = tuple(cfg.MVIT.POOL_KVQ_KERNEL)
            else:
                pool_q[i] = tuple(s + 1 if s > 1 else s for s in entry[1:])

        # Adaptive KV stride: start from POOL_KV_STRIDE_ADAPTIVE and divide by
        # each block's q stride as resolution shrinks (reference :156-165).
        pool_kv_stride = cfg.MVIT.POOL_KV_STRIDE
        if cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE is not None:
            _stride_kv = list(cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE)
            pool_kv_stride = []
            for i in range(depth):
                if len(stride_q[i]) > 0:
                    _stride_kv = [
                        max(_stride_kv[d] // stride_q[i][d], 1)
                        for d in range(len(_stride_kv))
                    ]
                pool_kv_stride.append([i] + _stride_kv)
        if pool_kv_stride:
            for entry in pool_kv_stride:
                i = entry[0]
                stride_kv[i] = tuple(entry[1:])
                if cfg.MVIT.POOL_KVQ_KERNEL is not None:
                    pool_kv[i] = tuple(cfg.MVIT.POOL_KVQ_KERNEL)
                else:
                    pool_kv[i] = tuple(
                        s + 1 if s > 1 else s for s in entry[1:]
                    )

        dpr = np.linspace(0, cfg.MVIT.DROPPATH_RATE, depth)

        blocks = []
        input_size = list(patch_dims)
        dim = embed_dim
        for i in range(depth):
            num_heads = round_width(num_heads, head_mul[i])
            if cfg.MVIT.DIM_MUL_IN_ATT:
                dim_out = round_width(
                    dim, dim_mul[i], divisor=round_width(num_heads, head_mul[i])
                )
            else:
                dim_out = round_width(
                    dim,
                    dim_mul[i + 1],
                    divisor=round_width(num_heads, head_mul[i + 1]),
                )
            blocks.append(
                BlockSpec(
                    dim=dim,
                    dim_out=dim_out,
                    num_heads=num_heads,
                    input_size=tuple(input_size),
                    kernel_q=pool_q[i],
                    kernel_kv=pool_kv[i],
                    stride_q=stride_q[i],
                    stride_kv=stride_kv[i],
                    drop_path=float(dpr[i]),
                )
            )
            if len(stride_q[i]) > 0:
                input_size = [
                    size // s for size, s in zip(input_size, stride_q[i])
                ]
            dim = dim_out

        num_classes = cfg.MODEL.NUM_CLASSES
        if cfg.TRAIN.DATASET == "epickitchens":
            num_classes = (("verb", 97), ("noun", 300))

        return cls(
            num_frames=temporal,
            crop_size=spatial,
            in_channels=cfg.DATA.INPUT_CHANNEL_NUM[0],
            embed_dim=embed_dim,
            depth=depth,
            num_obj_per_frame=cfg.SVIT.O,
            num_classes=num_classes,
            patch_kernel=tuple(cfg.MVIT.PATCH_KERNEL),
            patch_stride=patch_stride,
            patch_padding=tuple(cfg.MVIT.PATCH_PADDING),
            patch_dims=patch_dims,
            blocks=tuple(blocks),
            final_dim=dim,
            mlp_ratio=cfg.MVIT.MLP_RATIO,
            qkv_bias=cfg.MVIT.QKV_BIAS,
            mode=cfg.MVIT.MODE,
            cls_embed_on=cfg.MVIT.CLS_EMBED_ON,
            use_abs_pos=cfg.MVIT.USE_ABS_POS,
            sep_pos_embed=cfg.MVIT.SEP_POS_EMBED,
            rel_pos_spatial=cfg.MVIT.REL_POS_SPATIAL,
            rel_pos_temporal=cfg.MVIT.REL_POS_TEMPORAL,
            rel_pos_zero_init=cfg.MVIT.REL_POS_ZERO_INIT,
            residual_pooling=cfg.MVIT.RESIDUAL_POOLING,
            dim_mul_in_att=cfg.MVIT.DIM_MUL_IN_ATT,
            separate_qkv=cfg.MVIT.SEPARATE_QKV,
            norm_stem=cfg.MVIT.NORM_STEM,
            drop_rate=cfg.MVIT.DROPOUT_RATE,
            head_dropout_rate=cfg.MODEL.DROPOUT_RATE,
            head_act=cfg.MODEL.HEAD_ACT,
            forward_video_frames=cfg.TRAIN.FORWARD_VIDEO_FRAMES,
            remat=cfg.TPU.REMAT,
        )


def _head_act(x, act: str):
    if act == "softmax":
        return torch.softmax(x.float(), dim=-1).to(x.dtype)
    if act == "sigmoid":
        return torch.sigmoid(x)
    raise NotImplementedError(f"head activation {act}")


def _dense(x, layer: nn.Linear):
    """A Linear in the activation dtype: rounded product, bias added in the
    IO dtype (flax ``nn.Dense(dtype=...)``)."""
    return ll.dense(x, layer.weight, layer.bias)


class SViTHead(nn.Module):
    """Classification + HAOG head over [cls | object] tokens."""

    def __init__(self, arch: "SViTArch"):
        super().__init__()
        self.arch = arch
        C = arch.final_dim
        nc = arch.num_classes
        if isinstance(nc, tuple):  # multitask (e.g. EPIC-Kitchens verb/noun)
            self.projection = nn.ModuleDict(
                {name: nn.Linear(C, n) for name, n in nc})
        elif nc > 0:
            self.projection = nn.Linear(C, nc)
        else:
            self.projection = None
        self.boxes_mlp = nn.Sequential(nn.Linear(C, 4))
        self.boxes_bce_mlp = nn.Linear(C, 1)
        self.contact_mlp = nn.Linear(C, 5)

    def forward(self, x, t_in: int, train: bool = False, generator=None):
        arch = self.arch
        if train and arch.head_dropout_rate > 0:
            x = dropout(x, arch.head_dropout_rate, generator)
        B = x.shape[0]

        def act(t):
            return t if train else _head_act(t, arch.head_act)

        cls_tok, xobj = x[:, 0], x[:, 1:]
        obj_desc = xobj.reshape(B, t_in, -1, xobj.shape[-1])
        extra = {"obj_desc": obj_desc}
        if isinstance(self.projection, nn.ModuleDict):
            raw = {n: _dense(cls_tok, p) for n, p in self.projection.items()}
            logits = {n: act(r) for n, r in raw.items()}
            extra.update(logits)
            extra["raw_logits"] = raw
        elif self.projection is None:
            logits = cls_tok.new_zeros(cls_tok.shape[:-1] + (0,))
        else:
            raw = _dense(cls_tok, self.projection)
            extra["raw_logits"] = raw
            logits = act(raw)
        boxes = torch.sigmoid(_dense(obj_desc, self.boxes_mlp[0]))
        boxes_bce = _dense(obj_desc, self.boxes_bce_mlp)
        contact = _dense(obj_desc[:, :, :2], self.contact_mlp)
        if not train:
            boxes_bce = torch.sigmoid(boxes_bce)
            contact = torch.softmax(contact.float(), dim=-1).to(contact.dtype)
        extra["pred_bboxes"] = torch.cat([boxes_bce, boxes], dim=-1)
        extra["pred_contact_state"] = contact
        return logits, extra


class SViT(nn.Module):
    """Full SViT model.  Input: channels-last clip [B, T, H, W, C];
    ``T == 1`` is the image path.  Returns ``(logits, extra_preds)`` with
    ``raw_logits``, ``obj_desc``, ``pred_bboxes`` and ``pred_contact_state``
    in ``extra_preds``."""

    def __init__(self, arch: SViTArch, dtype=torch.float32,
                 use_kernels: bool = False):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.use_kernels = use_kernels
        C = arch.embed_dim
        self.patch_embed = PatchEmbed(arch.in_channels, C, arch.patch_kernel,
                                      arch.patch_stride, arch.patch_padding)
        self.pos_embed_temporal = nn.Parameter(torch.zeros(1, arch.num_frames, C))
        if arch.cls_embed_on:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        if arch.use_abs_pos:
            if not arch.sep_pos_embed:
                raise NotImplementedError(
                    "non-separable abs pos-embed is dead code in the reference")
            self.pos_embed_spatial = nn.Parameter(
                torch.zeros(1, arch.patch_dims[1] * arch.patch_dims[2], C))
            if arch.cls_embed_on:
                self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, C))
        self.object_queries = nn.Parameter(
            torch.zeros(1, arch.num_obj_per_frame, C))
        self.blocks = nn.ModuleList([
            MultiScaleBlock(
                s.dim, s.dim_out, s.num_heads, s.input_size,
                mlp_ratio=arch.mlp_ratio, qkv_bias=arch.qkv_bias,
                kernel_q=s.kernel_q, kernel_kv=s.kernel_kv,
                stride_q=s.stride_q, stride_kv=s.stride_kv, mode=arch.mode,
                has_cls=arch.cls_embed_on,
                rel_pos_spatial=arch.rel_pos_spatial,
                rel_pos_temporal=arch.rel_pos_temporal,
                residual_pooling=arch.residual_pooling,
                dim_mul_in_att=arch.dim_mul_in_att,
                separate_qkv=arch.separate_qkv, drop_path=s.drop_path,
                drop_rate=arch.drop_rate)
            for s in arch.blocks
        ])
        if arch.norm_stem:
            self.norm_stem = LayerNorm(C)
        self.norm = LayerNorm(arch.final_dim)
        self.head = SViTHead(arch)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights following the JAX package's initialisers: dense and
        stem weights normal with std 1/sqrt(fan_in), biases 0, LN 1/0, pool
        filters uniform(+-sqrt(3/fan_in)), tokens and rel-pos tables normal
        with std 0.02."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            cpu = torch.empty(p.shape, dtype=torch.float32)
            if ".norm" in name or name.startswith("norm"):
                cpu.fill_(1.0 if leaf == "weight" else 0.0)
            elif ".pool_" in name:
                bound = math.sqrt(3.0 / float(np.prod(p.shape[1:])))
                cpu.uniform_(-bound, bound, generator=generator)
            elif leaf == "bias":
                cpu.zero_()
            elif leaf == "weight":
                cpu.normal_(0.0, 1.0 / math.sqrt(float(np.prod(p.shape[1:]))),
                            generator=generator)
            else:
                cpu.normal_(0.0, 0.02, generator=generator)
            p.copy_(cpu)

    def forward(self, x: torch.Tensor, train=None, generator=None,
                cache=None, capture_gradcam=False):
        """``train`` defaults to the module's mode (``self.training``);
        ``cache`` is a train step's ``StepCache`` (the casts and derived
        parameters made once for its three forwards).

        ``capture_gradcam`` adds a zero-valued leaf that requires grad to
        each block's grid output (the JAX model's ``capture_gradcam``
        perturbations, ``svit_tpu/models/svit.py:449-451``): the gradient
        of a score with respect to ``extra["perturbations"]["blocks_<i>_out"]``
        is its gradient with respect to that block's output, which
        ``extra["intermediates"]`` holds under the same name."""
        arch = self.arch
        train = self.training if train is None else train
        dt = self.dtype
        B, t_in = x.shape[0], x.shape[1]
        is_video = t_in > 1
        grid, (t_lat, H, W) = self.patch_embed(x.to(dt), cache)
        C = arch.embed_dim

        if arch.use_abs_pos:
            pos = self.pos_embed_spatial.view(1, 1, H, W, C)
            if is_video:
                pos = pos + self.pos_embed_temporal[:, :t_lat, None, None, :]
            grid = grid + pos.to(dt)
        x_obj = self.object_queries[:, None].expand(
            B, t_in, arch.num_obj_per_frame, C)
        if is_video:
            x_obj = x_obj + self.pos_embed_temporal[:, :t_in, None, :]
        extras = x_obj.reshape(B, t_in * arch.num_obj_per_frame, C).to(dt)
        if arch.cls_embed_on:
            cls_tok = self.cls_token.expand(B, 1, C).to(dt)
            if arch.use_abs_pos:
                cls_tok = cls_tok + self.pos_embed_class.to(dt)
            extras = torch.cat([cls_tok, extras], dim=1)
        if train and arch.drop_rate > 0:
            grid = dropout(grid, arch.drop_rate, generator)
            extras = dropout(extras, arch.drop_rate, generator)
        if arch.norm_stem:
            grid, extras = self.norm_stem(grid), self.norm_stem(extras)

        points, acts = {}, {}
        for i, blk in enumerate(self.blocks):
            grid, extras = self._block(blk, grid, extras, train, generator,
                                       cache)
            if capture_gradcam:
                name = f"blocks_{i}_out"
                acts[name] = grid
                points[name] = torch.zeros_like(grid, requires_grad=True)
                grid = grid + points[name]

        if arch.cls_embed_on:
            # LN is per-token: only [cls | obj] feeds the head
            head_in = self.norm(extras)
        else:
            g = self.norm(grid)
            cls_tok = g.reshape(B, -1, g.shape[-1]).mean(dim=1, keepdim=True)
            head_in = torch.cat([cls_tok, self.norm(extras)], dim=1)
        logits, extra = self.head(head_in, t_in, train, generator)
        if capture_gradcam:
            extra["perturbations"], extra["intermediates"] = points, acts
        return logits, extra

    def _block(self, blk, grid, extras, train, generator, cache):
        """One block; under ``arch.remat`` with a gradient wanted, its
        checkpoint: the inputs kept, the rest recomputed in the backward
        with the masks its forward drew."""
        args = (self.use_kernels, self.dtype, train)
        if not (self.arch.remat and torch.is_grad_enabled()):
            return blk(grid, extras, *args, generator, cache)
        draws = KeptDraws(generator)

        def run(grid, extras):
            draws.start()
            return blk(grid, extras, *args, draws, cache)

        return checkpoint(run, grid, extras, use_reentrant=False,
                          preserve_rng_state=False)
