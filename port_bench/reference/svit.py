"""The benchmark's plain reference: SViT on an MViTv2 trunk, its losses and
its AdamW step, in plain PyTorch and float32.

Written from the published models (MViTv2: Li et al., CVPR 2022, with
decomposed relative positions and residual pooling; SViT: Ben Avraham et
al., NeurIPS 2022, four object tokens a frame, the HAOG head and the
frame-clip consistency loss), op by op, with no kernel, no fused op, no
cache and no batching trick.  It imports nothing of the program: the
benchmark hands it the configuration (a nested dict read from the cell's
YAML), the weights and the inputs, and it works out everything else
again.  Parameter names follow the state dict that the program's module
holds, so that one set of weights can be handed to both.

Layout: clips are channels-last ``[B, T, H, W, 3]``; a one-frame clip is
the image path.  The residual stream is the patch grid ``[B, T, H, W, C]``
and the extra tokens ``[B, 1 + T * O, C]`` (cls, then O object tokens per
input frame); keys and values of every attention are the grid's and the
extras' together.

``prec`` selects the arithmetic of every product (linear layers, the
patch convolution, the attention's two products, the rel-pos terms):
``"f32"`` (the reference), ``"fp8"`` (each operand rounded to
float8 e4m3 with a per-tensor scale, forward and backward, the sums in
f32): the control that stands a precision below the configured bf16, or
``"fp8_bwd"`` (the forward in f32, the backward's products on fp8
operands): the same control confined to the backward.

Random draws (stochastic depth, head dropout) are made by the caller for
the whole batch, in the order a forward draws them (``draw_masks``), so a
forward may run in blocks of rows with the same masks.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0


def _tup(v) -> tuple:
    if isinstance(v, str):
        v = ast.literal_eval(v)
    return tuple(int(x) for x in v)


# ---------------------------------------------------------------------------
# The block schedule
# ---------------------------------------------------------------------------

def round_width(width, multiplier, min_width=1, divisor=1):
    """MViT's channel rounding."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


@dataclasses.dataclass(frozen=True)
class Block:
    dim: int
    dim_out: int
    num_heads: int
    input_size: Tuple[int, int, int]
    kernel_q: tuple
    kernel_kv: tuple
    stride_q: tuple
    stride_kv: tuple
    drop_path: float

    @property
    def head_dim(self) -> int:
        return self.dim_out // self.num_heads

    @property
    def pool_q(self) -> bool:
        return _pools(self.kernel_q, self.stride_q)

    @property
    def pool_kv(self) -> bool:
        return _pools(self.kernel_kv, self.stride_kv)


def _pools(kernel, stride) -> bool:
    if not kernel or not stride:
        return False
    return int(np.prod(kernel)) != 1 or int(np.prod(stride)) != 1


@dataclasses.dataclass(frozen=True)
class Arch:
    """What the configuration fixes of the model."""

    num_frames: int
    crop_size: int
    in_channels: int
    embed_dim: int
    num_obj_per_frame: int
    num_classes: int
    patch_kernel: tuple
    patch_stride: tuple
    patch_padding: tuple
    patch_dims: tuple
    blocks: Tuple[Block, ...]
    final_dim: int
    mlp_ratio: float
    head_dropout_rate: float
    cls_embed_on: bool
    rel_pos_spatial: bool
    rel_pos_temporal: bool
    dim_mul_in_att: bool


def arch_from_cfg(cfg: dict) -> Arch:
    """The schedule of ``cfg`` (the cell's YAML as a nested dict): MViTv2's
    stage multipliers, q strides and the adaptive k|v stride."""
    mv, data = cfg["MVIT"], cfg["DATA"]
    _refuse(cfg)
    S, T = int(data["TRAIN_CROP_SIZE"]), int(data["NUM_FRAMES"])
    depth, heads = int(mv["DEPTH"]), int(mv["NUM_HEADS"])
    stride = _tup(mv["PATCH_STRIDE"])
    patch_dims = tuple(d // s for d, s in zip((T, S, S), stride))
    dim_mul, head_mul = np.ones(depth + 1), np.ones(depth + 1)
    for i, m in mv["DIM_MUL"]:
        dim_mul[int(i)] = m
    for i, m in mv["HEAD_MUL"]:
        head_mul[int(i)] = m
    kvq = mv.get("POOL_KVQ_KERNEL")
    stride_q, kernel_q = [()] * depth, [()] * depth
    for e in mv["POOL_Q_STRIDE"]:
        stride_q[int(e[0])] = tuple(int(x) for x in e[1:])
        kernel_q[int(e[0])] = (_tup(kvq) if kvq is not None else
                               tuple(s + 1 if s > 1 else s for s in e[1:]))
    stride_kv, kernel_kv = [()] * depth, [()] * depth
    skv = list(_tup(mv["POOL_KV_STRIDE_ADAPTIVE"]))
    for i in range(depth):
        if stride_q[i]:
            skv = [max(skv[d] // stride_q[i][d], 1) for d in range(3)]
        stride_kv[i] = tuple(skv)
        kernel_kv[i] = (_tup(kvq) if kvq is not None else
                        tuple(s + 1 if s > 1 else s for s in skv))
    dpr = np.linspace(0, float(mv["DROPPATH_RATE"]), depth)
    blocks, size, dim = [], list(patch_dims), int(mv["EMBED_DIM"])
    for i in range(depth):
        heads = round_width(heads, head_mul[i])
        dim_out = round_width(dim, dim_mul[i],
                              divisor=round_width(heads, head_mul[i]))
        blocks.append(Block(dim, dim_out, heads, tuple(size), kernel_q[i],
                            kernel_kv[i], stride_q[i], stride_kv[i],
                            float(dpr[i])))
        if stride_q[i]:
            size = [n // s for n, s in zip(size, stride_q[i])]
        dim = dim_out
    return Arch(
        num_frames=T, crop_size=S,
        in_channels=int(data["INPUT_CHANNEL_NUM"][0]),
        embed_dim=int(mv["EMBED_DIM"]), num_obj_per_frame=int(cfg["SVIT"]["O"]),
        num_classes=int(cfg["MODEL"]["NUM_CLASSES"]),
        patch_kernel=_tup(mv["PATCH_KERNEL"]), patch_stride=stride,
        patch_padding=_tup(mv["PATCH_PADDING"]), patch_dims=patch_dims,
        blocks=tuple(blocks), final_dim=dim,
        mlp_ratio=float(mv["MLP_RATIO"]),
        head_dropout_rate=float(cfg["MODEL"]["DROPOUT_RATE"]),
        cls_embed_on=bool(mv["CLS_EMBED_ON"]),
        rel_pos_spatial=bool(mv["REL_POS_SPATIAL"]),
        rel_pos_temporal=bool(mv["REL_POS_TEMPORAL"]),
        dim_mul_in_att=bool(mv["DIM_MUL_IN_ATT"]))


def _refuse(cfg: dict) -> None:
    """The options this reference writes out; anything else is refused
    rather than guessed."""
    mv = cfg["MVIT"]
    want = {("MVIT", "MODE"): "conv", ("MVIT", "CLS_EMBED_ON"): True,
            ("MVIT", "USE_ABS_POS"): False, ("MVIT", "NORM_STEM"): False,
            ("MVIT", "SEPARATE_QKV"): False, ("MVIT", "QKV_BIAS"): True,
            ("MVIT", "RESIDUAL_POOLING"): True,
            ("MVIT", "DIM_MUL_IN_ATT"): True, ("MVIT", "DROPOUT_RATE"): 0.0,
            ("MODEL", "HEAD_ACT"): "softmax", ("SOLVER", "OPTIMIZING_METHOD"):
            "adamw", ("MIXUP", "ENABLE"): False, ("TPU", "DEVICE_AUG"): False,
            ("TPU", "MESH_MODEL"): 1}
    for (a, b), v in want.items():
        if cfg[a][b] != v:
            raise NotImplementedError(f"reference: {a}.{b} = {cfg[a][b]!r}")
    if mv.get("POOL_KV_STRIDE") is not None:
        raise NotImplementedError("reference: fixed POOL_KV_STRIDE")


# ---------------------------------------------------------------------------
# Parameters: names, shapes and how each is initialised
# ---------------------------------------------------------------------------

def param_specs(arch: Arch) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, sorted by name.  ``init``:
    ``one`` / ``zero`` (LayerNorms and biases), ``fan_in`` (normal with std
    1 / sqrt(fan-in)), ``pool`` (uniform within sqrt(3 / fan-in)),
    ``token`` (normal, std 0.02)."""
    C, O = arch.embed_dim, arch.num_obj_per_frame
    out = []

    def add(name, shape, init):
        out.append((name, tuple(int(s) for s in shape), init))

    def linear(name, n_in, n_out):
        add(name + ".weight", (n_out, n_in), "fan_in")
        add(name + ".bias", (n_out,), "zero")

    def norm(name, n):
        add(name + ".weight", (n,), "one")
        add(name + ".bias", (n,), "zero")

    add("patch_embed.proj.weight", (C, arch.in_channels, *arch.patch_kernel),
        "fan_in")
    add("patch_embed.proj.bias", (C,), "zero")
    add("pos_embed_temporal", (1, arch.num_frames, C), "token")
    add("cls_token", (1, 1, C), "token")
    add("object_queries", (1, O, C), "token")
    for i, b in enumerate(arch.blocks):
        p = f"blocks.{i}."
        norm(p + "norm1", b.dim)
        linear(p + "attn.qkv", b.dim, 3 * b.dim_out)
        linear(p + "attn.proj", b.dim_out, b.dim_out)
        for n, k, on in (("q", b.kernel_q, b.pool_q),
                         ("k", b.kernel_kv, b.pool_kv),
                         ("v", b.kernel_kv, b.pool_kv)):
            if on:
                add(p + f"attn.pool_{n}.weight", (b.head_dim, 1, *k), "pool")
                norm(p + f"attn.norm_{n}", b.head_dim)
        if arch.rel_pos_spatial:
            size = b.input_size[1]
            sq = b.stride_q[1] if b.pool_q else 1
            skv = b.stride_kv[1] if b.pool_kv else 1
            sp = 2 * max(size // sq, size // skv) - 1
            add(p + "attn.rel_pos_h", (sp, b.head_dim), "token")
            add(p + "attn.rel_pos_w", (sp, b.head_dim), "token")
        if arch.rel_pos_temporal:
            add(p + "attn.rel_pos_t", (2 * b.input_size[0] - 1, b.head_dim),
                "token")
        norm(p + "norm2", b.dim_out)
        hidden = int(b.dim_out * arch.mlp_ratio)
        linear(p + "mlp.fc1", b.dim_out, hidden)
        linear(p + "mlp.fc2", hidden, b.dim_out)
        if b.dim != b.dim_out:
            linear(p + "proj", b.dim, b.dim_out)
    norm("norm", arch.final_dim)
    linear("head.projection", arch.final_dim, arch.num_classes)
    linear("head.boxes_mlp.0", arch.final_dim, 4)
    linear("head.boxes_bce_mlp", arch.final_dim, 1)
    linear("head.contact_mlp", arch.final_dim, 5)
    return sorted(out)


# ---------------------------------------------------------------------------
# Products, in f32 or in the fp8 control
# ---------------------------------------------------------------------------

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


class _RoundIn(torch.autograd.Function):
    """An operand rounded to fp8; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """A product's output as it is; its gradient rounded to fp8, so the
    backward's products take fp8 operands too."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def product(fn, a, b, prec: str):
    if prec == "f32":
        return fn(a, b)
    if prec not in ("fp8", "fp8_bwd"):
        raise ValueError(prec)
    low = _RoundGrad.apply(fn(_RoundIn.apply(a), _RoundIn.apply(b)))
    if prec == "fp8":
        return low
    # the value of the f32 product, the gradient of the fp8 one
    with torch.no_grad():
        exact = fn(a, b)
    return exact + (low - low.detach())


def linear(x, w, b, prec):
    y = product(lambda x, w: x @ w.t(), x, w, prec)
    return y if b is None else y + b


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, EPS)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

def keep_of(block: Block) -> float:
    return 1.0 - block.drop_path


def draw_masks(arch: Arch, B: int, t_in: int, generator, device) -> dict:
    """The train forward's random draws for a batch of ``B`` clips of
    ``t_in`` frames, in the order the forward makes them: two per-sample
    keep masks per block with a drop-path rate (uniform < keep), then the
    head dropout's mask over the head's input."""
    out = {"blocks": []}
    for b in arch.blocks:
        if b.drop_path > 0:
            keep = keep_of(b)
            out["blocks"].append(tuple(
                (torch.rand((B,), generator=generator, device=device) < keep)
                .float() for _ in range(2)))
        else:
            out["blocks"].append(None)
    E = (1 if arch.cls_embed_on else 0) + t_in * arch.num_obj_per_frame
    if arch.head_dropout_rate > 0:
        out["head"] = torch.rand((B, E, arch.final_dim), generator=generator,
                                 device=device) < 1.0 - arch.head_dropout_rate
    return out


def rows_of(masks: Optional[dict], lo: int, hi: int) -> Optional[dict]:
    if masks is None:
        return None
    return {"blocks": [None if m is None else (m[0][lo:hi], m[1][lo:hi])
                       for m in masks["blocks"]],
            "head": masks["head"][lo:hi] if "head" in masks else None}


def _rel_table(rel_pos, q_n, k_n):
    """MViTv2's decomposed table: resized linearly to 2 max(q, k) - 1 rows
    (half-pixel sampling), indexed by the scaled distance."""
    d = 2 * max(q_n, k_n) - 1
    if rel_pos.shape[0] != d:
        rel_pos = F.interpolate(rel_pos.t()[None], size=d,
                                mode="linear")[0].t()
    q_ratio, k_ratio = max(k_n / q_n, 1.0), max(q_n / k_n, 1.0)
    dist = (torch.arange(q_n, dtype=torch.float64)[:, None] * q_ratio
            - torch.arange(k_n, dtype=torch.float64)[None, :] * k_ratio)
    idx = (dist + (k_n - 1) * k_ratio).long().to(rel_pos.device)
    return rel_pos[idx]


def _pool(P, pre, name, grid, extras, kernel, stride, heads):
    """MViTv2's attention pool of one of q, k or v: the depthwise conv of
    each head's channels (one filter shared by the heads), then the
    per-head LayerNorm.  The object tokens take the conv of a constant
    window (the mean of its outputs), cls passes, and both are normed."""
    w = P[pre + f"pool_{name}.weight"]
    lw, lb = P[pre + f"norm_{name}.weight"], P[pre + f"norm_{name}.bias"]
    B, T, H, W, C = grid.shape
    hd = C // heads
    pad = tuple(k // 2 for k in kernel)
    x = grid.reshape(B, T, H, W, heads, hd).permute(0, 4, 5, 1, 2, 3)
    y = F.conv3d(x.reshape(B * heads, hd, T, H, W), w, stride=tuple(stride),
                 padding=pad, groups=hd)
    To, Ho, Wo = y.shape[2:]
    y = y.reshape(B, heads, hd, To, Ho, Wo).permute(0, 3, 4, 5, 1, 2)
    y = layer_norm(y, lw, lb).reshape(B, To, Ho, Wo, C)
    ones = torch.ones((1, hd, *kernel), dtype=w.dtype, device=w.device)
    mult = F.conv3d(ones, w, stride=tuple(stride), padding=pad,
                    groups=hd).mean(dim=(2, 3, 4))[0]
    e = extras.reshape(*extras.shape[:2], heads, hd)
    e = torch.cat([e[:, :1], e[:, 1:] * mult], dim=1)
    return y, layer_norm(e, lw, lb).reshape(extras.shape)


def _heads(t, heads):
    B, N, C = t.shape
    return t.reshape(B, N, heads, C // heads).transpose(1, 2)


def _attention(P, pre, blk: Block, arch: Arch, grid, extras, prec):
    """Block ``pre``'s pooled attention (norm1 first) with residual pooling
    and the decomposed rel-pos bias; returns the projected outputs of the
    grid and the extras."""
    C, heads, hd = blk.dim_out, blk.num_heads, blk.head_dim
    ln = (P[pre + "norm1.weight"], P[pre + "norm1.bias"])
    pre = pre + "attn."
    wqkv, bqkv = P[pre + "qkv.weight"], P[pre + "qkv.bias"]
    qkv_g = linear(layer_norm(grid, *ln), wqkv, bqkv, prec)
    qkv_e = linear(layer_norm(extras, *ln), wqkv, bqkv, prec)
    parts = {n: (qkv_g[..., i * C:(i + 1) * C], qkv_e[..., i * C:(i + 1) * C])
             for i, n in enumerate("qkv")}
    for n in "qkv":
        kernel, stride, on = ((blk.kernel_q, blk.stride_q, blk.pool_q)
                              if n == "q" else
                              (blk.kernel_kv, blk.stride_kv, blk.pool_kv))
        if on:
            parts[n] = _pool(P, pre, n, *parts[n], kernel, stride, heads)
    qg, qe = parts["q"]
    B = qg.shape[0]
    q_shape, k_shape = tuple(qg.shape[1:4]), tuple(parts["k"][0].shape[1:4])
    nq, ng = int(np.prod(q_shape)), int(np.prod(k_shape))
    k = _heads(torch.cat([parts["k"][0].reshape(B, ng, C), parts["k"][1]], 1),
               heads)
    v = _heads(torch.cat([parts["v"][0].reshape(B, ng, C), parts["v"][1]], 1),
               heads)
    scale = hd ** -0.5
    qgh = _heads(qg.reshape(B, nq, C), heads)
    logits = product(lambda a, b: a @ b.transpose(-1, -2), qgh * scale, k,
                     prec)
    # the decomposed rel-pos bias of the grid queries over the grid keys
    qr = qgh.reshape(B, heads, *q_shape, hd)
    bias = torch.zeros((B, heads, *q_shape, *k_shape), dtype=logits.dtype,
                       device=logits.device)
    tables = ((arch.rel_pos_temporal, "rel_pos_t", 0),
              (arch.rel_pos_spatial, "rel_pos_h", 1),
              (arch.rel_pos_spatial, "rel_pos_w", 2))
    for on, name, axis in tables:
        if not on:
            continue
        table = _rel_table(P[pre + name], q_shape[axis], k_shape[axis])
        eq = ["bhtyxd,tkd->bhtyxk", "bhtyxd,ykd->bhtyxk",
              "bhtyxd,xkd->bhtyxk"][axis]
        term = product(lambda a, b: torch.einsum(eq, a, b), qr, table, prec)
        view = [B, heads, *q_shape, 1, 1, 1]
        view[5 + axis] = k_shape[axis]
        bias = bias + term.reshape(view)
    bias = bias.reshape(B, heads, nq, ng)
    logits = torch.cat([logits[..., :ng] + bias, logits[..., ng:]], dim=-1)
    p = torch.softmax(logits, dim=-1)
    og = product(lambda a, b: a @ b, p, v, prec) + qgh
    qeh = _heads(qe, heads)
    pe = torch.softmax(product(lambda a, b: a @ b.transpose(-1, -2),
                               qeh * scale, k, prec), dim=-1)
    oe = product(lambda a, b: a @ b, pe, v, prec)
    # residual pooling adds q to every extra token but cls
    oe = torch.cat([oe[:, :, :1], oe[:, :, 1:] + qeh[:, :, 1:]], dim=2)
    wp, bp = P[pre + "proj.weight"], P[pre + "proj.bias"]
    og = linear(og.transpose(1, 2).reshape(B, nq, C), wp, bp, prec)
    oe = linear(oe.transpose(1, 2).reshape(B, -1, C), wp, bp, prec)
    return og.reshape(B, *q_shape, C), oe


def _block(P, i, blk: Block, arch: Arch, grid, extras, masks, prec):
    pre = f"blocks.{i}."
    ag, ae = _attention(P, pre, blk, arch, grid, extras, prec)
    if blk.dim != blk.dim_out:
        ln = (P[pre + "norm1.weight"], P[pre + "norm1.bias"])
        w, b = P[pre + "proj.weight"], P[pre + "proj.bias"]
        grid = linear(layer_norm(grid, *ln), w, b, prec)
        extras = linear(layer_norm(extras, *ln), w, b, prec)
    if blk.stride_q and int(np.prod(blk.stride_q)) > 1:
        kernel = tuple(s + 1 if s > 1 else s for s in blk.stride_q)
        pooled = F.max_pool3d(grid.permute(0, 4, 1, 2, 3), kernel,
                              blk.stride_q, tuple(k // 2 for k in kernel))
        grid = pooled.permute(0, 2, 3, 4, 1)

    def mlp(x):
        h = F.gelu(linear(x, P[pre + "mlp.fc1.weight"],
                          P[pre + "mlp.fc1.bias"], prec))
        return linear(h, P[pre + "mlp.fc2.weight"], P[pre + "mlp.fc2.bias"],
                      prec)

    ln2 = (P[pre + "norm2.weight"], P[pre + "norm2.bias"])
    if masks is None:
        grid = grid + ag
        extras = extras + ae
        return (grid + mlp(layer_norm(grid, *ln2)),
                extras + mlp(layer_norm(extras, *ln2)))
    keep = keep_of(blk)
    m1, m2 = masks

    def scaled(t, m):
        return t / keep * m.view(-1, *([1] * (t.dim() - 1)))

    grid = grid + scaled(ag, m1)
    extras = extras + scaled(ae, m1)
    return (grid + scaled(mlp(layer_norm(grid, *ln2)), m2),
            extras + scaled(mlp(layer_norm(extras, *ln2)), m2))


def forward(P: Dict[str, torch.Tensor], arch: Arch, x, masks=None,
            prec: str = "f32"):
    """SViT on clips ``x [B, T, H, W, 3]``.  With ``masks`` (``draw_masks``'
    rows of this batch) the train forward: stochastic depth, head dropout
    and raw outputs; without, the eval forward with softmax'd logits.
    Returns ``(logits, extra)``: ``obj_desc [B, T, O, C]``, ``pred_bboxes
    [B, T, O, 5]`` (presence logit, cxcywh), ``pred_contact_state [B, T,
    2, 5]``."""
    x = x.float()
    B, t_in = x.shape[:2]
    O, C = arch.num_obj_per_frame, arch.embed_dim
    w, b = P["patch_embed.proj.weight"], P["patch_embed.proj.bias"]
    grid = product(lambda a, w: F.conv3d(a, w, None, arch.patch_stride,
                                         arch.patch_padding),
                   x.permute(0, 4, 1, 2, 3), w, prec)
    grid = (grid + b.view(1, -1, 1, 1, 1)).permute(0, 2, 3, 4, 1)
    obj = P["object_queries"][:, None].expand(B, t_in, O, C)
    if t_in > 1:
        obj = obj + P["pos_embed_temporal"][:, :t_in, None, :]
    extras = torch.cat([P["cls_token"].expand(B, 1, C),
                        obj.reshape(B, t_in * O, C)], dim=1)
    for i, blk in enumerate(arch.blocks):
        grid, extras = _block(P, i, blk, arch, grid, extras,
                              None if masks is None else masks["blocks"][i],
                              prec)
    h = layer_norm(extras, P["norm.weight"], P["norm.bias"])
    if masks is not None and masks.get("head") is not None:
        h = torch.where(masks["head"], h / (1.0 - arch.head_dropout_rate),
                        torch.zeros((), device=h.device))
    cls_tok, obj_desc = h[:, 0], h[:, 1:].reshape(B, t_in, O, -1)

    def lin(t, name):
        return linear(t, P[f"head.{name}.weight"], P[f"head.{name}.bias"],
                      prec)

    raw = lin(cls_tok, "projection")
    boxes = torch.sigmoid(lin(obj_desc, "boxes_mlp.0"))
    presence = lin(obj_desc, "boxes_bce_mlp")
    contact = lin(obj_desc[:, :, :2], "contact_mlp")
    extra = {"obj_desc": obj_desc, "raw_logits": raw,
             "pred_bboxes": torch.cat([presence, boxes], dim=-1),
             "pred_contact_state": contact}
    logits = raw if masks is not None else torch.softmax(raw, dim=-1)
    return logits, extra
