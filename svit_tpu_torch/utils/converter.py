"""Parameter names and loading (counterpart of ``svit_tpu/utils/converter.py``).

The port's parameter names are the PyTorch reference's state-dict names
(``blocks.3.attn.qkv.weight``, ``head.boxes_mlp.0.bias``, ...), so a
reference ``.pyth`` checkpoint loads with ``load_state_dict(strict=True)``
and JAX parameters cross over through ``params_from_jax``.  A released
checkpoint differs from the port's in two ways, which
``reference_to_port`` and ``port_to_reference`` undo and redo: it expects
BGR input (``flip_input_channels``), and its q, k and v projections may be
fused or separate where the model wants the other (``convert_qkv``).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def load_torch_state(path: str, clear_patterns=(), replace_patterns=()
                     ) -> Dict[str, torch.Tensor]:
    """Read a ``.pyth``/``.pt``/``.pth`` checkpoint into {name: tensor}.

    ``clear_patterns`` strips substrings from names and ``replace_patterns``
    rewrites (old, new) pairs: the reference's
    ``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN`` / ``_REPLACE_NAME_PATTERN``.
    """
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("model_state", blob.get("state_dict", blob))
    out = {}
    for k, v in state.items():
        if k.startswith("module."):
            k = k[len("module."):]
        for pat in clear_patterns:
            k = k.replace(pat, "")
        for old, new in replace_patterns:
            k = k.replace(old, new)
        out[k] = v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v))
    return out


def flip_input_channels(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Reverse the patch stem's input-channel axis (BGR <-> RGB), in torch
    layout [out, in, (kT,) kH, kW].

    The reference's data pipeline feeds cv2-decoded frames and never swaps
    the channel order (``slowfast/datasets/utils.py:20-48``), so released
    checkpoints expect BGR input; the port's pipeline is RGB, and
    ``conv(rgb, flipped_w) == conv(bgr, w)`` exactly.  Valid while
    DATA.MEAN/STD are the same for every channel (0.45/0.225 in every
    shipped recipe): normalization then commutes with the flip."""
    out = dict(state)
    w = out["patch_embed.proj.weight"]
    out["patch_embed.proj.weight"] = w.flip(1).contiguous()
    return out


def _qkv_blocks(state, name):
    return sorted({int(m.group(1)) for k in state
                   if (m := re.match(rf"blocks\.(\d+)\.attn\.{name}\.weight$",
                                     k))})


def convert_qkv(state: Dict[str, torch.Tensor], separate_qkv: bool
                ) -> Dict[str, torch.Tensor]:
    """The q, k and v projections in the layout a model of
    ``MVIT.SEPARATE_QKV = separate_qkv`` holds: the fused ``attn.qkv`` split
    into ``attn.q``, ``attn.k`` and ``attn.v`` (reference
    ``checkpoint.py:582-594``, JAX ``torch_to_flax(separate_qkv=True)``),
    or those three joined back into ``attn.qkv``."""
    out = dict(state)
    src, dst = (("qkv",), ("q", "k", "v")) if separate_qkv else \
        (("q", "k", "v"), ("qkv",))
    for i in _qkv_blocks(state, src[0]):
        tp = f"blocks.{i}.attn"
        for leaf in ("weight", "bias"):
            keys = [f"{tp}.{n}.{leaf}" for n in src]
            if keys[0] not in out:
                continue
            parts = [out.pop(k) for k in keys]
            joined = parts[0] if len(parts) == 1 else torch.cat(parts, 0)
            pieces = joined.chunk(len(dst), 0)
            for n, piece in zip(dst, pieces):
                out[f"{tp}.{n}.{leaf}"] = piece.contiguous()
    return out


def reference_to_port(state: Dict[str, torch.Tensor], separate_qkv=False,
                      input_order: str = "bgr") -> Dict[str, torch.Tensor]:
    """A released checkpoint's state dict as the port's: the stem flipped
    to RGB when the checkpoint was trained on BGR frames, the q, k and v
    projections in the model's layout."""
    if input_order == "bgr":
        state = flip_input_channels(state)
    return convert_qkv(state, separate_qkv)


# the flip and the q, k and v layout are their own inverses: the port's
# state dict in the reference's input order and the layout asked for
port_to_reference = reference_to_port


def params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree (nested dicts of arrays, with or
    without the outer ``{"params": ...}``) as the port's state dict."""
    state: Dict[str, np.ndarray] = {}
    p = params.get("params", params)

    def put_linear(node, prefix):
        state[f"{prefix}.weight"] = np.ascontiguousarray(
            np.asarray(node["kernel"]).T)
        if "bias" in node:
            state[f"{prefix}.bias"] = np.asarray(node["bias"])

    def put_ln(node, prefix):
        state[f"{prefix}.weight"] = np.asarray(node["scale"])
        state[f"{prefix}.bias"] = np.asarray(node["bias"])

    state["patch_embed.proj.weight"] = np.ascontiguousarray(
        np.asarray(p["patch_embed"]["proj"]["kernel"]).transpose(4, 3, 0, 1, 2))
    state["patch_embed.proj.bias"] = np.asarray(p["patch_embed"]["proj"]["bias"])
    for name in ("cls_token", "pos_embed_temporal", "object_queries",
                 "pos_embed_spatial", "pos_embed_class", "pos_embed"):
        if name in p:
            state[name] = np.asarray(p[name])

    for key in sorted(k for k in p if k.startswith("blocks_")):
        i = int(key.split("_")[1])
        b = p[key]
        tp = f"blocks.{i}"
        put_ln(b["norm1"], f"{tp}.norm1")
        put_ln(b["norm2"], f"{tp}.norm2")
        a = b["attn"]
        for n in ("qkv", "q", "k", "v", "proj"):
            if n in a:
                put_linear(a[n], f"{tp}.attn.{n}")
        for n in ("q", "k", "v"):
            if f"pool_{n}" in a:
                pool = a[f"pool_{n}"]
                state[f"{tp}.attn.pool_{n}.weight"] = np.ascontiguousarray(
                    np.asarray(pool["pool_kernel"]).transpose(4, 3, 0, 1, 2))
                if "norm" in pool:
                    put_ln(pool["norm"], f"{tp}.attn.norm_{n}")
        for rp in ("rel_pos_h", "rel_pos_w", "rel_pos_t"):
            if rp in a:
                state[f"{tp}.attn.{rp}"] = np.asarray(a[rp])
        put_linear(b["mlp"]["fc1"], f"{tp}.mlp.fc1")
        put_linear(b["mlp"]["fc2"], f"{tp}.mlp.fc2")
        if "proj" in b:
            put_linear(b["proj"], f"{tp}.proj")

    if "norm_stem" in p:
        put_ln(p["norm_stem"], "norm_stem")
    put_ln(p["norm"], "norm")
    h = p["head"]
    if "projection" in h:
        put_linear(h["projection"], "head.projection")
    for k in h:
        if k.startswith("projection_"):
            put_linear(h[k], f"head.projection.{k[len('projection_'):]}")
    put_linear(h["boxes_mlp"], "head.boxes_mlp.0")
    put_linear(h["boxes_bce_mlp"], "head.boxes_bce_mlp")
    put_linear(h["contact_mlp"], "head.contact_mlp")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in state.items()}


def params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_jax``: the port's state dict as the JAX
    package's parameter tree ``{"params": ...}`` of f32 numpy arrays, in
    its names and layouts (kernels ``[in, out]``, the stem and the pool
    filters ``[kT, kH, kW, in, out]``)."""
    tree: dict = {}

    def put(path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    def linear(path, leaf, a):
        put(path + ["kernel" if leaf == "weight" else "bias"],
            np.ascontiguousarray(a.T) if leaf == "weight" else a)

    def ln(path, leaf, a):
        put(path + ["scale" if leaf == "weight" else "bias"], a)

    for name, t in state.items():
        a = t.detach().cpu().float().numpy()
        parts = name.split(".")
        leaf = parts[-1]
        if len(parts) == 1:
            put([name], a)
        elif parts[0] == "patch_embed":
            put(["patch_embed", "proj", "kernel" if leaf == "weight"
                 else "bias"],
                np.ascontiguousarray(a.transpose(2, 3, 4, 1, 0))
                if leaf == "weight" else a)
        elif parts[0] in ("norm", "norm_stem"):
            ln([parts[0]], leaf, a)
        elif parts[0] == "blocks":
            fp, sub = [f"blocks_{parts[1]}"], parts[2:]
            if sub[0] in ("norm1", "norm2"):
                ln(fp + [sub[0]], leaf, a)
            elif sub[0] in ("mlp", "proj"):
                linear(fp + sub[:-1], leaf, a)
            elif sub[1].startswith("pool_"):
                put(fp + ["attn", sub[1], "pool_kernel"],
                    np.ascontiguousarray(a.transpose(2, 3, 4, 1, 0)))
            elif sub[1].startswith("norm_"):
                ln(fp + ["attn", "pool_" + sub[1][len("norm_"):], "norm"],
                   leaf, a)
            elif sub[1].startswith("rel_pos"):
                put(fp + ["attn", sub[1]], a)
            else:
                linear(fp + ["attn", sub[1]], leaf, a)
        elif parts[0] == "head":
            node = parts[1]
            if node == "projection" and len(parts) == 4:
                node = f"projection_{parts[2]}"
            linear(["head", node], leaf, a)
        else:
            raise KeyError(f"no JAX name for {name}")
    return {"params": tree}


def inflate_patch_kernel(w2d: torch.Tensor, t: int) -> torch.Tensor:
    """Inflate a 2D patch kernel [out, in, kH, kW] over time (divide by t),
    reference ``checkpoint.py:159-195`` / ``models/utils.py:100-118``."""
    return w2d[:, :, None].repeat(1, 1, t, 1, 1) / float(t)


def _resize_nearest(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` along one axis."""
    src = x.shape[axis]
    if src == size:
        return x
    idx = torch.from_numpy(
        np.floor(np.arange(size) * src / size).astype(np.int64))
    return x.index_select(axis, idx)


def load_timm_pretrained(path: str, num_patches: int, patch_kernel_t: int,
                         patch_kernel_hw, num_classes: int
                         ) -> Dict[str, torch.Tensor]:
    """timm-style image pretrain -> SViT state dict (reference
    ``models/utils.py:87-193``, ``MODEL.LOAD_IN_PRETRAIN``).

    Rules: drop the classifier on a class-count mismatch, nearest-resize the
    positional embedding to the new patch count, split ``pos_embed`` into
    ``pos_embed_class`` + ``pos_embed_spatial``, inflate the 2D patch kernel
    over time by repetition (the reference expands without dividing here,
    unlike the checkpoint-inflation path)."""
    state = load_torch_state(path)

    cls_name = "head" if "head.weight" in state else "head.projection"
    w = state.get(f"{cls_name}.weight")
    if w is not None and w.shape[0] != num_classes:
        state.pop(f"{cls_name}.weight", None)
        state.pop(f"{cls_name}.bias", None)

    if "pos_embed" in state:
        pos = state.pop("pos_embed")   # [1, 1 + P, C]
        if num_patches + 1 != pos.shape[1]:
            pos = torch.cat([pos[:, :1], _resize_nearest(
                pos[:, 1:], num_patches, axis=1)], dim=1)
        state["pos_embed_class"] = pos[:, :1]
        state["pos_embed_spatial"] = pos[:, 1:]

    w = state.get("patch_embed.proj.weight")
    if w is not None and w.dim() == 4:   # [out, in, kH, kW]
        w = _resize_nearest(w, patch_kernel_hw[0], axis=2)
        w = _resize_nearest(w, patch_kernel_hw[1], axis=3)
        state["patch_embed.proj.weight"] = w[:, :, None].repeat(
            1, 1, patch_kernel_t, 1, 1)
    return state
