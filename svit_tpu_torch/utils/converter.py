"""Parameter names and loading (counterpart of ``svit_tpu/utils/converter.py``).

The port's parameter names are the PyTorch reference's state-dict names
(``blocks.3.attn.qkv.weight``, ``head.boxes_mlp.0.bias``, ...), so a
reference ``.pyth`` checkpoint loads with ``load_state_dict(strict=True)``
and JAX parameters cross over through ``params_from_jax``.
"""

from __future__ import annotations

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
