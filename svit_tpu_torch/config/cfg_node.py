"""Minimal yacs-style configuration node.

Pure-Python reimplementation of the config container the reference uses
(fvcore/yacs ``CfgNode``; see reference ``slowfast/config/defaults.py`` and
``slowfast/utils/parser.py:80-96``).  Preserves the public contract:

- attribute access (``cfg.MVIT.DEPTH``),
- ``merge_from_file(yaml_path)`` deep-merge,
- ``merge_from_list(["KEY.SUBKEY", "value", ...])`` CLI override,
- ``dump()`` to a YAML string (used when serializing into checkpoints),
- ``clone()`` / ``freeze()`` / ``defrost()``.

No external deps beyond PyYAML.
"""

from __future__ import annotations

import ast
import copy
from typing import Any

import yaml


class CfgNode(dict):
    """A dict subclass with attribute access and yacs-compatible merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} on an immutable CfgNode"
            )
        self[name] = value

    def __setitem__(self, name, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} on an immutable CfgNode"
            )
        dict.__setitem__(self, name, value)

    # -- pickling -----------------------------------------------------------
    # dict-subclass pickling bypasses __init__, losing the __immutable__
    # instance attribute (breaks process-pool loader workers); rebuild
    # through the constructor and restore the frozen state.
    def __reduce__(self):
        return (
            _rebuild_cfg_node,
            (dict(self), object.__getattribute__(self, CfgNode.IMMUTABLE)),
        )

    # -- mutability ---------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # -- merging ------------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_file(self, cfg_filename: str) -> None:
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(loaded)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other)

    def _merge_dict(self, d: dict, prefix: str = "") -> None:
        for k, v in d.items():
            full = f"{prefix}.{k}" if prefix else k
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            cur = self[k]
            if isinstance(cur, CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(
                        f"Cannot merge non-dict into config subtree {full}"
                    )
                cur._merge_dict(v, full)
            else:
                # yacs-style: string literals like "(3, 7, 7)" in YAML decode
                # to python values before type checking.
                self[k] = _coerce(_maybe_decode(v), cur, full)

    def merge_from_list(self, cfg_list) -> None:
        assert len(cfg_list) % 2 == 0, (
            f"Override list has odd length: {cfg_list}"
        )
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            keys = full_key.split(".")
            node = self
            for sub in keys[:-1]:
                if sub not in node or not isinstance(node[sub], CfgNode):
                    raise KeyError(f"Non-existent config key: {full_key}")
                node = node[sub]
            leaf = keys[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {full_key}")
            node[leaf] = _coerce(_maybe_decode(v), node[leaf], full_key)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=None)

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _maybe_decode(v: Any) -> Any:
    """Decode a CLI string literal ('[1,2]', '2e-4', 'True', ...)."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce(new: Any, old: Any, key: str) -> Any:
    """Check/convert replacement value type against the default's type."""
    if old is None or new is None:
        return new
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, str):
            low = new.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
        if isinstance(new, int):
            return bool(new)
        raise TypeError(f"Cannot coerce {new!r} to bool for key {key}")
    if isinstance(old, float) and isinstance(new, (int, str)):
        return float(new)
    if isinstance(old, int) and isinstance(new, float) and new.is_integer():
        return int(new)
    if isinstance(old, (list, tuple)):
        if isinstance(new, (list, tuple)):
            return list(new)
        raise TypeError(f"Cannot coerce {new!r} to list for key {key}")
    if isinstance(old, str) and not isinstance(new, str):
        return str(new)
    if type(new) is not type(old) and not isinstance(new, type(old)):
        # Allow int <-> float promotion; reject other mismatches.
        if isinstance(old, float) and isinstance(new, int):
            return float(new)
        raise TypeError(
            f"Type mismatch for key {key}: {type(new)} vs default {type(old)}"
        )
    return new


def _rebuild_cfg_node(data, immutable):
    node = CfgNode(data)
    if immutable:
        node._set_immutable(True)
    return node
