"""Minimal registry (counterpart of ``svit_tpu/models/registry.py``)."""

from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map = {}

    def register(self, name: str = None):
        def deco(obj):
            key = name or obj.__name__
            assert key not in self._map, f"{key} already registered in {self._name}"
            self._map[key] = obj
            return obj

        return deco

    def get(self, key: str):
        if key not in self._map:
            raise KeyError(
                f"{key} not found in {self._name} registry. "
                f"Available: {sorted(self._map)}"
            )
        return self._map[key]

    def __contains__(self, key):
        return key in self._map

    def keys(self):
        return self._map.keys()


MODEL_REGISTRY = Registry("MODEL")
DATASET_REGISTRY = Registry("DATASET")
