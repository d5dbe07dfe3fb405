"""Dataset registry dispatch (counterpart of ``svit_tpu/data/build.py``,
reference ``slowfast/datasets/build.py``).

The port registers ``Ssv2``; the other datasets of the JAX package come
with the training data layer (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from svit_tpu_torch.data import ssv2  # noqa: F401  (registers Ssv2)
from svit_tpu_torch.models.registry import DATASET_REGISTRY


def build_dataset(dataset_name: str, cfg, split: str):
    """Capitalized name -> registered class (reference build.py:27-31)."""
    name = dataset_name.capitalize()
    return DATASET_REGISTRY.get(name)(cfg, split)
