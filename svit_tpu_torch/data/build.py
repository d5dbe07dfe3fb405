"""Dataset registry dispatch (counterpart of ``svit_tpu/data/build.py``,
reference ``slowfast/datasets/build.py``).

Importing it registers the port's datasets: ``Ssv2``, ``Ssv2_frames``,
``Doh_frames`` and ``Multi_images``.  ``Kinetics`` (and its video decoder)
is not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

# importing registers the datasets
from svit_tpu_torch.data import (  # noqa: F401
    doh_frames, multi_images, ssv2, ssv2_frames)
from svit_tpu_torch.models.registry import DATASET_REGISTRY


def build_dataset(dataset_name: str, cfg, split: str):
    """Capitalized name -> registered class (reference build.py:27-31)."""
    name = dataset_name.capitalize()
    return DATASET_REGISTRY.get(name)(cfg, split)
