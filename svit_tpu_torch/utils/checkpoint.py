"""Checkpoint paths and loading (counterpart of the load half of
``svit_tpu/utils/checkpoint.py``, reference ``slowfast/utils/checkpoint.py``).

- Checkpoints live in ``OUTPUT_DIR/checkpoints`` as
  ``checkpoint_epoch_{epoch:05d}`` (``_step_{n:08d}`` for a mid-epoch
  save); the last in sorted order is the latest.
- Test-time priority: TEST path > last checkpoint > TRAIN path (reference
  ``checkpoint.py:511-548``).
- ``load_params_any`` reads PyTorch checkpoint files (``.pyth``, ``.pt``,
  ``.pth``, the reference's names) into the model.  An Orbax directory (the
  JAX package's train state) raises.

Saving and resuming a train state come with the Trainer (ROADMAP Queue 1
item 4).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from svit_tpu_torch.utils import converter, logging

logger = logging.get_logger(__name__)

_DIR = "checkpoints"
TORCH_SUFFIXES = (".pyth", ".pt", ".pth")


def checkpoint_dir(path_to_job: str) -> str:
    return os.path.join(path_to_job, _DIR)


def checkpoint_path(path_to_job: str, epoch: int,
                    step_in_epoch: Optional[int] = None) -> str:
    """``step_in_epoch`` names a mid-epoch save: the plain epoch name is a
    prefix of it, so the sorted order of ``get_last_checkpoint`` holds."""
    name = f"checkpoint_epoch_{epoch:05d}"
    if step_in_epoch is not None:
        name += f"_step_{step_in_epoch:08d}"
    return os.path.join(checkpoint_dir(path_to_job), name)


def get_last_checkpoint(path_to_job: str) -> Optional[str]:
    d = checkpoint_dir(path_to_job)
    if not os.path.isdir(d):
        return None
    names = sorted(n for n in os.listdir(d)
                   if n.startswith("checkpoint_epoch_"))
    return os.path.join(d, names[-1]) if names else None


def has_checkpoint(path_to_job: str) -> bool:
    return get_last_checkpoint(path_to_job) is not None


def load_test_checkpoint_path(cfg) -> Optional[str]:
    """Priority: TEST path > last ckpt > TRAIN path (reference :511-548)."""
    if cfg.TEST.CHECKPOINT_FILE_PATH:
        return cfg.TEST.CHECKPOINT_FILE_PATH
    last = get_last_checkpoint(cfg.OUTPUT_DIR)
    if last:
        return last
    if cfg.TRAIN.CHECKPOINT_FILE_PATH:
        return cfg.TRAIN.CHECKPOINT_FILE_PATH
    logger.info("Testing with random initialization. Only for debugging.")
    return None


def load_params_any(model: torch.nn.Module, path: str, cfg=None) -> None:
    """Load a PyTorch checkpoint file into ``model`` (strict names), with
    ``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN`` and ``_REPLACE_NAME_PATTERN``
    applied to the names; an Orbax directory raises."""
    if not (os.path.isfile(path) and path.endswith(TORCH_SUFFIXES)):
        raise ValueError(
            f"{path}: the port loads PyTorch checkpoint files "
            f"({', '.join(TORCH_SUFFIXES)}); Orbax checkpoint directories "
            "are not supported yet")
    clear = tuple(cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN) if cfg else ()
    replace = tuple(tuple(p) for p in
                    cfg.TRAIN.CHECKPOINT_REPLACE_NAME_PATTERN) if cfg else ()
    state = converter.load_torch_state(path, clear, replace)
    model.load_state_dict(state, strict=True)
