"""Checkpoints (counterpart of ``svit_tpu/utils/checkpoint.py``, reference
``slowfast/utils/checkpoint.py``).

- Checkpoints live in ``OUTPUT_DIR/checkpoints`` as directories named
  ``checkpoint_epoch_{epoch:05d}`` (``_step_{n:08d}`` for a mid-epoch
  save), the JAX package's names; the last in sorted order is the latest.
  Each holds ``train_state.pyth`` (``torch.save`` of the reference's keys
  ``model_state`` and ``optimizer_state``, with ``step``, ``epoch`` and
  ``step_in_epoch``) and the config as ``cfg.yaml``.
- Saved every ``CHECKPOINT_PERIOD`` epochs and at the last epoch
  (``is_checkpoint_epoch``); auto-resume reads the last one
  (``load_train_state``).
- Test-time priority: TEST path > last checkpoint > TRAIN path (reference
  ``checkpoint.py:511-548``).
- ``load_params_any`` reads PyTorch checkpoint files (``.pyth``, ``.pt``,
  ``.pth``, the reference's names) or the port's checkpoint directories
  into the model.  An Orbax directory (the JAX package's train state)
  raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

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


STATE_FILE = "train_state.pyth"


def is_checkpoint_epoch(cfg, cur_epoch: int) -> bool:
    """reference checkpoint.py:99-121 (no multigrid special case)."""
    return ((cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0
            or cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH)


def save_checkpoint(path_to_job: str, state, epoch: int, cfg,
                    step_in_epoch: Optional[int] = None) -> str:
    """Save the train state's parameters, optimizer state, ``step``,
    ``epoch`` and the config.  ``step_in_epoch`` marks a mid-epoch
    (preemption) save: that many iterations of ``epoch`` are done, and a
    resume continues inside it; None means the epoch is complete and the
    directory is named for the next."""
    if step_in_epoch is None:
        path = checkpoint_path(path_to_job, epoch + 1)
    else:
        path = checkpoint_path(path_to_job, epoch, step_in_epoch)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    blob = {
        "model_state": {k: v.detach().cpu()
                        for k, v in state.model.state_dict().items()},
        "optimizer_state": state.tx.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": epoch,
        "step_in_epoch": -1 if step_in_epoch is None else step_in_epoch,
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, "cfg.yaml"), "w") as f:
        f.write(cfg.dump())
    logger.info("Saved checkpoint to %s", path)
    return path


def load_train_state(path: str, state) -> Tuple[Dict, int]:
    """Restore a state saved by ``save_checkpoint`` into ``state`` (its
    model, optimizer and step), in place; returns ({step, epoch,
    step_in_epoch}, epoch).  ``step_in_epoch`` >= 0 marks a mid-epoch
    save."""
    blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=False)
    state.model.load_state_dict(blob["model_state"], strict=True)
    state.tx.load_state_dict(blob["optimizer_state"])
    state.step = int(blob["step"])
    restored = {k: int(blob.get(k, -1))
                for k in ("step", "epoch", "step_in_epoch")}
    return restored, restored["epoch"]


def shape_filtered_merge(target: Dict[str, torch.Tensor],
                         loaded: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """``target`` with every entry of ``loaded`` of the same name and shape
    (cast to the target's dtype), the misses logged (reference
    checkpoint.py:353-372)."""
    merged, missed = {}, []
    for k, v in target.items():
        src = loaded.get(k)
        if src is not None and tuple(src.shape) == tuple(v.shape):
            merged[k] = src.to(dtype=v.dtype)
        else:
            missed.append(k)
            merged[k] = v
    if missed:
        logger.warning("checkpoint load: %d params loaded, %d kept at init "
                       "(e.g. %s)", len(merged) - len(missed), len(missed),
                       missed[:8])
    else:
        logger.info("checkpoint load: all %d params loaded", len(merged))
    return merged


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


def read_params(path: str, cfg=None) -> Dict[str, torch.Tensor]:
    """The parameters of a PyTorch checkpoint file, or of a checkpoint
    directory that ``save_checkpoint`` wrote, as {name: tensor} on the CPU,
    with ``TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN`` and ``_REPLACE_NAME_PATTERN``
    applied to the names; an Orbax directory raises."""
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        path = os.path.join(path, STATE_FILE)
    if not (os.path.isfile(path) and path.endswith(TORCH_SUFFIXES)):
        raise ValueError(
            f"{path}: the port loads PyTorch checkpoint files "
            f"({', '.join(TORCH_SUFFIXES)}); Orbax checkpoint directories "
            "are not supported yet")
    clear = tuple(cfg.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN) if cfg else ()
    replace = tuple(tuple(p) for p in
                    cfg.TRAIN.CHECKPOINT_REPLACE_NAME_PATTERN) if cfg else ()
    return converter.load_torch_state(path, clear, replace)


def load_params_any(model: torch.nn.Module, path: str, cfg=None) -> None:
    """Load ``read_params(path, cfg)`` into ``model`` (strict names)."""
    model.load_state_dict(read_params(path, cfg), strict=True)
