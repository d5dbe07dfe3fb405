"""Model statistics and helpers (counterpart of ``svit_tpu/utils/misc.py``,
reference ``slowfast/utils/misc.py``).

``log_model_info`` reports the parameter count.  FLOPs come with
``utils/flops.py``, which is not ported (ROADMAP Queue 1 item 6): they are
logged as unavailable, as the JAX package logs them on a backend without
cost analysis (``svit_tpu/utils/misc.py:43-53``).
"""

from __future__ import annotations

import math

import torch

from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def params_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def log_model_info(model: torch.nn.Module, cfg):
    """Log the model's name and parameter count; returns (params, flops),
    flops NaN."""
    n_params = params_count(model)
    logger.info("Model: %s", cfg.MODEL.MODEL_NAME)
    logger.info("Params: %s", f"{n_params:,}")
    logger.warning("FLOP analysis unavailable: utils/flops.py is not ported")
    return n_params, float("nan")


def check_nan_losses(loss: float, extra_msg: str = ""):
    """Raise on NaN loss (reference ``misc.py:25-35``)."""
    if math.isnan(loss):
        raise RuntimeError(f"ERROR: Got NaN losses {extra_msg}")


def get_num_classes(cfg):
    """reference ``misc.py:406-410``."""
    if cfg.TRAIN.DATASET == "epickitchens":
        return {"noun": 300, "verb": 97}
    return cfg.MODEL.NUM_CLASSES
