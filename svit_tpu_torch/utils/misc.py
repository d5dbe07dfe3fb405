"""Model statistics and helpers (counterpart of ``svit_tpu/utils/misc.py``,
reference ``slowfast/utils/misc.py``).

``log_model_info`` reports the parameter count and the forward FLOPs of
one clip from the analytic model (``utils/flops.py``), where the JAX
package asks XLA's cost analysis (``svit_tpu/utils/misc.py:43-53``).
``launch_job`` runs a job entry point, one process per local card.
"""

from __future__ import annotations

import math

import torch

from svit_tpu_torch.parallel import dist as du
from svit_tpu_torch.utils import flops as flops_lib
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def params_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def log_model_info(model: torch.nn.Module, cfg):
    """Log the model's name, parameter count and forward FLOPs of one clip
    of ``DATA.NUM_FRAMES`` frames; returns (params, flops)."""
    n_params = params_count(model)
    flops = flops_lib.forward_flops(model.arch, 1, cfg.DATA.NUM_FRAMES)
    logger.info("Model: %s", cfg.MODEL.MODEL_NAME)
    logger.info("Params: %s", f"{n_params:,}")
    logger.info("GFLOPs (fwd, 1 clip): %.2f", flops / 1e9)
    return n_params, flops


def check_nan_losses(loss: float, extra_msg: str = ""):
    """Raise on NaN loss (reference ``misc.py:25-35``)."""
    if math.isnan(loss):
        raise RuntimeError(f"ERROR: Got NaN losses {extra_msg}")


def get_num_classes(cfg):
    """reference ``misc.py:406-410``."""
    if cfg.TRAIN.DATASET == "epickitchens":
        return {"noun": 300, "verb": 97}
    return cfg.MODEL.NUM_CLASSES


def _call(func, cfg, device):
    return func(cfg) if device is None else func(cfg, device=device)


def _run_job(local_rank, procs, func, cfg, device):
    """One spawned process of ``launch_job``: join the group, run."""
    du.init_distributed(cfg, local_rank, procs)
    try:
        _call(func, cfg, device)
    finally:
        du.destroy_process_group()


def launch_job(cfg, init_method=None, func=None, daemon=False, device=None):
    """Run ``func(cfg)`` (reference ``misc.py:271-299``): with more than one
    process on this host (``du.local_processes``: one per card, at most
    ``NUM_GPUS``) spawn one each, every one joining the process group at
    ``INIT_METHOD`` (``init_method`` overrides it) before it calls
    ``func``; with one, join a multi-host group if ``NUM_SHARDS > 1`` and
    call ``func`` here, as the JAX package does.  ``device`` is passed on
    to ``func`` when given."""
    if init_method is not None:
        cfg.INIT_METHOD = init_method
    procs = du.local_processes(cfg, device)
    if procs > 1:
        torch.multiprocessing.spawn(_run_job, args=(procs, func, cfg, device),
                                    nprocs=procs, daemon=daemon)
        return None
    du.init_distributed(cfg, 0, 1)
    return _call(func, cfg, device)
