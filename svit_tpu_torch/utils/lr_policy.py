"""Learning-rate policies (counterpart of ``svit_tpu/utils/lr_policy.py``).

Pure functions of a float epoch, so the optimizer can evaluate them per
step (the reference calls ``get_epoch_lr(epoch + iter / len(loader))`` each
iteration).
"""

from __future__ import annotations

import math


def get_lr_at_epoch(cfg, cur_epoch: float) -> float:
    lr = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cur_epoch, cfg.SOLVER.BASE_LR)
    if cur_epoch < cfg.SOLVER.WARMUP_EPOCHS:
        lr_start = cfg.SOLVER.WARMUP_START_LR
        lr_end = get_lr_func(cfg.SOLVER.LR_POLICY)(
            cfg, cfg.SOLVER.WARMUP_EPOCHS, cfg.SOLVER.BASE_LR)
        alpha = (lr_end - lr_start) / cfg.SOLVER.WARMUP_EPOCHS
        lr = cur_epoch * alpha + lr_start
    return lr


def lr_func_cosine(cfg, cur_epoch: float, base_lr: float) -> float:
    end_lr = cfg.SOLVER.COSINE_END_LR
    offset = cfg.SOLVER.WARMUP_EPOCHS if cfg.SOLVER.COSINE_AFTER_WARMUP else 0.0
    assert end_lr < base_lr
    return end_lr + (base_lr - end_lr) * (
        math.cos(math.pi * (cur_epoch - offset) / (cfg.SOLVER.MAX_EPOCH - offset))
        + 1.0) * 0.5


def lr_func_steps_with_relative_lrs(cfg, cur_epoch: float,
                                    base_lr: float) -> float:
    return cfg.SOLVER.LRS[get_step_index(cfg, cur_epoch)] * base_lr


def get_step_index(cfg, cur_epoch: float) -> int:
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_EPOCH]
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    return ind - 1


_POLICIES = {
    "cosine": lr_func_cosine,
    "steps_with_relative_lrs": lr_func_steps_with_relative_lrs,
}


def get_lr_func(policy: str):
    if policy not in _POLICIES:
        raise NotImplementedError(f"Unknown LR policy: {policy}")
    return _POLICIES[policy]
