"""Multigrid training schedule (counterpart of ``svit_tpu/engine/multigrid.py``;
reference ``slowfast/utils/multigrid.py`` + ``datasets/multigrid_helper.py``).

Long-cycle training varies the base (B, T, S) shape over epochs for
throughput; short cycles vary batch/crop within an epoch.  The engine
rebuilds its Trainer (loaders, model and step) when ``update_long_cycle``
reports a change, with the state carried over, as the reference rebuilds
its trainer (``tools/train_net.py:541-564``).  The reference's BN-type juggling
(sync/sub-BN by batch factor) does not apply: SViT is LayerNorm-only.

OFF in the shipped ssv2 recipe; part of the capability surface.
"""

from __future__ import annotations

import numpy as np

from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


class MultigridSchedule:
    """Defines the multigrid schedule and updates cfg accordingly."""

    def init_multigrid(self, cfg):
        self.schedule = None
        cfg.MULTIGRID.DEFAULT_B = cfg.TRAIN.BATCH_SIZE
        cfg.MULTIGRID.DEFAULT_T = cfg.DATA.NUM_FRAMES
        cfg.MULTIGRID.DEFAULT_S = cfg.DATA.TRAIN_CROP_SIZE

        if cfg.MULTIGRID.LONG_CYCLE:
            self.schedule = self.get_long_cycle_schedule(cfg)
            cfg.SOLVER.STEPS = [0] + [s[-1] for s in self.schedule]
            # fine-tuning phase splits the last step
            cfg.SOLVER.STEPS[-1] = (cfg.SOLVER.STEPS[-2] + cfg.SOLVER.STEPS[-1]) // 2
            cfg.SOLVER.LRS = [
                cfg.SOLVER.GAMMA ** s[0] * s[1][0] for s in self.schedule
            ]
            cfg.SOLVER.LRS = cfg.SOLVER.LRS[:-1] + [
                cfg.SOLVER.LRS[-2],
                cfg.SOLVER.LRS[-1],
            ]
            cfg.SOLVER.MAX_EPOCH = self.schedule[-1][-1]
        elif cfg.MULTIGRID.SHORT_CYCLE:
            cfg.SOLVER.STEPS = [
                int(s * cfg.MULTIGRID.EPOCH_FACTOR) for s in cfg.SOLVER.STEPS
            ]
            cfg.SOLVER.MAX_EPOCH = int(
                cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR
            )
        return cfg

    def update_long_cycle(self, cfg, cur_epoch):
        """Returns (cfg, changed) — changed means the train step/loaders must
        be rebuilt for the new (B, T, S)."""
        base_b, base_t, base_s = get_current_long_cycle_shape(
            self.schedule, cur_epoch
        )
        if base_s != cfg.DATA.TRAIN_CROP_SIZE or base_t != cfg.DATA.NUM_FRAMES:
            cfg.DATA.NUM_FRAMES = base_t
            cfg.DATA.TRAIN_CROP_SIZE = base_s
            cfg.TRAIN.BATCH_SIZE = base_b * cfg.MULTIGRID.DEFAULT_B
            cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = cfg.DATA.SAMPLING_RATE * (
                cfg.MULTIGRID.DEFAULT_T // cfg.DATA.NUM_FRAMES
            )
            logger.info(
                "Long cycle update: B=%d T=%d S=%d",
                cfg.TRAIN.BATCH_SIZE, base_t, base_s,
            )
            return cfg, True
        return cfg, False

    def get_long_cycle_schedule(self, cfg):
        steps = cfg.SOLVER.STEPS
        default_size = float(cfg.DATA.NUM_FRAMES * cfg.DATA.TRAIN_CROP_SIZE ** 2)
        default_iters = steps[-1]

        avg_bs = []
        all_shapes = []
        for t_factor, s_factor in cfg.MULTIGRID.LONG_CYCLE_FACTORS:
            base_t = int(round(cfg.DATA.NUM_FRAMES * t_factor))
            base_s = int(round(cfg.DATA.TRAIN_CROP_SIZE * s_factor))
            if cfg.MULTIGRID.SHORT_CYCLE:
                shapes = [
                    [base_t, cfg.MULTIGRID.DEFAULT_S * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[0]],
                    [base_t, cfg.MULTIGRID.DEFAULT_S * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[1]],
                    [base_t, base_s],
                ]
            else:
                shapes = [[base_t, base_s]]
            shapes = [
                [int(round(default_size / (s[0] * s[1] * s[1]))), s[0], s[1]]
                for s in shapes
            ]
            avg_bs.append(np.mean([s[0] for s in shapes]))
            all_shapes.append(shapes)

        total_iters = 0
        schedule = []
        for step_index in range(len(steps) - 1):
            step_epochs = steps[step_index + 1] - steps[step_index]
            for long_cycle_index, shapes in enumerate(all_shapes):
                cur_epochs = step_epochs * avg_bs[long_cycle_index] / sum(avg_bs)
                cur_iters = cur_epochs / avg_bs[long_cycle_index]
                total_iters += cur_iters
                schedule.append((step_index, shapes[-1], cur_epochs))

        iter_saving = default_iters / total_iters
        final_step_epochs = cfg.SOLVER.MAX_EPOCH - steps[-1]
        ft_epochs = final_step_epochs / iter_saving * avg_bs[-1]
        schedule.append((step_index + 1, all_shapes[-1][-1], ft_epochs))

        x = (
            cfg.SOLVER.MAX_EPOCH
            * cfg.MULTIGRID.EPOCH_FACTOR
            / sum(s[-1] for s in schedule)
        )
        final_schedule = []
        total_epochs = 0
        for s in schedule:
            epochs = s[2] * x
            total_epochs += epochs
            final_schedule.append((s[0], s[1], int(round(total_epochs))))
        for s in final_schedule:
            logger.info("long cycle: index %s shape %s until epoch %s", *s)
        return final_schedule


def get_current_long_cycle_shape(schedule, epoch):
    for s in schedule:
        if epoch < s[-1]:
            return s[1]
    return schedule[-1][1]


def short_cycle_batch_sizes(batch_size: int, cfg):
    """Per-phase batch sizes for the short cycle (reference
    ``multigrid_helper.py:19-87``): batch x{4, 2, 1} with crop factors."""
    bs_factor = [
        int(round((float(cfg.DATA.TRAIN_CROP_SIZE) / (s * cfg.MULTIGRID.DEFAULT_S)) ** 2))
        for s in cfg.MULTIGRID.SHORT_CYCLE_FACTORS
    ]
    return [batch_size * bs_factor[0], batch_size * bs_factor[1], batch_size]
