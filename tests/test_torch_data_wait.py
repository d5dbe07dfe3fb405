"""The Trainer's logged data wait (``dt_data``): the seconds of a step's
window spent waiting for a batch, as the JAX package's loop counts them
(``svit_tpu/engine/train.py``: the loader's ``next`` and the copies
before ``data_toc``).  The port fetches the next batch while the step
runs, so that wait lies inside the window; it once counted only the
loop's top, about 0.06 ms a step, while the loaders paced four cards."""

import time
import types

import torch

from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.engine import meters, train
from svit_tpu_torch.engine.meters import Timer

WAIT = 0.15     # seconds the stand-in loader takes a batch


class SlowLoader:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def iter_batches(self, start=0):
        for _ in range(start, self.n):
            time.sleep(WAIT)
            yield {"clips": torch.zeros(2, 1), "labels": torch.zeros(2),
                   "weight": torch.ones(2)}


def stand_in_trainer(steps):
    def step_fn(state, vb, image_batch, gen):
        state.step += 1
        return state, torch.tensor([1.0])

    return types.SimpleNamespace(
        image_loader=None, train_loader=SlowLoader(steps),
        put_ahead=lambda *b: (b, None), wait_for=lambda b, ready: None,
        data_seconds=[], generator=torch.Generator(), step_fn=step_fn,
        steps_per_epoch=steps, metric_names=["loss"])


def test_logged_data_wait_is_the_loaders(monkeypatch):
    cfg = get_cfg()
    cfg.LOG_PERIOD = 1
    cfg.SOLVER.MAX_EPOCH = 1
    logged = []
    monkeypatch.setattr(meters.logging, "log_json_stats", logged.append)
    trainer = stand_in_trainer(4)
    train.train_epoch(cfg, trainer, types.SimpleNamespace(step=0),
                      meters.TrainMeter(4, cfg), 0)
    iters = [s for s in logged if s["_type"] == "train_iter"]
    assert len(iters) == 4
    for s in iters[:-1]:
        # each window waits for one batch (the first for two; the last,
        # with no next batch, for none)
        assert WAIT * 0.9 <= s["dt_data"] <= s["dt"], s
    assert iters[0]["dt_data"] >= 2 * WAIT * 0.9


def test_timer_resumes_after_a_pause():
    t = Timer()
    time.sleep(0.05)
    t.pause()
    time.sleep(0.1)      # not counted
    paused = t.seconds()
    t.resume()
    time.sleep(0.05)
    t.pause()
    assert 0.1 * 0.9 <= t.seconds() < paused + 0.09
    assert t.seconds() >= paused + 0.045
