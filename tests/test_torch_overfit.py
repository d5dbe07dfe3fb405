"""The port's learning sanity check on the CPU (counterpart of
``tests/test_overfit.py``): the recipe of ``svit_tpu_torch/tools/overfit_hw.py``
(4 solid-colour videos, 4 classes) overfit by ``engine.train.train`` in f32
through the plain twins; the first ``loss_ce`` above 1.0, the last below
0.1, as the JAX test asks.  ``overfit_hw.py`` runs the same recipe on the
card through the CLI, with a preemption and an auto-resume.

Marked slow: run with ``-m slow``.

The tool's verdict on the preemption, on the same recipe cut to two
epochs: the SIGTERM may meet the train loop between two epochs (the loop
saves the finished epoch) or inside one (a ``_step_`` save); either way the
rerun resumes from that checkpoint and the two runs log every step once.
A rerun that does not resume fails the verdict.
"""

import logging
import os
import shutil

import pytest
import torch

from svit_tpu_torch.engine import meters
from svit_tpu_torch.engine import train as ttrain
from svit_tpu_torch.engine.train import train
from svit_tpu_torch.tools import overfit_hw


@pytest.mark.slow
def test_overfit_video_classification(tmp_path, monkeypatch):
    torch.set_num_threads(2)
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    overfit_hw.build_fixture(root)
    cfg = overfit_hw.overfit_cfg(root, out, on_card=False)
    logging.getLogger("svit_tpu_torch").setLevel(logging.ERROR)
    seen = []
    update = meters.TrainMeter.update_stats

    def recorded(self, lr, mb, dloss):
        seen.append(dloss["loss_ce"])
        return update(self, lr, mb, dloss)

    monkeypatch.setattr(meters.TrainMeter, "update_stats", recorded)
    train(cfg, device="cpu")
    assert seen[0] > 1.0
    assert seen[-1] < 0.1, f"did not learn: {seen[-1]}"


@pytest.fixture(scope="module")
def colours(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("colours"))
    overfit_hw.build_fixture(root)
    return root


def _fires_at(poll):
    """A preemption guard whose flag is up from its ``poll``-th read: the
    train loop reads it at the top of every epoch and after every step."""

    class Guard:
        def __init__(self):
            self.polls = 0

        @property
        def fired(self):
            self.polls += 1
            return self.polls >= poll

        def restore(self):
            pass

    return Guard


@pytest.mark.parametrize("poll, name, resume", [
    # top of epoch 1: the finished epoch 0 is saved, named for epoch 1
    (4, "checkpoint_epoch_00001", True),
    # after iter 0 of epoch 1: a mid-epoch save
    (5, "checkpoint_epoch_00001_step_00000001", True),
    # the checkpoint is lost before the rerun, which starts over
    (4, "checkpoint_epoch_00001", False),
])
def test_the_verdict_takes_either_preemption_checkpoint(
        colours, tmp_path, monkeypatch, poll, name, resume):
    out = str(tmp_path / "out")
    cfg = overfit_hw.overfit_cfg(colours, out, on_card=False)
    cfg.SOLVER.MAX_EPOCH = 2
    n_steps = 2 * cfg.SOLVER.MAX_EPOCH
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    lg = logging.getLogger("svit_tpu_torch")
    level = lg.level
    lg.setLevel(logging.INFO)
    try:
        with monkeypatch.context() as m:
            m.setattr(ttrain, "_PreemptionGuard", _fires_at(poll))
            train(cfg, device="cpu")
        log_path = os.path.join(out, "stdout.log")
        n_phase1 = len(overfit_hw.parse_losses(log_path))
        ckpt = os.path.join(out, "checkpoints", name)
        assert sorted(os.listdir(os.path.dirname(ckpt))) == [name]
        if not resume:
            shutil.rmtree(os.path.dirname(ckpt))
        train(cfg, device="cpu")
    finally:
        lg.setLevel(level)
        torch.set_num_threads(threads)
    got = overfit_hw.verdict(log_path, ckpt, n_phase1, n_steps)
    assert got["steps_phase1"] == poll - 2
    assert got["preempt_mid_epoch"] == ("_step_" in name)
    assert got["resumed"] == got["steps_exact"] == resume
    assert got["steps_total"] == n_steps + (0 if resume else n_phase1)
