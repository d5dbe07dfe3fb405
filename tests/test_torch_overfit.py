"""The port's learning sanity check on the CPU (counterpart of
``tests/test_overfit.py``): the recipe of ``svit_tpu_torch/tools/overfit_hw.py``
(4 solid-colour videos, 4 classes) overfit by ``engine.train.train`` in f32
through the plain twins; the first ``loss_ce`` above 1.0, the last below
0.1, as the JAX test asks.  ``overfit_hw.py`` runs the same recipe on the
card through the CLI, with a preemption and an auto-resume.

Marked slow: run with ``-m slow``.
"""

import logging

import pytest
import torch

from svit_tpu_torch.engine import meters
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
