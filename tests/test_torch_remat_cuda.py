"""``TPU.REMAT`` on the card: the train step with each block recomputed in
the backward through the hand-written kernels equals the step without
remat bit for bit (the loss and every metric, the gradients, the
parameters after AdamW and the generator's state after the step), eager
and as a CUDA graph, and the graph launches the forward kernels once more
for each block of the video and image forwards (``chip_smoke.py``'s
``expected_train_launches`` at five forwards).  A small SViT of
``configs/ssv2.yaml``'s widths, 2 blocks at 56 px and 4 frames, bf16
through the kernels, with drop-path 0.4, head dropout 0.5 and dropout 0.1
(the unfused tail) or 0 (K1's masked tail).

These need an NVIDIA card and ``nvcc``; without a card they skip.  Run them
there with ``python -m pytest --noconftest tests/test_torch_remat_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    sys.path.insert(0, REPO)
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return chip_smoke


def _cfg(remat, dropout):
    from svit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.DROPOUT_RATE = dropout
    cfg.MODEL.NUM_CLASSES = 10
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    cfg.TPU.REMAT = remat
    return cfg


def _batches(cfg):
    rs = np.random.RandomState(0)
    S, T, O = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES, cfg.SVIT.O
    video = {"clips": rs.randn(4, T, S, S, 3).astype(np.float32),
             "labels": rs.randint(0, 10, 4),
             "weight": np.ones(4, np.float32)}
    image = {"frames": rs.randn(4, 1, S, S, 3).astype(np.float32),
             "haog_bboxes": (rs.rand(4, 1, O, 4) * 0.5 + 0.1).astype(
                 np.float32),
             "contact_state": rs.randint(-1, 5, (4, 2)),
             "weight": np.ones(4, np.float32)}
    return ({k: torch.as_tensor(v).cuda() for k, v in video.items()},
            {k: torch.as_tensor(v).cuda() for k, v in image.items()})


def _step(smoke, remat, dropout, captured):
    from svit_tpu_torch.engine import graphs

    cfg = _cfg(remat, dropout)
    video, image = _batches(cfg)
    state, step, arch = smoke.train_setup(cfg, torch, torch.bfloat16, True)
    assert arch.remat == remat
    run = graphs.CapturedTrainStep(step) if captured else step
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, m = run(state, video, image, gen)
    torch.cuda.synchronize()
    launches = (next(iter(run.entries.values())).launches if captured
                else None)
    return ({k: float(v) for k, v in m.items()},
            smoke.step_tensors(state.model), gen.get_state(), launches,
            arch)


@pytest.mark.parametrize("dropout", [0.1, 0.0],
                         ids=["unfused tail", "masked tail"])
@pytest.mark.parametrize("captured", [False, True], ids=["eager", "graph"])
def test_remat_step_is_the_step_without_remat(smoke, captured, dropout):
    m1, t1, rng1, n1, arch = _step(smoke, False, dropout, captured)
    m2, t2, rng2, n2, _ = _step(smoke, True, dropout, captured)
    assert m1 == m2 and np.isfinite(m1["loss"])
    for k in t1:
        assert torch.equal(t1[k], t2[k]), k
    assert torch.equal(rng1, rng2)
    if captured and not dropout:   # the unfused tail launches no K1 there
        # (+ drops the zero counts: the last block here is strided, and its
        # dead skip pool takes no backward)
        assert n1 == dict(+smoke.expected_train_launches(arch))
        assert n2 == dict(+smoke.expected_train_launches(arch, forwards=5))
