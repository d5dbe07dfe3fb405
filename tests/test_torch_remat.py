"""``TPU.REMAT`` in the port (``models/svit.py``: each block under
``torch.utils.checkpoint``, the counterpart of the JAX package's
``nn.remat``), on the CPU through the plain twins at 56 px, 4 frames, 2
blocks (the second strided).

- The train step with remat equals the step without it bit for bit: the
  loss and every metric, every gradient, the parameters after AdamW and
  the generator's state after the step, with drop-path 0.4, head dropout
  0.5 and ``MVIT.DROPOUT_RATE`` 0.1 (the unfused tail) or 0 (the masked
  fused tail), in f32 and in bf16.  Each block runs again in the
  backward: its forward is called twice for each forward that wants a
  gradient.  In f32 the step has the consistency forward and the image
  branch; in bf16 the video branch alone, since the CPU's bf16 ``conv3d``
  gives NaN on one-frame inputs (the stem of those two forwards).
- The same through ``tests/test_torch_graphs.py``'s stand-in graph (the
  captured step's warm-ups, restore and replay), two steps.
- The remat step against the JAX package's train step with
  ``TPU.REMAT=True`` and ``use_pallas=False``, deterministic, at
  ``tests/test_torch_train_step.py``'s tolerances (that test's body, both
  configs with remat on).
"""

import os

import numpy as np
import pytest
import torch

import tests.test_torch_train_step as train_step_test
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.engine import graphs, steps
from svit_tpu_torch.models import attention, build_model
from svit_tpu_torch.models.losses import get_loss_func
from svit_tpu_torch.models.optimizer import construct_optimizer
from tests.test_torch_graphs import EagerGraph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one thread here, beside JAX's thread pool in the same
    process and the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(remat, dropout, bf16):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = DEPTH
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.DROPPATH_RATE = 0.4
    cfg.MVIT.DROPOUT_RATE = dropout
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.MODEL.NUM_CLASSES = 10
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    cfg.TRAIN.MIXED_PRECISION = bf16
    cfg.TPU.REMAT = remat
    cfg.NUM_GPUS = 0
    return cfg


def _batches(cfg, step):
    rs = np.random.RandomState(step)
    S, T, O = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES, cfg.SVIT.O
    video = {"clips": rs.randn(2, T, S, S, 3).astype(np.float32),
             "labels": rs.randint(0, cfg.MODEL.NUM_CLASSES, 2),
             "weight": np.ones(2, np.float32)}
    image = {"frames": rs.randn(2, 1, S, S, 3).astype(np.float32),
             "haog_bboxes": (rs.rand(2, 1, O, 4) * 0.5 + 0.1).astype(
                 np.float32),
             "contact_state": np.array([[0, -1], [3, 1]]),
             "weight": np.ones(2, np.float32)}
    return ({k: torch.as_tensor(v) for k, v in video.items()},
            {k: torch.as_tensor(v) for k, v in image.items()})


class _BlockRuns:
    """Counts the calls of every block's forward."""

    def __init__(self, monkeypatch):
        self.n = 0
        forward = attention.MultiScaleBlock.forward

        def counted(blk, *a, **k):
            self.n += 1
            return forward(blk, *a, **k)

        monkeypatch.setattr(attention.MultiScaleBlock, "forward", counted)


def _run(remat, dropout, bf16, captured=False, steps_taken=1):
    """Steps from the seeded weights; returns (the metrics of each step,
    gradients, parameters, the generator's state after)."""
    cfg = _cfg(remat, dropout, bf16)
    model, arch = build_model(cfg, device="cpu", train=True)
    assert arch.remat == remat
    tx, _ = construct_optimizer(cfg, model, steps_per_epoch=10)
    state = steps.create_train_state(model, tx)
    # the CPU's bf16 conv3d gives NaN on one-frame inputs: video alone
    step = steps.make_train_step(
        model, get_loss_func(cfg), tx, video_weight=7 / 8, image_weight=1 / 8,
        with_image=not bf16, with_consistency=not bf16)
    if captured:
        step = graphs.CapturedTrainStep(step, graph_factory=EagerGraph)
    gen = torch.Generator()
    metrics = []
    for i in range(steps_taken):
        gen.manual_seed(100 + i)
        video, image = _batches(cfg, i)
        state, m = step(state, video, image, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    named = dict(model.named_parameters())
    return (metrics, {k: p.grad.clone() for k, p in named.items()},
            {k: p.detach().clone() for k, p in named.items()},
            gen.get_state())


def _assert_bit_equal(got, want):
    (m, g, p, rng), (rm, rg, rp, rrng) = got, want
    assert m == rm
    assert all(np.isfinite(v) for s in m for v in s.values())
    for k in rg:
        assert torch.equal(g[k], rg[k]), k
        assert torch.equal(p[k], rp[k]), k
    assert torch.equal(rng, rrng)


@pytest.mark.parametrize("dropout", [0.1, 0.0],
                         ids=["unfused tail", "masked tail"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_remat_step_equals_step_without_remat(monkeypatch, bf16, dropout):
    runs = _BlockRuns(monkeypatch)
    want = _run(False, dropout, bf16)
    plain_runs, runs.n = runs.n, 0
    got = _run(True, dropout, bf16)
    _assert_bit_equal(got, want)
    # every forward that wants a gradient runs each block twice (the
    # consistency forward is no-grad)
    grad_forwards = 1 if bf16 else 2
    assert plain_runs == DEPTH * (grad_forwards + (not bf16))
    assert runs.n == plain_runs + DEPTH * grad_forwards


def test_remat_captured_step_equals_step_without_remat():
    """Two captured steps (the stand-in graph: warm-ups, the restore, the
    capture and a replay each) with remat against two without, in f32
    with the unfused tail."""
    _assert_bit_equal(_run(True, 0.1, False, captured=True, steps_taken=2),
                      _run(False, 0.1, False, captured=True, steps_taken=2))


def test_remat_step_matches_jax(monkeypatch):
    """``tests/test_torch_train_step.py:test_train_step_matches_jax`` with
    ``TPU.REMAT=True`` on both sides: the JAX step's blocks under
    ``nn.remat``, the port's under ``torch.utils.checkpoint``."""
    base = train_step_test._cfg

    def remat_cfg(get):
        cfg = base(get)
        cfg.TPU.REMAT = True
        return cfg

    from svit_tpu.config import get_cfg as jax_get_cfg
    from svit_tpu.models.svit import SViTArch as JaxArch

    assert JaxArch.from_cfg(remat_cfg(jax_get_cfg)).remat
    assert build_model(remat_cfg(get_cfg), device="cpu")[1].remat
    monkeypatch.setattr(train_step_test, "_cfg", remat_cfg)
    train_step_test.test_train_step_matches_jax()
