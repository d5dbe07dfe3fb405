"""The compiled steps (``svit_tpu_torch/engine/graphs.py``) on the card:
CUDA graphs of the train step and the serving forward against the eager
ones.

These need an NVIDIA card and ``nvcc``; without a card they skip.  Run them
there with ``python -m pytest --noconftest tests/test_torch_graphs_cuda.py``.
A small SViT of ``configs/ssv2.yaml``'s widths (head_dim 96), 2 blocks at
56 px and 4 frames, bf16 through the kernels, drop-path and head dropout
on.  Gates: the loss bit for bit (the forward is deterministic and the
replay draws the eager step's masks), the gradient under ``chip_smoke.py``'s
gate against the plain f32 step (``tests/test_torch_determinism_cuda.py``
holds the step to itself bit for bit), the serving forward bit for bit.
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg():
    from svit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.DROPPATH_RATE = 0.4
    cfg.MODEL.NUM_CLASSES = 10
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    return cfg


def _setup(cfg, dtype=torch.bfloat16, kernels=True):
    from svit_tpu_torch.engine import steps
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.models.optimizer import construct_optimizer

    model, _ = build_model(cfg, dtype=dtype, use_kernels=kernels,
                           train=True, device="cuda")
    tx, _ = construct_optimizer(cfg, model, steps_per_epoch=10)
    step, names = steps.make_packed_train_step(
        model, get_loss_func(cfg), tx, video_weight=7 / 8,
        image_weight=1 / 8, with_image=True, with_consistency=True)
    return steps.create_train_state(model, tx), step, names


def _batch(cfg, seed, video=2, image=2):
    S, T = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES
    rs = np.random.RandomState(seed)
    v = {"clips": rs.randn(video, T, S, S, 3).astype(np.float32),
         "labels": rs.randint(0, cfg.MODEL.NUM_CLASSES, video),
         "weight": np.ones((video,), np.float32)}
    i = {"frames": rs.randn(image, 1, S, S, 3).astype(np.float32),
         "haog_bboxes": (rs.rand(image, 1, 4, 4) * 0.5 + 0.1).astype(
             np.float32),
         "contact_state": rs.randint(-1, 5, (image, 2)),
         "weight": np.ones((image,), np.float32)}
    return ({k: torch.as_tensor(x).cuda() for k, x in v.items()},
            {k: torch.as_tensor(x).cuda() for k, x in i.items()})


def _grads(state, m, names):
    """The step's gradient before the clip (which scaled it in place by
    max / norm when the norm reached max)."""
    clip = state.tx.clip_l2norm
    norm = float(m[names.index("grad_norm")])
    undo = norm / clip if clip and norm >= clip else 1.0
    return torch.cat([p.grad.float().flatten() * undo
                      for p in state.model.parameters()])


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_captured_step_equals_the_eager_step(card):
    """Two steps each, the gradients gated against the plain f32 step; the
    first step's loss bit for bit (the second starts from parameters that
    the nondeterministic backward left a few ulps apart, so its loss is
    gated); the replay launched no kernel from the host."""
    from svit_tpu_torch.engine import graphs
    from svit_tpu_torch.ops import _lib

    cfg = _cfg()
    (es, estep, names) = _setup(cfg)
    (cs, cstep_fn, _) = _setup(cfg)
    (fs, fstep, _) = _setup(cfg, torch.float32, kernels=False)
    cstep = graphs.CapturedTrainStep(cstep_fn)
    ge, gc, gf = (torch.Generator(device="cuda") for _ in range(3))
    for i in range(2):
        video, image = _batch(cfg, i)
        for g in (ge, gc, gf):
            g.manual_seed(1000 + i)
        es, me = estep(es, video, image, ge)
        if i == 1:
            _lib.reset_launch_counts()
        cs, mc = cstep(cs, video, image, gc)
        torch.cuda.synchronize()
        if i == 1:
            assert not _lib.LAUNCHES   # a replay launches from no wrapper
        fs, mf = fstep(fs, video, image, gf)
        loss = names.index("loss")
        if i == 0:
            assert float(me[loss]) == float(mc[loss])
        else:
            assert _rel(mc[loss], mf[loss]) <= \
                3 * _rel(me[loss], mf[loss]) + 2e-3
        err_c = _rel(_grads(cs, mc, names), _grads(fs, mf, names))
        err_e = _rel(_grads(es, me, names), _grads(fs, mf, names))
        assert err_c <= 3 * err_e + 2e-3, (i, err_c, err_e)
    (entry,) = cstep.entries.values()
    assert entry.replays == 2 and entry.launches["pooled_attention_bwd"] > 0


def test_two_seeds_draw_different_masks(card):
    """Replays at one seed give one loss, at another seed another (the
    generator's seed and offset are read at replay)."""
    from svit_tpu_torch.engine import graphs

    cfg = _cfg()
    losses = []
    for seed in (5, 5, 6):
        state, step_fn, names = _setup(cfg)
        cstep = graphs.CapturedTrainStep(step_fn)
        video, image = _batch(cfg, 0)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        state, m = cstep(state, video, image, gen)
        losses.append(float(m[names.index("loss")]))
    assert losses[0] == losses[1] != losses[2]


def test_a_second_shape_captures_a_second_graph(card):
    from svit_tpu_torch.engine import graphs

    cfg = _cfg()
    state, step_fn, names = _setup(cfg)
    cstep = graphs.CapturedTrainStep(step_fn)
    gen = torch.Generator(device="cuda")
    for video in (2, 1, 2):
        gen.manual_seed(video)
        state, m = cstep(state, *_batch(cfg, 0, video=video), gen)
        assert np.isfinite(m.cpu().numpy()).all()
    assert sorted(e.replays for e in cstep.entries.values()) == [1, 2]
    assert state.step == 3


def test_a_dead_graph_is_not_collected_during_a_capture(card):
    """A cycle holding a captured graph that dies while another graph is
    captured is collected after the capture, not inside it: destroying a
    graph's executable while a stream captures invalidates the capture.
    The collector's threshold of 1 would collect it at the capture's next
    allocation."""
    import gc

    from svit_tpu_torch.engine import graphs

    class Holder:
        pass

    old = graphs.CapturedStep(lambda b: b * 2)
    old(torch.ones(4, device="cuda"))
    box, calls = [old], []
    del old

    def fn(b):
        calls.append(b)
        if len(calls) == graphs.WARMUP + 1:   # the capture
            dead = Holder()
            dead.me, dead.step = dead, box.pop()
            del dead
        return [b + i for i in range(64)]

    step = graphs.CapturedStep(fn)
    threshold = gc.get_threshold()
    try:
        gc.set_threshold(1)
        out = step(torch.ones(4, device="cuda"))
    finally:
        gc.set_threshold(*threshold)
    assert not box
    assert torch.equal(out[63], torch.full((4,), 64.0, device="cuda"))


def test_serving_graph_equals_the_eager_forward(card):
    from svit_tpu_torch.serving.server import BatchedPredictor

    cfg = _cfg()
    pred = BatchedPredictor(cfg, max_batch=2)
    try:
        clips = np.random.RandomState(0).randn(
            2, 4, 56, 56, 3).astype(np.float32)
        with torch.inference_mode():
            logits, extra = pred.model(torch.from_numpy(clips).cuda())
        want = (logits.float().cpu().numpy(),
                extra["pred_bboxes"].float().cpu().numpy())
        for _ in range(2):
            got = pred.forward(clips)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        (entry,) = pred.graph.entries.values()
        assert entry.replays == 2
    finally:
        pred.stop()
