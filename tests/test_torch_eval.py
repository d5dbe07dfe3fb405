"""The port's eval steps, metrics and meters against the JAX package's.

- ``make_eval_step`` (single task, without and with the loss and the
  consistency frames forward; multitask with the joint counts),
  ``make_image_eval_step`` and ``make_test_step`` against JAX's jitted
  steps at the reduced size of ``tests/test_torch_model.py`` (the 16-block
  schedule at 56 px, 4 frames, f32), on the port's seeded weights carried
  to JAX by ``torch_to_flax``: values to 5e-5, that file's bound; the
  weighted top-k counts exactly (the labels sit at the JAX scores' top-1,
  top-3 and past the top-5, so each count is exercised).
- ``metrics``, ``TestMeter`` (sum and max), ``ValMeter`` and ``ava_eval``
  against JAX's on seeded numpy inputs, exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.engine import ava_eval as jax_ava
from svit_tpu.engine import meters as jax_meters
from svit_tpu.engine import metrics as jax_metrics
from svit_tpu.engine import steps as jax_steps
from svit_tpu.models import build_model as jax_build
from svit_tpu.models.losses import get_loss_func as jax_loss
from svit_tpu.utils.converter import torch_to_flax
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.engine import ava_eval, meters, metrics, steps
from svit_tpu_torch.models import build_model
from svit_tpu_torch.models.losses import get_loss_func

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 5e-5


def _reduced(get, multitask=False):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.NUM_GPUS = 0
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    if multitask:
        cfg.TRAIN.DATASET = "epickitchens"      # the verb / noun heads
    return cfg


def _pair(multitask=False):
    port, arch = build_model(_reduced(get_cfg, multitask), device="cpu")
    params = torch_to_flax({k: v.numpy()
                            for k, v in port.state_dict().items()})["params"]
    jm, _ = jax_build(_reduced(jax_get_cfg, multitask), use_pallas=False)
    return port, arch, jm, params


def _labels_from(scores, rs):
    """Row 0: the top-1 class; row 1: the third; row 2: past the top 5."""
    order = np.argsort(-np.asarray(scores), axis=-1)
    return np.array([order[0, 0], order[1, 2],
                     order[2, 5 + rs.randint(0, 10)]], np.int64)


def _t(batch):
    return {k: ({kk: torch.as_tensor(np.asarray(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.as_tensor(np.asarray(v)))
            for k, v in batch.items()}


def _j(batch):
    return jax.tree.map(jnp.asarray, batch)


def _close(got, want, key):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{key}.{k}")
        return
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, key
    if "correct" in key or key == "count":
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=key)


@pytest.fixture(scope="module")
def single():
    port, arch, jm, params = _pair()
    rs = np.random.RandomState(11)
    clips = rs.randn(3, 4, 56, 56, 3).astype(np.float32)
    test_j = jax.jit(jax_steps.make_test_step(jm))(params, {"clips": clips})
    batch = {"clips": clips, "labels": _labels_from(test_j, rs),
             "weight": np.array([1.0, 1.0, 0.5], np.float32)}
    loss_j = jax_loss(_reduced(jax_get_cfg))
    eval_j = jax.jit(jax_steps.make_eval_step(
        jm, arch.num_classes, loss_j, with_consistency=True))(params,
                                                              _j(batch))
    return port, arch, batch, test_j, eval_j


def test_test_step_matches_jax(single):
    port, _, batch, test_j, _ = single
    out = steps.make_test_step(port)({"clips": torch.as_tensor(batch["clips"])})
    _close(out, test_j, "logits")
    assert not out.requires_grad


@pytest.mark.parametrize("with_loss", [False, True])
def test_eval_step_matches_jax(single, with_loss):
    """Without the loss the step gives the JAX step's logits, counts and
    ``loss_ce`` (which the loss does not change); with it also the
    consistency loss of the 12-frame frames forward and the total."""
    port, arch, batch, _, eval_j = single
    loss_obj = get_loss_func(_reduced(get_cfg)) if with_loss else None
    port.train()
    out = steps.make_eval_step(port, arch.num_classes, loss_obj,
                               with_consistency=with_loss)(_t(batch))
    assert port.training          # the step restores the model's mode
    port.eval()
    want = {k: v for k, v in eval_j.items()
            if with_loss or k in ("logits", "top1_correct", "top5_correct",
                                  "count", "loss_ce")}
    assert set(out) == set(want)
    for k in want:
        _close(out[k], want[k], k)
    # the labels were placed so that each count is exercised
    assert float(out["top1_correct"]) == 1.0
    assert float(out["top5_correct"]) == 2.0


def test_multitask_eval_step_matches_jax():
    port, arch, jm, params = _pair(multitask=True)
    rs = np.random.RandomState(5)
    clips = rs.randn(3, 4, 56, 56, 3).astype(np.float32)
    scores = jax.jit(jax_steps.make_test_step(jm))(params, {"clips": clips})
    batch = {"clips": clips,
             "labels": {n: _labels_from(scores[n], rs)
                        for n, _ in arch.num_classes},
             "weight": np.array([1.0, 0.0, 1.0], np.float32)}
    batch["labels"]["noun"][1] = np.argsort(-np.asarray(
        scores["noun"]))[1, 0]          # verb third, noun first
    want = jax.jit(jax_steps.make_eval_step(
        jm, arch.num_classes, jax_loss(_reduced(jax_get_cfg, True))))(
            params, _j(batch))
    out = steps.make_eval_step(port, arch.num_classes,
                               get_loss_func(_reduced(get_cfg, True)))(
        _t(batch))
    assert set(out) == set(want)
    for k in want:
        _close(out[k], want[k], k)


def test_image_eval_step_matches_jax(single):
    port, _, _, _, _ = single
    rs = np.random.RandomState(3)
    O = _reduced(get_cfg).SVIT.O
    batch = {"frames": rs.randn(3, 1, 56, 56, 3).astype(np.float32),
             "haog_bboxes": (rs.rand(3, 1, O, 4) * 0.5 + 0.1).astype(
                 np.float32),
             "contact_state": rs.randint(-1, 5, (3, 2)),
             "weight": np.array([1.0, 1.0, 0.0], np.float32)}
    jm, _ = jax_build(_reduced(jax_get_cfg), use_pallas=False)
    params = torch_to_flax({k: v.numpy()
                            for k, v in port.state_dict().items()})["params"]
    want = jax.jit(jax_steps.make_image_eval_step(
        jm, jax_loss(_reduced(jax_get_cfg))))(params, _j(batch))
    out = steps.make_image_eval_step(port, get_loss_func(
        _reduced(get_cfg)))(_t(batch))
    assert set(out) == set(want)
    for k in want:
        _close(out[k], want[k], k)


def test_check_nan():
    steps.check_nan({"loss": torch.tensor(1.0)})
    with pytest.raises(RuntimeError, match="NaN"):
        steps.check_nan({"loss": torch.tensor(float("nan"))})


# ---------------------------------------------------------------------------
# Host-side metrics and meters, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("classes", [0, 3, 174])
def test_metrics_match_jax(classes):
    rs = np.random.RandomState(classes)
    preds = rs.rand(40, classes).astype(np.float32)
    labels = rs.randint(0, max(classes, 1), 40)
    ks = (1, 5)
    got = metrics.topks_correct(preds, labels, ks)
    want = jax_metrics.topks_correct(preds, labels, ks)
    assert [int(g) for g in got] == [int(w) for w in want]
    if classes:
        for fn in ("topk_accuracies", "topk_errors"):
            assert getattr(metrics, fn)(preds, labels, ks) == \
                getattr(jax_metrics, fn)(preds, labels, ks)
        t = torch.as_tensor(preds)
        got = metrics.jit_topk_correct(t, torch.as_tensor(labels), ks)
        want = jax_metrics.jit_topk_correct(jnp.asarray(preds),
                                            jnp.asarray(labels), ks)
        assert [int(g) for g in got] == [int(w) for w in want]
        # tensors go through the host counts too
        assert [int(c) for c in metrics.topks_correct(t, labels, ks)] == \
            [int(c) for c in jax_metrics.topks_correct(preds, labels, ks)]


def test_multitask_metrics_match_jax():
    rs = np.random.RandomState(2)
    preds = {"verb": rs.rand(30, 97), "noun": rs.rand(30, 300)}
    labels = {"verb": rs.randint(0, 97, 30), "noun": rs.randint(0, 300, 30)}
    for ks in ((1,), (1, 5)):
        got = metrics.multitask_topks_correct(preds, labels, ks)
        want = jax_metrics.multitask_topks_correct(preds, labels, ks)
        assert [int(g) for g in got] == [int(w) for w in want]


@pytest.mark.parametrize("method", ["sum", "max"])
def test_test_meter_matches_jax(method):
    rs = np.random.RandomState(4)
    videos, clips, classes = 5, 6, 7
    ids = rs.permutation(videos * clips)
    labels = rs.randint(0, classes, videos)
    ours = meters.TestMeter(videos, clips, classes, 3, method)
    ref = jax_meters.TestMeter(videos, clips, classes, 3, method)
    for chunk in np.array_split(ids, 3):
        preds = rs.rand(len(chunk), classes).astype(np.float32)
        for m in (ours, ref):
            m.update_stats(preds, labels[chunk // clips], chunk)
    np.testing.assert_array_equal(ours.video_preds, ref.video_preds)
    np.testing.assert_array_equal(ours.video_labels, ref.video_labels)
    assert ours.finalize_metrics() == ref.finalize_metrics()


def test_val_meter_matches_jax():
    cfg, jcfg = get_cfg(), jax_get_cfg()
    ours, ref = meters.ValMeter(4, cfg), jax_meters.ValMeter(4, jcfg)
    rs = np.random.RandomState(6)
    for i in range(4):
        c1, c5 = float(rs.randint(0, 4)), float(rs.randint(4, 8))
        extra = {"loss_ce": float(rs.rand()), "loss": float(rs.rand())}
        tasks = {"verb": (1.0, 2.0), "noun": (float(i), 3.0)}
        for m in (ours, ref):
            m.update_stats(c1, c5, 8.0, extra, tasks)
            m.update_image_stats(8.0, {"boxes_l1_loss": 0.1 * i})
    assert ours.log_epoch_stats(0) == ref.log_epoch_stats(0)


def test_ava_eval_matches_jax():
    rs = np.random.RandomState(8)

    def boxes(n):
        xy = rs.rand(n, 2) * 0.6
        return np.concatenate([xy, xy + 0.1 + rs.rand(n, 2) * 0.3], 1)

    ours = meters.AVAMeter(1, get_cfg(), "val")
    ref = jax_meters.AVAMeter(1, jax_get_cfg(), "val")
    keys = [f"vid,{i:04d}" for i in range(6) for _ in range(3)]
    pb, gb = boxes(len(keys)), boxes(len(keys))
    pb[::2] = gb[::2] + 0.01            # half the detections hit
    scores = rs.rand(len(keys))
    classes = rs.randint(1, 4, len(keys))
    for m in (ours, ref):
        m.update_stats(keys, pb, scores, classes, gb, classes)
    assert ours.finalize_metrics(log=False) == ref.finalize_metrics(log=False)
    assert ours.full_map > 0
    assert ava_eval.evaluate_detections(ours.groundtruth, ours.detections) \
        == jax_ava.evaluate_detections(ref.groundtruth, ref.detections)
