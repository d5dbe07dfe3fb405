"""The port's training data layer against the JAX package's, bit for bit.

On ``tests/fixtures.py``'s mini-SSv2 and 100DOH trees, with
``configs/ssv2.yaml``'s augmentation (RandAugment
``rand-m7-n4-mstd0.5-inc1``, the random-resized crop, random erasing in
pixel mode, here at 0.5 so that it shows) at 32 px and 4 frames: ``Ssv2`` train items, ``Ssv2_frames`` and
``Doh_frames`` items with their boxes and contact states, the
``Multi_images`` mixture, and the ``train`` (video and image loaders) and
``image_val`` loaders over two epochs.  Both sides decode with the same
libjpeg code and draw from the same per-item generators, so every frame,
box and label agrees exactly.  Also ``zero_empty_boxes`` (torch) and
``match_haog`` (numpy) against JAX's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.data import loader as jax_loader
from svit_tpu.data.build import build_dataset as jax_build_dataset
from svit_tpu.ops import box_ops as jax_box_ops
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.data import loader
from svit_tpu_torch.data.build import build_dataset
from svit_tpu_torch.ops import box_ops
from tests.fixtures import make_doh_fixture, make_ssv2_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(get, roots, **kw):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.SSV2.DATA_ROOT, cfg.DOH.DATA_ROOT = roots
    cfg.MODEL.NUM_CLASSES = 5
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.TRAIN_JITTER_SCALES = [36, 44]
    cfg.AUG.RE_PROB = 0.5          # erase often enough to be seen
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.IMAGE_TRAIN.BATCH_SIZE = 2
    cfg.DATA_LOADER.NUM_WORKERS = 0
    for k, v in kw.items():
        node, leaf = cfg, k.split(".")
        for p in leaf[:-1]:
            node = node[p]
        node[leaf[-1]] = v
    return cfg


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    ssv2 = str(tmp_path_factory.mktemp("ssv2"))
    make_ssv2_fixture(ssv2)
    doh = str(tmp_path_factory.mktemp("doh"))
    make_doh_fixture(doh)
    return ssv2, doh


def _same(a, b, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name,split", [("ssv2", "train"),
                                        ("ssv2_frames", "train"),
                                        ("ssv2_frames", "val"),
                                        ("doh_frames", "train"),
                                        ("doh_frames", "val")])
def test_dataset_items_match_jax(roots, name, split):
    """Every item of two epochs, augmented in train."""
    ours = build_dataset(name, _cfg(get_cfg, roots), split)
    ref = jax_build_dataset(name, _cfg(jax_get_cfg, roots), split)
    assert len(ours) == len(ref) > 0
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ours)):
            got, want = ours[i], ref[i]
            _same(got, want, f"{name} {split} epoch {epoch} item {i}")
    if split == "train" and name == "ssv2":
        assert ours.aug and ours.rand_erase
    if name != "ssv2":
        box = got[3]["haog_bboxes"]
        assert box.shape == (1, 4, 4) and box.dtype == np.float32
        assert got[3]["contact_state"].shape == (2,)


def test_multi_images_mixture_matches_jax(roots):
    kw = {"IMAGE_TRAIN.DATASETS": ["ssv2_frames", "doh_frames"]}
    ours = build_dataset("multi_images", _cfg(get_cfg, roots, **kw), "train")
    ref = jax_build_dataset("multi_images", _cfg(jax_get_cfg, roots, **kw),
                            "train")
    assert len(ours) == len(ref) == 100 * ours.base_len
    assert [type(d).__name__ for d in ours.datasets] == \
        ["Ssv2_frames", "Doh_frames"]
    for i in (0, 3, 4, 9, ours.base_len + 5, len(ours) - 1):
        _same(ours[i], ref[i], f"item {i}")


@pytest.mark.parametrize("workers", [0, 2])
def test_train_loaders_match_jax_over_two_epochs(roots, workers):
    """The video and image train loaders (shuffled by RNG_SEED and
    RNG_SEED + 1 and the epoch, the last partial batch dropped) and the
    image val loader give JAX's batches, in order, over two epochs."""
    kw = {"IMAGE_TRAIN.DATASETS": ["ssv2_frames", "doh_frames"],
          "DATA_LOADER.NUM_WORKERS": workers,
          "DATA_LOADER.USE_PROCESSES": False}
    vid, img = loader.construct_loader(_cfg(get_cfg, roots, **kw), "train")
    jvid, jimg = jax_loader.construct_loader(_cfg(jax_get_cfg, roots, **kw),
                                             "train", mesh_data=1)
    assert img is not None and len(vid) == len(jvid) == 2
    for epoch in (0, 1):
        loader.shuffle_dataset((vid, img), epoch)
        jax_loader.shuffle_dataset((jvid, jimg), epoch)
        for a, b in zip(vid, jvid):
            _same(a, b, f"video epoch {epoch}")
        ours, ref = img.iter_batches(1), jimg.iter_batches(1)
        for _ in range(3):
            _same(next(ours), next(ref), f"image epoch {epoch}")
    val = loader.construct_loader(_cfg(get_cfg, roots, **kw), "image_val")
    jval = jax_loader.construct_loader(_cfg(jax_get_cfg, roots, **kw),
                                       "image_val", mesh_data=1)
    got, want = list(val), list(jval)
    assert len(got) == len(want) == len(val) > 0
    for a, b in zip(got, want):
        _same(a, b, "image_val")


def test_no_image_loader_without_image_ranks(roots):
    cfg = _cfg(get_cfg, roots, **{"IMAGE_TRAIN.GPU_IDS": []})
    vid, img = loader.construct_loader(cfg, "train")
    assert img is None and len(vid) == 2


def test_zero_empty_boxes_matches_jax():
    rs = np.random.RandomState(0)
    boxes = rs.rand(3, 2, 4, 4).astype(np.float32) * 0.3
    boxes[0, 0, 1, 2] = 0.01
    boxes[1, 1, 3] = 0.0
    for mode in ("cxcywh", "xyxy"):
        got = box_ops.zero_empty_boxes(torch.from_numpy(boxes), mode)
        want = np.asarray(jax_box_ops.zero_empty_boxes(jnp.asarray(boxes),
                                                       mode))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy() == 0).all(-1).any()


@pytest.mark.parametrize("seed", range(6))
def test_match_haog_matches_jax(seed):
    rs = np.random.RandomState(seed)
    haog = rs.rand(4, 4).astype(np.float32)
    haog[seed % 4] = 0.0            # a missing box in each position
    if seed == 5:
        haog[2] = haog[0] + 0.01    # in contact
    got = box_ops.match_haog(haog)
    want = jax_box_ops.match_haog(haog)
    _same(got, want, f"seed {seed}")
