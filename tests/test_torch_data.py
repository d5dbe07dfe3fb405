"""The port's data layer against the JAX package's, bit for bit.

On the mini-SSv2 fixture (``tests/fixtures.py``): the JPEG shim's decodes,
the ``Ssv2`` items of the val and test splits (and of train without
``AUG.ENABLE``), and the ``Loader``'s collated and padded batches (in
order, from thread and process workers).  Both sides decode with the same libjpeg
code (``decode.cc``), so the frames, the per-item random crops and the
normalisation agree exactly.  The random transforms agree draw for draw
on one seeded ``np.random.Generator`` each.
"""

import os

import numpy as np
import pytest

from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.data import loader as jax_loader
from svit_tpu.data import transform as jax_tf
from svit_tpu.data import utils as jax_utils
from svit_tpu.data.ssv2 import Ssv2 as JaxSsv2
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.data import loader, transform, utils
from svit_tpu_torch.data.build import build_dataset
from svit_tpu_torch.data.ssv2 import Ssv2
from svit_tpu_torch.native import jpeg
from tests.fixtures import make_ssv2_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(get, root, **kw):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.SSV2.DATA_ROOT = root
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 48
    cfg.DATA.TRAIN_JITTER_SCALES = [52, 64]
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.TEST.NUM_SPATIAL_CROPS = 3
    cfg.TEST.BATCH_SIZE = 5
    cfg.TRAIN.BATCH_SIZE = 3
    cfg.DATA_LOADER.NUM_WORKERS = 0
    for k, v in kw.items():
        node, leaf = cfg, k.split(".")
        for p in leaf[:-1]:
            node = node[p]
        node[leaf[-1]] = v
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ssv2"))
    make_ssv2_fixture(path)
    return path


def _same(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b))
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_jpeg_shim_matches_jax(root):
    from svit_tpu.native import jpeg as jax_jpeg

    frames = sorted(os.listdir(os.path.join(root, "frames", "100")))
    paths = [os.path.join(root, "frames", "100", f) for f in frames]
    assert jpeg.available()
    ours, ref = jpeg.decode_batch(paths), jax_jpeg.decode_batch(paths)
    _same(ours, ref)
    _same(jpeg.decode_file(paths[0]), jax_jpeg.decode_file(paths[0]))
    assert jpeg.decode_file(os.path.join(root, "missing.jpg")) is None
    _same(utils.retry_load_images(paths[:3]),
          jax_utils.retry_load_images(paths[:3]))
    _same(utils.load_image(paths[1]), jax_utils.load_image(paths[1]))


@pytest.mark.parametrize("mode", ["val", "test", "train"])
def test_ssv2_items_match_jax(root, mode):
    overrides = {"AUG.ENABLE": False} if mode == "train" else {}
    ours = Ssv2(_cfg(get_cfg, root, **overrides), mode)
    ref = JaxSsv2(_cfg(jax_get_cfg, root, **overrides), mode)
    assert len(ours) == len(ref) == (24 if mode == "test" else 4)
    assert ours.num_videos == ref.num_videos
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ours)):
            _same(ours[i], ref[i])


def test_ssv2_splits_and_refusals(root):
    """Every split reads its files as JAX's does; train with the host
    augmentation builds, and with the on-device one it builds in raw mode
    (its items against JAX's in ``tests/test_torch_device_aug.py``)."""
    for split in ("standard", "compositional", "fewshot-base",
                  "fewshot-5shot", "fewshot-10shotfinetune"):
        ours = Ssv2.__new__(Ssv2)
        ref = JaxSsv2.__new__(JaxSsv2)
        for ds, get in ((ours, get_cfg), (ref, jax_get_cfg)):
            ds.cfg = _cfg(get, root, **{"SSV2.SPLIT": split})
            ds.mode, ds.data_root = "val", root
        assert ours._split_files() == ref._split_files()
    assert Ssv2(_cfg(get_cfg, root, **{"AUG.ENABLE": True}), "train").aug
    raw = Ssv2(_cfg(get_cfg, root, **{"AUG.ENABLE": False,
                                      "TPU.DEVICE_AUG": True}), "train")
    assert raw.raw_mode and raw[0][0].dtype == np.uint8
    assert isinstance(build_dataset("ssv2", _cfg(get_cfg, root), "val"),
                      Ssv2)


@pytest.mark.parametrize("split,workers", [("test", 0), ("test", 2),
                                           ("val", 2)])
def test_loader_batches_match_jax(root, split, workers):
    """In order, the last batch padded with zero-weight rows (24 test
    clips at batch 5; 4 val clips at batch 3)."""
    kw = {"DATA_LOADER.NUM_WORKERS": workers,
          "DATA_LOADER.NUM_WORKERS_VAL": workers}
    ours = loader.construct_loader(_cfg(get_cfg, root, **kw), split)
    ref = jax_loader.construct_loader(_cfg(jax_get_cfg, root, **kw), split,
                                      mesh_data=1)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == len(ours)
    for a, b in zip(got, want):
        _same(a, b)
    last = got[-1]
    assert last["weight"].min() == 0.0 and last["clips"].shape[0] == \
        ours.batch_size


def test_loader_refuses_the_training_splits(root):
    """The training splits build (``tests/test_torch_train_data.py``
    holds their batches against JAX's), the on-device augmentation's raw
    uint8 batches too; an unregistered dataset and an unknown split raise.
    The Kinetics dataset is registered (``tests/test_torch_video.py``
    holds it against JAX's): here its CSV is missing."""
    train, _ = loader.construct_loader(
        _cfg(get_cfg, root, **{"TPU.DEVICE_AUG": True}), "train")
    assert next(iter(train))["clips"].dtype == np.uint8
    with pytest.raises(KeyError):
        loader.construct_loader(
            _cfg(get_cfg, root, **{"TRAIN.DATASET": "nosuch"}), "train")
    with pytest.raises(AssertionError, match="train.csv not found"):
        loader.construct_loader(
            _cfg(get_cfg, root, **{"TRAIN.DATASET": "kinetics",
                                   "DATA.PATH_TO_DATA_DIR": root}), "train")
    with pytest.raises(NotImplementedError):
        loader.construct_loader(_cfg(get_cfg, root), "image_test")


def test_collate_and_pad_match_jax():
    rs = np.random.RandomState(0)
    video = [(rs.rand(2, 4, 4, 3).astype(np.float32), i, 10 + i, {})
             for i in range(3)]
    _same(loader.collate_video(video, 5), jax_loader.collate_video(video, 5))
    images = [(rs.rand(1, 4, 4, 3).astype(np.float32), 0, i,
               {"haog_bboxes": rs.rand(1, 3, 4), "contact_state":
                rs.randint(0, 5, 2)}) for i in range(2)]
    _same(loader.collate_image(images, 4), jax_loader.collate_image(images, 4))


def test_random_transforms_match_jax():
    rs = np.random.RandomState(1)
    frames = rs.rand(3, 40, 56, 3).astype(np.float32)
    boxes = (rs.rand(3, 2, 4) * 30).astype(np.float32)
    for spatial_idx in (-1, 0, 1, 2):
        for kw in ({}, {"scale": (0.08, 1.0), "aspect_ratio": (0.75, 1.33)},
                   {"inverse_uniform_sampling": True}):
            if spatial_idx >= 0 and kw:
                continue
            scales = (36, 44) if spatial_idx < 0 else (36, 36)
            args = dict(spatial_idx=spatial_idx, min_scale=scales[0],
                        max_scale=scales[1], crop_size=32, boxes=boxes, **kw)
            _same(transform.spatial_sampling(
                      frames, np.random.default_rng(5), **args),
                  jax_tf.spatial_sampling(
                      frames, np.random.default_rng(5), **args))
    g1, g2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        _same(transform.horizontal_flip(0.5, frames, g1, boxes),
              jax_tf.horizontal_flip(0.5, frames, g2, boxes))
        _same(transform._get_param_spatial_crop((0.5, 1.0), (0.5, 2.0), 40,
                                                56, g1),
              jax_tf._get_param_spatial_crop((0.5, 1.0), (0.5, 2.0), 40, 56,
                                             g2))
    g1, g2 = np.random.default_rng(3), np.random.default_rng(3)
    _same(utils.sample_seq_frames(30, 8, "train", g1),
          jax_utils.sample_seq_frames(30, 8, "train", g2))
    assert utils.frame_path("r", "12", 0) == jax_utils.frame_path("r", "12", 0)


def test_loader_process_pool_shuffle_and_epochs_match_jax(root):
    """The process pool (spawned workers) gives the in-process batches; a
    shuffled loader gives JAX's order and items at each epoch."""
    ds = Ssv2(_cfg(get_cfg, root), "test")
    pooled = loader.Loader(ds, 5, shuffle=False, drop_last=False,
                           num_workers=2, use_processes=True)
    _same(list(pooled), list(loader.Loader(ds, 5, shuffle=False,
                                           drop_last=False)))
    ref_ds = JaxSsv2(_cfg(jax_get_cfg, root), "test")
    ours = loader.Loader(ds, 4, shuffle=True, drop_last=True, seed=3)
    ref = jax_loader.Loader(ref_ds, 4, shuffle=True, drop_last=True, seed=3)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        loader.shuffle_dataset(ref, epoch)
        assert len(ours) == len(ref) == 6
        _same(list(ours), list(ref))
