"""The port's libav shim, clip decoder and Kinetics dataset against the JAX
package's, on real mpeg4 files that the port's encoder writes.

- ``get_start_end_idx`` and ``temporal_sampling``: equal for the test,
  offset and seeded train modes;
- the decoded windows and ``decode``'s clips: bit-equal to the JAX shim's
  on the same file (both build the same ``video_decode.cc`` against the
  same libav); a corrupt file gives None;
- ``Kinetics`` items: bit-equal for train without augmentation, test (3
  crops x 2 views) and train with RandAugment, random erasing and
  ``AUG.NUM_SAMPLE = 2``, on the same two files and seed; and the port's
  test loader over it.
"""

import os

import numpy as np
import pytest

from svit_tpu.config import assert_and_infer_cfg as jax_infer
from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.data import decoder as jax_decoder
from svit_tpu.data.build import build_dataset as jax_build_dataset
from svit_tpu.native import video as jax_video
from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg
from svit_tpu_torch.data import decoder
from svit_tpu_torch.data.build import build_dataset
from svit_tpu_torch.native import video

W, H, N, FPS = 80, 60, 48, 30


def _frames(seed, n=N):
    """Smooth random RGB frames (a coarse noise grid upsampled), so crops,
    flips and RandAugment see structure."""
    rs = np.random.RandomState(seed)
    coarse = rs.randint(0, 256, (n, H // 10, W // 10, 3)).astype(np.uint8)
    return coarse.repeat(10, axis=1).repeat(10, axis=2)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("kinetics")
    paths = []
    for i in range(2):
        p = str(root / f"v{i}.mp4")
        with video.VideoEncoder(p, W, H, FPS) as enc:
            for f in _frames(i):
                enc.write(f)
        paths.append(p)
    for split in ("train", "test"):
        (root / f"{split}.csv").write_text(
            "".join(f"v{i}.mp4 {i + 3}\n" for i in range(2)))
    return str(root), paths


def test_window_math_equals_jax():
    for args in [(100, 20, 0, 4), (100, 20, 3, 4), (100, 20, 0, 1),
                 (10, 32, 2, 3), (300, 32.0, 9, 10)]:
        for off in (False, True):
            assert decoder.get_start_end_idx(*args, use_offset=off) == \
                jax_decoder.get_start_end_idx(*args, use_offset=off)
    for seed in range(3):
        got = decoder.get_start_end_idx(
            100, 20, -1, 0, rng=np.random.default_rng(seed))
        want = jax_decoder.get_start_end_idx(
            100, 20, -1, 0, rng=np.random.default_rng(seed))
        assert got == want
    frames = np.arange(30)[:, None, None, None].repeat(2, 1)
    for start, end, n in [(0, 29, 8), (-5, 40, 5), (3.7, 17.2, 16)]:
        np.testing.assert_array_equal(
            decoder.temporal_sampling(frames, start, end, n),
            jax_decoder.temporal_sampling(frames, start, end, n))


def test_windows_bit_equal_to_jax_shim(videos):
    _, (path, _) = videos
    assert video.probe(path) == jax_video.probe(path)
    fps, nb, dur = video.probe(path)
    assert nb == N and 29 <= fps <= 31
    step = dur / nb
    for window in [(), (0, None), (int(7 * step), int(20 * step))]:
        got, want = video.decode_window(path, *window), \
            jax_video.decode_window(path, *window)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for clip_idx, num_clips in [(0, 3), (2, 3), (-1, 10)]:
        got = decoder.decode(path, 2, 8, clip_idx, num_clips,
                             rng=np.random.default_rng(5))
        want = jax_decoder.decode(path, 2, 8, clip_idx, num_clips,
                                  rng=np.random.default_rng(5))
        assert got.shape == (8, H, W, 3)
        np.testing.assert_array_equal(got, want)


def test_gray_ramp_round_trip(tmp_path):
    path = str(tmp_path / "ramp.mp4")
    assert video.encode_gray_ramp(path, 64, 48, 30, 30)
    frames, pts = video.decode_window(path)
    assert frames.shape == (30, 48, 64, 3) and list(pts) == sorted(pts)
    want = jax_video.decode_window(path)
    np.testing.assert_array_equal(frames, want[0])


def test_corrupt_file_gives_none(tmp_path):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a container")
    assert video.probe(str(bad)) is None
    assert decoder.decode(str(bad), 2, 8) is None


def _cfgs(root, **over):
    out = []
    for get, infer in ((get_cfg, assert_and_infer_cfg),
                       (jax_get_cfg, jax_infer)):
        cfg = get()
        cfg.TRAIN.DATASET = cfg.TEST.DATASET = "kinetics"
        cfg.DATA.PATH_TO_DATA_DIR = root
        cfg.DATA.PATH_PREFIX = root
        cfg.DATA.NUM_FRAMES = 4
        cfg.DATA.SAMPLING_RATE = 2
        cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
        cfg.DATA.TRAIN_JITTER_SCALES = [36, 48]
        cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 2, 3
        cfg.NUM_GPUS = 0
        cfg.AUG.ENABLE = False
        for k, v in over.items():
            node = cfg
            *path, leaf = k.split(".")
            for p in path:
                node = node[p]
            node[leaf] = v
        out.append(infer(cfg))
    return out


def _items_equal(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _items_equal(g, w)
        return
    assert got[1:] == want[1:]
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


@pytest.mark.parametrize("mode,over", [
    ("train", {}),
    ("test", {}),
    ("train", {"AUG.ENABLE": True, "AUG.NUM_SAMPLE": 2,
               "AUG.RE_PROB": 0.25}),
], ids=["train", "test", "train_aug"])
def test_kinetics_items_bit_equal(videos, mode, over):
    root, _ = videos
    cfg, jcfg = _cfgs(root, **over)
    ds = build_dataset("kinetics", cfg, mode)
    jds = jax_build_dataset("kinetics", jcfg, mode)
    assert len(ds) == len(jds) == (12 if mode == "test" else 2)
    assert ds.samples_per_item == jds.samples_per_item
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            _items_equal(ds[i], jds[i])


def test_kinetics_test_loader(videos):
    from svit_tpu_torch.data.loader import construct_loader

    root, _ = videos
    cfg, _ = _cfgs(root, **{"TEST.BATCH_SIZE": 5,
                            "DATA_LOADER.NUM_WORKERS": 0})
    batches = list(construct_loader(cfg, "test"))
    assert [b["clips"].shape for b in batches] == [(5, 4, 32, 32, 3)] * 3
    weight = np.concatenate([b["weight"] for b in batches])
    labels = np.concatenate([b["labels"] for b in batches])[weight > 0]
    assert weight.sum() == 12 and sorted(set(labels.tolist())) == [3, 4]


def test_missing_shim_raises_with_the_build_error(monkeypatch, tmp_path):
    from svit_tpu_torch.native import _shim

    shim = _shim.Shim("libsvit_absent.so", lambda lib: None)
    assert shim.load() is None and shim.error
    with pytest.raises(RuntimeError, match="libsvit_absent.so"):
        shim.require()
    monkeypatch.setattr(video, "SHIM", shim)
    with pytest.raises(RuntimeError, match="could not be built"):
        video.VideoEncoder(str(tmp_path / "x.mp4"), 8, 8, 30)
    assert os.path.isdir(_shim.OUT)
