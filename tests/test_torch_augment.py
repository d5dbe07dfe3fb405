"""The port's host augmentations against the JAX package's on the same
seeds: RandAugment (with and without boxes, every policy string the
configs use), random erasing (every mode) and mixup / cutmix.  Both sides
are numpy and PIL on the host, drawing from ``np.random.Generator``s, so
the outputs agree exactly: uint8 frames bit for bit, f32 to 1e-6."""

import numpy as np
import pytest
from PIL import Image

from svit_tpu.data import mixup as jmix
from svit_tpu.data import rand_augment as jra
from svit_tpu.data import random_erasing as jre
from svit_tpu_torch.data import mixup as tmix
from svit_tpu_torch.data import rand_augment as tra
from svit_tpu_torch.data import random_erasing as tre


def _clip(n=4, seed=0, size=(40, 48)):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 255, (n, *size, 3), dtype=np.uint8)


@pytest.mark.parametrize("policy", ["rand-m7-n4-mstd0.5-inc1",
                                    "rand-m9-n2", "rand-m10-n3-mstd1"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rand_augment_matches(policy, seed):
    clip = _clip(seed=seed)
    outs = []
    for mod in (jra, tra):
        ra = mod.rand_augment_transform(
            policy, interpolation="bicubic",
            rng=np.random.default_rng(seed))
        frames = ra([Image.fromarray(f) for f in clip])
        outs.append(np.stack([np.asarray(f) for f in frames]))
    assert outs[0].dtype == np.uint8
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_rand_augment_with_boxes_matches(seed):
    clip = _clip(n=1, seed=seed)
    rs = np.random.RandomState(seed)
    x1 = rs.uniform(0, 20, (1, 4, 1))
    y1 = rs.uniform(0, 16, (1, 4, 1))
    boxes = np.concatenate([x1, y1, x1 + 10, y1 + 8], -1).astype(np.float32)
    outs = []
    for mod in (jra, tra):
        ra = mod.rand_augment_transform(
            "rand-m7-n4-mstd0.5-inc1", interpolation="bicubic",
            with_boxes=True, rng=np.random.default_rng(seed))
        frames, b = ra([Image.fromarray(f) for f in clip], boxes=boxes.copy())
        outs.append((np.stack([np.asarray(f) for f in frames]), b))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["pixel", "rand", "const"])
@pytest.mark.parametrize("count", [1, 2])
def test_random_erasing_matches(mode, count):
    frames = np.random.RandomState(7).randn(4, 32, 40, 3).astype(np.float32)
    outs = [mod.RandomErasing(1.0, mode=mode, min_count=count,
                              max_count=count,
                              rng=np.random.default_rng(11))(frames.copy())
            for mod in (jre, tre)]
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-6)
    assert not np.array_equal(outs[1], frames)


@pytest.mark.parametrize("alpha,cutmix,switch", [(0.8, 0.0, 0.0),
                                                 (0.0, 1.0, 0.0),
                                                 (0.8, 1.0, 0.5)])
def test_mixup_matches(alpha, cutmix, switch):
    clips = np.random.RandomState(2).randn(4, 2, 16, 16, 3).astype(
        np.float32)
    labels = np.array([0, 3, 1, 4], np.int32)
    outs = []
    for mod in (jmix, tmix):
        mix = mod.MixUp(mixup_alpha=alpha, cutmix_alpha=cutmix, mix_prob=1.0,
                        switch_prob=switch, label_smoothing=0.1,
                        num_classes=5, rng=np.random.default_rng(9))
        outs.append([mix(clips.copy(), labels) for _ in range(3)])
    for (jc, jl), (tc, tl) in zip(*outs):
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
