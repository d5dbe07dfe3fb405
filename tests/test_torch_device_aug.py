"""The port's on-device augmentation (``svit_tpu_torch/data/device_aug.py``)
against the JAX package's (``svit_tpu/data/device_aug.py``).

The two frameworks' random streams cannot match, so each test repeats
``jax.random`` on the keys the JAX function splits, in its order, and hands
the drawn values to the port's draw-free functions; the JAX function draws
its own from the same keys.  Inputs come from numpy at a seed.  Everything
is f32.  Each part is held within 1e-5 (absolute and relative): the two
sides run the same arithmetic in the same order, and differ only by the
last bits of ``exp``, ``sqrt``, ``cos``, ``sin`` and the mean reductions.
The whole pipeline, compared with JAX's jitted function, is held within
1e-4 absolute in normalised units: XLA contracts the warp's products into
fused multiply-adds (2e-6 apart from the unfused form on [0, 1] pixels),
and contrast and saturation (factors up to 1.9 each) and the division by
the std of 0.225 scale that by up to 16.  Also the raw
modes of ``Ssv2`` and ``Ssv2_frames`` (``TPU.DEVICE_AUG``) against the JAX
datasets on ``tests/fixtures.py``'s tree: equal as uint8, boxes equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.data import device_aug as jda
from svit_tpu.data.build import build_dataset as jax_build_dataset
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.data import device_aug as tda
from svit_tpu_torch.data.build import build_dataset
from tests.fixtures import make_doh_fixture, make_ssv2_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
PIPELINE_TOL = dict(rtol=1e-5, atol=1e-4)
CFG = jda.DeviceAugConfig(out_size=24, hflip_prob=0.5, re_prob=0.5)
# every op applied, every frame erased: the gates' other branch
ALL_ON = CFG._replace(op_prob=1.0, re_prob=1.0)


# ---------------------------------------------------------------------------
# JAX's draws, repeated on the keys its functions split
# ---------------------------------------------------------------------------

def _u(k, lo=0.0, hi=1.0):
    return jax.random.uniform(k, (), minval=lo, maxval=hi)


def _op(d, name, k):
    kk = jax.random.split(k, 3)
    d[f"{name}_n"] = jax.random.normal(kk[0], ())
    d[f"{name}_sign"] = _u(kk[1])
    d[f"{name}_apply"] = _u(kk[2])


def jax_affine_draws(key, cfg):
    ks = jax.random.split(key, 8)
    d = {"area": _u(ks[0], cfg.scale_min, cfg.scale_max),
         "log_ratio": _u(ks[1], jnp.log(cfg.ratio_min),
                         jnp.log(cfg.ratio_max)),
         "x": _u(ks[2]), "y": _u(ks[3])}
    for name, k in zip(tda.GEOMETRIC_OPS, ks[4:7]):
        _op(d, name, k)
    d["flip"] = _u(ks[7])
    return d


def jax_photometric_draws(key):
    ks = jax.random.split(key, 8)
    d = {}
    for name, k in zip(tda.PHOTOMETRIC_OPS, ks[:3]):
        _op(d, name, k)
    d["sol_n"] = jax.random.normal(ks[3], ())
    d["sol_apply"] = _u(ks[4])
    return d


def jax_erase_draws(key, T, S, C):
    out = {k: [] for k in ("do", "area", "log_aspect", "top", "left",
                           "noise")}
    for k in jax.random.split(key, T):
        ks = jax.random.split(k, 6)
        out["do"].append(_u(ks[0]))
        out["area"].append(_u(ks[1], 0.02, 1 / 3))
        out["log_aspect"].append(_u(ks[2], jnp.log(0.3), jnp.log(1 / 0.3)))
        out["top"].append(_u(ks[3]))
        out["left"].append(_u(ks[4]))
        out["noise"].append(jax.random.normal(ks[5], (S, S, C)))
    return {k: jnp.stack(v) for k, v in out.items()}


def jax_batch_draws(key, B, T, C, cfg):
    """The draws of ``device_augment`` / ``device_augment_image``, batched
    as the port takes them."""
    keys = jax.random.split(key, B * 3).reshape(B, 3, 2)
    per = [{"affine": jax_affine_draws(ks[0], cfg),
            "photometric": jax_photometric_draws(ks[1]),
            "erase": jax_erase_draws(ks[2], T, cfg.out_size, C)}
           for ks in keys]
    return {part: {k: torch.from_numpy(np.stack(
        [np.array(p[part][k]) for p in per])) for k in per[0][part]}
        for part in per[0]}


def _one(d):
    """A single clip's draws as the port's batch of one."""
    return {k: torch.from_numpy(np.array(v))[None] for k, v in d.items()}


def _tcfg(cfg):
    return tda.DeviceAugConfig(**cfg._asdict())


# ---------------------------------------------------------------------------
# The parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [CFG, ALL_ON])
@pytest.mark.parametrize("hw", [(40, 56), (64, 36)])
def test_affine_matrix_matches_jax(cfg, hw):
    H, W = hw
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jda._affine_matrix(key, H, W, cfg))
        got = tda.affine_matrix(_one(jax_affine_draws(key, cfg)), H, W,
                                _tcfg(cfg))[0].numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_warp_matches_jax():
    """The bilinear resample, through affines that crop, flip, shear and
    rotate, some of them reaching past the frame (clamped taps)."""
    rs = np.random.RandomState(0)
    frames = rs.rand(3, 40, 56, 3).astype(np.float32)
    for seed in range(6):
        M = jda._affine_matrix(jax.random.PRNGKey(seed), 40, 56, ALL_ON)
        if seed == 5:   # far outside the frame on every side
            M = M * 3.0
        want = np.asarray(jda._warp_clip(jnp.asarray(frames), M, 24))
        got = tda.warp_clips(torch.from_numpy(frames)[None],
                             torch.from_numpy(np.asarray(M))[None], 24)[0]
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cfg", [CFG, ALL_ON])
def test_photometric_matches_jax(cfg):
    rs = np.random.RandomState(1)
    clip = rs.rand(3, 24, 24, 3).astype(np.float32)
    for seed in range(8):
        key = jax.random.PRNGKey(100 + seed)
        want = np.asarray(jda._photometric(key, jnp.asarray(clip), cfg))
        got = tda.photometric(torch.from_numpy(clip)[None],
                              _one(jax_photometric_draws(key)), _tcfg(cfg))
        np.testing.assert_allclose(got[0].numpy(), want, **TOL)


@pytest.mark.parametrize("cfg", [CFG, ALL_ON])
def test_erase_matches_jax(cfg):
    rs = np.random.RandomState(2)
    clip = rs.randn(4, 24, 24, 3).astype(np.float32)
    for seed in range(6):
        key = jax.random.PRNGKey(200 + seed)
        want = np.asarray(jda._erase(key, jnp.asarray(clip), cfg))
        got = tda.erase(torch.from_numpy(clip)[None],
                        _one(jax_erase_draws(key, 4, 24, 3)), _tcfg(cfg))
        np.testing.assert_allclose(got[0].numpy(), want, **TOL)
        if cfg is ALL_ON:   # every frame has its box of noise
            assert (got[0].numpy() != clip).any(axis=(1, 2, 3)).all()


@pytest.mark.parametrize("cfg", [CFG, ALL_ON])
def test_device_augment_matches_jax(cfg):
    """uint8 clips to augmented, normalised f32: the whole batch."""
    rs = np.random.RandomState(3)
    clips = rs.randint(0, 256, (2, 3, 40, 48, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jda.device_augment(jnp.asarray(clips), key, cfg))
    draws = jax_batch_draws(key, 2, 3, 3, cfg)
    got, _ = tda.augment_clips(torch.from_numpy(clips), draws, _tcfg(cfg))
    assert got.shape == want.shape == (2, 3, 24, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, **PIPELINE_TOL)


def _boxes(rs, B, O=4, H=40, W=48):
    """xyxy pixel boxes [B, 1, O, 4], some slots empty (all zero)."""
    x = np.sort(rs.rand(B, 1, O, 2) * W, axis=-1)
    y = np.sort(rs.rand(B, 1, O, 2) * H, axis=-1)
    boxes = np.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)
    boxes[0, 0, 1] = 0.0
    boxes[-1, 0, 3] = 0.0
    return boxes.astype(np.float32)


def test_box_transform_and_haog_match_jax():
    rs = np.random.RandomState(4)
    boxes = _boxes(rs, 3)
    for seed in range(6):
        Ms = [jda._affine_matrix(jax.random.PRNGKey(300 + seed + 10 * b),
                                 40, 48, ALL_ON) for b in range(3)]
        want_xyxy = np.stack([np.asarray(jda._transform_boxes(
            M, jnp.asarray(boxes[b]), 24)) for b, M in enumerate(Ms)])
        got_xyxy = tda.transform_boxes(
            torch.from_numpy(np.stack([np.asarray(M) for M in Ms])),
            torch.from_numpy(boxes), 24)
        np.testing.assert_allclose(got_xyxy.numpy(), want_xyxy, **TOL)
        was_zero = np.all(boxes == 0.0, axis=-1)
        want = np.asarray(jda._boxes_to_haog(jnp.asarray(want_xyxy), 24,
                                             jnp.asarray(was_zero)))
        got = tda.boxes_to_haog(torch.from_numpy(want_xyxy), 24,
                                torch.from_numpy(was_zero))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # the empty slots stay empty
        assert (got.numpy()[0, 0, 1] == 0).all()
        assert (got.numpy()[-1, 0, 3] == 0).all()


def test_boxes_to_haog_zeroes_degenerate_boxes():
    """A box the crop pushed off the frame (zero width or height after the
    clip to [0, S]) and an originally empty one both become zeros."""
    xyxy = np.array([[[[0.0, 0.0, 0.0, 5.0], [3.0, 4.0, 9.0, 4.0],
                       [2.0, 2.0, 10.0, 12.0], [0.0, 0.0, 0.0, 0.0]]]],
                    np.float32)
    was_zero = np.array([[[False, False, False, True]]])
    want = np.asarray(jda._boxes_to_haog(jnp.asarray(xyxy), 24,
                                         jnp.asarray(was_zero)))
    got = tda.boxes_to_haog(torch.from_numpy(xyxy), 24,
                            torch.from_numpy(was_zero)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[0, 0, [0, 1, 3]] == 0).all() and (got[0, 0, 2] != 0).all()


def test_device_augment_image_matches_jax():
    rs = np.random.RandomState(5)
    frames = rs.randint(0, 256, (3, 1, 40, 48, 3)).astype(np.uint8)
    boxes = _boxes(rs, 3)
    key = jax.random.PRNGKey(11)
    want_f, want_b = jda.device_augment_image(
        jnp.asarray(frames), jnp.asarray(boxes), key, ALL_ON)
    draws = jax_batch_draws(key, 3, 1, 3, ALL_ON)
    got_f, got_b = tda.augment_images(torch.from_numpy(frames),
                                      torch.from_numpy(boxes), draws,
                                      _tcfg(ALL_ON))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               **PIPELINE_TOL)
    # a box the crop squeezed to nothing: the port's width or height is
    # 0 and the box zeroed, as the source says; XLA contracts the jitted
    # ``x2 / S - x1 / S`` into a fused multiply-add and leaves 3e-8 there
    got_b, want_b = got_b.numpy(), np.asarray(want_b)
    flat = (want_b[..., 2] < 1e-6) | (want_b[..., 3] < 1e-6)
    np.testing.assert_allclose(got_b[~flat], want_b[~flat], **TOL)
    assert (got_b[flat] == 0).all()


def test_config_from_cfg_matches_jax():
    for flip in (False, True):
        jcfg, tcfg = jax_get_cfg(), get_cfg()
        for c in (jcfg, tcfg):
            c.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
            c.DATA.RANDOM_FLIP = flip
        assert tda.config_from_cfg(tcfg)._asdict() == \
            jda.config_from_cfg(jcfg)._asdict()


def test_port_draws_from_its_generator():
    """The port's own draws: one seed gives one batch, another seed
    another; every value finite and normalised as the plan says."""
    rs = np.random.RandomState(6)
    clips = torch.from_numpy(rs.randint(0, 256, (2, 3, 40, 48, 3))
                             .astype(np.uint8))
    cfg = _tcfg(CFG)

    def run(seed):
        return tda.device_augment(clips, torch.Generator().manual_seed(seed),
                                  cfg)

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (2, 3, 24, 24, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    boxes = torch.from_numpy(_boxes(rs, 2))
    f, h = tda.device_augment_image(clips[:, :1], boxes,
                                    torch.Generator().manual_seed(0), cfg)
    assert f.shape == (2, 1, 24, 24, 3) and h.shape == (2, 1, 4, 4)
    assert ((h >= 0) & (h <= 1)).all()
    assert (h[0, 0, 1] == 0).all() and (h[-1, 0, 3] == 0).all()


# ---------------------------------------------------------------------------
# The raw dataset modes
# ---------------------------------------------------------------------------

def _cfg(get, roots, **kw):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.SSV2.DATA_ROOT, cfg.DOH.DATA_ROOT = roots
    cfg.MODEL.NUM_CLASSES = 5
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.TPU.DEVICE_AUG = True
    cfg.TPU.RAW_SIZE = 48
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


@pytest.mark.parametrize("name", ["ssv2", "ssv2_frames"])
def test_raw_dataset_items_match_jax(roots, name):
    """Train items with ``TPU.DEVICE_AUG``: uint8 at ``RAW_SIZE`` (the
    boxes of ``ssv2_frames`` in its pixels, contact states matched before),
    equal to the JAX package's items; val stays on the host path."""
    ours = build_dataset(name, _cfg(get_cfg, roots), "train")
    ref = jax_build_dataset(name, _cfg(jax_get_cfg, roots), "train")
    assert len(ours) == len(ref) > 0
    for i in range(len(ours)):
        got, want = ours[i], ref[i]
        assert got[0].dtype == np.uint8 and got[0].shape[1:3] == (48, 48)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:3] == want[1:3]
        assert set(got[3]) == set(want[3])
        for k, v in got[3].items():
            if isinstance(v, np.ndarray):
                assert v.dtype == want[3][k].dtype
                np.testing.assert_array_equal(v, want[3][k])
            else:
                assert v == want[3][k]
    val = build_dataset(name, _cfg(get_cfg, roots), "val")[0][0]
    assert val.dtype == np.float32 and val.shape[1:3] == (32, 32)
