"""Every kernel call of the port's forward, train step and remat step gets a
launch plan at the shapes the JAX package's MViT schedules reach.

On the CPU the wrappers take their plain twins, so no other CPU test meets
the card's plans.  Here the model runs on the ``meta`` device (shapes, no
data): a wrapper sees a tensor that is not on the CPU, so it takes the
card's route (its plan, then ``_lib.launch``, recorded here instead of
launched).  A plan that refuses a shape raises its ValueError through the
model's own call.  The schedules:

- (a) ``configs/ssv2.yaml`` as shipped (head_dim 96);
- (b) each MViT schedule the JAX package's own tests build (EMBED_DIM 32:
  head_dim 32, C 32 to 128), its keys copied below with their file and
  line;
- (c) ``configs/ssv2.yaml`` with ``MVIT.NUM_HEADS 2`` (head_dim 48);
- (d) ``configs/ssv2.yaml`` with ``MVIT.EMBED_DIM 144 MVIT.NUM_HEADS 2``
  (MViTv2-L's widths: head_dim 72, C 144 to 1152, K1's LN prologue at K =
  1152 past the resident panel).

Each runs at batch 1 and 8, at 16 x 224 and at the schedule's own test size:
the serving forward, one train step (video, image and the consistency
forward, both directions) and the same step under ``TPU.REMAT``.  The launch
counts are the architecture's (``chip_smoke.expected_launches`` and
``expected_train_launches``).  Shapes past the card's rules (head_dim 136,
head_dim 12, kT + kH + kW past 256) still raise, each naming its rule.
"""

import collections
import dataclasses
import os
import sys

import pytest
import torch

from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.engine import steps
from svit_tpu_torch.models.losses import get_loss_func
from svit_tpu_torch.models.svit import SViT, SViTArch
from svit_tpu_torch.ops import _lib
from svit_tpu_torch.ops import attention as ta
from svit_tpu_torch.ops import ln_linear as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

META = torch.device("meta")

# the MViT keys of the JAX package's small schedules, copied (those tests
# build from ``get_cfg()``'s defaults)
_SMALL = {
    "MODEL.MODEL_NAME": "SViT", "MODEL.DROPOUT_RATE": 0.0,
    "DATA.NUM_FRAMES": 4, "MVIT.EMBED_DIM": 32,
    "MVIT.PATCH_PADDING": [1, 3, 3], "MVIT.POOL_KVQ_KERNEL": [3, 3, 3],
    "MVIT.REL_POS_SPATIAL": True, "MVIT.REL_POS_TEMPORAL": True,
    "MVIT.USE_ABS_POS": False, "MVIT.DROPPATH_RATE": 0.0,
}
_ENGINE = dict(_SMALL, **{
    "DATA.TRAIN_CROP_SIZE": 32, "DATA.TEST_CROP_SIZE": 32,
    "MVIT.DEPTH": 2, "MVIT.NUM_HEADS": 1, "MVIT.PATCH_KERNEL": [3, 7, 7],
    "MVIT.PATCH_STRIDE": [2, 4, 4], "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 2, 2],
    "MVIT.POOL_Q_STRIDE": [[0, 1, 1, 1], [1, 1, 2, 2]],
    "MVIT.DIM_MUL": [[1, 2.0]], "MVIT.HEAD_MUL": [[1, 2.0]],
    "MVIT.RESIDUAL_POOLING": True, "MVIT.DIM_MUL_IN_ATT": True})
SCHEDULES = {
    # (a)
    "ssv2": ("ssv2", {}),
    # (b) tests/test_pallas_attention.py:150-170
    "pallas_attention": (None, dict(_SMALL, **{
        "MODEL.NUM_CLASSES": 5, "DATA.TRAIN_CROP_SIZE": 32,
        "DATA.TEST_CROP_SIZE": 32, "MVIT.DEPTH": 2,
        "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 2, 2],
        "MVIT.POOL_Q_STRIDE": [[0, 1, 1, 1], [1, 1, 2, 2]],
        "MVIT.DIM_MUL": [[1, 2.0]], "MVIT.HEAD_MUL": [[1, 2.0]]})),
    # (b) tests/test_w8_carry.py:283-297
    "w8_carry": (None, dict(_SMALL, **{
        "MODEL.NUM_CLASSES": 5, "DATA.TRAIN_CROP_SIZE": 56,
        "DATA.TEST_CROP_SIZE": 56, "MVIT.DEPTH": 3,
        "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 4, 4],
        "MVIT.POOL_Q_STRIDE": [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 2, 2]],
        "MVIT.DIM_MUL": [[1, 2.0], [2, 2.0]],
        "MVIT.HEAD_MUL": [[1, 2.0], [2, 2.0]]})),
    # (b) tests/test_multitask.py:15-30 (its verb/noun heads are the
    # dataset's; the blocks are what the kernels see)
    "multitask": (None, dict(_SMALL, **{
        "DATA.TRAIN_CROP_SIZE": 32, "DATA.TEST_CROP_SIZE": 32,
        "MVIT.DEPTH": 2, "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 2, 2],
        "MVIT.POOL_Q_STRIDE": [[0, 1, 1, 1], [1, 1, 2, 2]]})),
    # (b) tests/test_train_engine.py:28-46, tests/test_tensor_parallel.py:
    # 31-48 (the same blocks) and tests/conftest.py's YAML that
    # tests/test_preemption.py:26-29 runs (the same, PATCH_* as strings)
    "train_engine": (None, _ENGINE),
    # (c)
    "heads2": ("ssv2", {"MVIT.NUM_HEADS": 2}),
    # (d)
    "mvitv2_l_widths": ("ssv2", {"MVIT.EMBED_DIM": 144,
                                 "MVIT.NUM_HEADS": 2}),
}


def make_cfg(name, frames=None, crop=None, **extra):
    base, keys = SCHEDULES[name]
    cfg = get_cfg()
    if base:
        cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    for key, value in dict(keys, **extra).items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, value)
    if frames:
        cfg.DATA.NUM_FRAMES = frames
    if crop:
        cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = crop
    return cfg


@pytest.fixture()
def card_route(monkeypatch):
    """The wrappers' card route with nothing launched: each launch is
    counted by its counter, and every K1 plan is kept."""
    launches = collections.Counter()
    k1_plans = []
    plan = tl.ln_linear_plan

    def k1_plan(*a, **k):
        p = plan(*a, **k)
        k1_plans.append(p)
        return p

    monkeypatch.setattr(_lib, "launch",
                        lambda name, counter, *a: launches.update([counter]))
    monkeypatch.setattr(_lib, "check", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "sm_count", lambda device: 132)
    monkeypatch.setattr(_lib, "stream", lambda: 0)
    monkeypatch.setattr(_lib, "ptr", lambda t: None if t is None else 0)
    monkeypatch.setattr(tl, "ln_linear_plan", k1_plan)
    return launches, k1_plans


def meta_model(cfg, remat=False):
    arch = SViTArch.from_cfg(cfg)
    if remat:
        arch = dataclasses.replace(arch, remat=True)
    with META:
        model = SViT(arch, dtype=torch.bfloat16, use_kernels=True)
    return model, arch


class _Tx:
    """The optimizer's place in the step: nothing to update on meta."""

    def set_step(self, step):
        pass

    def apply(self, params):
        return torch.zeros((), device=META)


def meta_train_step(cfg, model, B):
    """One train step (video B, image B and the consistency forward) on
    meta tensors, with the SViT video + image loss (the schedules of (b)
    train their blocks under other losses; the kernels see the same
    calls)."""
    cfg = cfg.clone()
    cfg.MODEL.LOSS_FUNC = "video_image_loss"
    model.train(True).requires_grad_(True)
    state = steps.create_train_state(model, _Tx())
    step = steps.make_train_step(
        model, get_loss_func(cfg), state.tx, video_weight=7 / 8,
        image_weight=1 / 8, with_image=True, with_consistency=True)
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_CROP_SIZE
    video = {"clips": torch.empty((B, T, S, S, 3), device=META),
             "labels": torch.zeros(B, dtype=torch.long, device=META),
             "weight": torch.ones(B, device=META)}
    image = {"frames": torch.empty((B, 1, S, S, 3), device=META),
             "haog_bboxes": torch.empty((B, 1, cfg.SVIT.O, 4), device=META),
             "contact_state": torch.zeros((B, 2), dtype=torch.long,
                                          device=META),
             "weight": torch.ones(B, device=META)}
    step(state, video, image, torch.Generator())


def _counts(launches):
    return {k: v for k, v in launches.items() if v}


def _head_width(arch):
    return {s.dim_out // s.num_heads for s in arch.blocks}


SIZES = {"16x224": (16, 224), "own": (None, None)}


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_every_kernel_call_has_a_plan(card_route, name, size):
    launches, k1_plans = card_route
    frames, crop = SIZES[size]
    cfg = make_cfg(name, frames, crop)
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    widths = _head_width(SViTArch.from_cfg(cfg))
    for B in (1, 8):
        model, arch = meta_model(cfg)
        launches.clear()
        with torch.no_grad():     # serving (and eval, test, Grad-CAM's)
            model.eval()(torch.empty((B, arch.num_frames, arch.crop_size,
                                      arch.crop_size, 3), device=META))
        assert _counts(launches) == dict(
            chip_smoke.expected_launches(arch)), (name, size, B)
        for remat, forwards in ((False, 3), (True, 5)):
            model, arch = meta_model(cfg, remat)
            launches.clear()
            meta_train_step(cfg, model, B)
            want = chip_smoke.expected_train_launches(arch, forwards)
            assert _counts(launches) == {k: v for k, v in want.items() if v}, \
                (name, size, B, remat)
    # K1's plans: the panel, the streaming GEMM and, past the panel's K,
    # the prologue pass
    kinds = {("pass" if p.rows_pass else "panel" if p.panel else "gemm")
             for p in k1_plans}
    assert {"panel", "gemm"} <= kinds
    if name == "mvitv2_l_widths":
        assert "pass" in kinds and launches["ln_linear_prologue"] > 0
        assert widths == {72}
    assert ("pass" in kinds) == (name == "mvitv2_l_widths")
    if name == "heads2":
        assert widths == {48}
    if SCHEDULES[name][0] is None:
        assert widths == {32}


@pytest.mark.parametrize("keys,rule", [
    ({"MVIT.EMBED_DIM": 136}, "head_dim up to 128"),
    ({"MVIT.NUM_HEADS": 8}, "head_dim a multiple of 8"),
    ({"MVIT.POOL_KV_STRIDE_ADAPTIVE": None,
      "MVIT.POOL_KV_STRIDE": [[0, 1, 1, 1]]}, "kT \\+ kH \\+ kW <= 256"),
])
def test_past_the_card_rules_a_call_raises(card_route, keys, rule):
    """head_dim 136 (the accumulators are registers), head_dim 12 (TMA's
    16-byte strides) and a key grid of kT + kH + kW = 264 (a block without
    k|v pooling at 512 px: K5's dbias rows are registers) raise through
    the model's call with the rule in the message."""
    crop = 512 if "MVIT.POOL_KV_STRIDE" in keys else 224
    cfg = make_cfg("ssv2", 16, crop, **keys)
    model, arch = meta_model(cfg)
    with pytest.raises(ValueError, match=rule):
        with torch.no_grad():
            model.eval()(torch.empty((1, 16, crop, crop, 3), device=META))


def test_plans_name_the_rule():
    """The plans themselves: head_dim 136 and 12, and R = 257."""
    with pytest.raises(ValueError, match="head_dim up to 128"):
        ta.attention_plan(1, 64, 64, 136, 1, 0)
    with pytest.raises(ValueError, match="head_dim a multiple of 8"):
        ta.attention_plan(1, 64, 64, 24, 2, 0)
    with pytest.raises(ValueError, match="kT \\+ kH \\+ kW <= 256"):
        ta.attention_plan(1, 64, 300, 96, 1, 257)
    assert ta.attention_plan(1, 64, 300, 96, 1, 256).rk == ta.RK_CHUNKED
