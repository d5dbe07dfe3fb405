"""The port's config tree and block schedule equal the JAX package's
(exact: pure Python on both sides)."""

import dataclasses
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSV2 = os.path.join(REPO, "configs", "ssv2.yaml")


def _cfgs(overrides=()):
    from svit_tpu.config import get_cfg as jget
    from svit_tpu_torch.config import get_cfg as tget

    out = []
    for get in (jget, tget):
        cfg = get()
        cfg.merge_from_file(SSV2)
        cfg.merge_from_list(list(overrides))
        out.append(cfg)
    return out


def test_config_tree_equals_jax_package():
    jc, tc = _cfgs()
    assert tc.to_dict() == jc.to_dict()


def test_config_override_and_typo():
    _, tc = _cfgs(["MVIT.DEPTH", "4", "DATA.TEST_CROP_SIZE", "56"])
    assert tc.MVIT.DEPTH == 4 and tc.DATA.TEST_CROP_SIZE == 56
    with pytest.raises(KeyError):
        tc.merge_from_list(["MVIT.DEPTHH", "4"])


@pytest.mark.parametrize("overrides", [
    (),
    ("DATA.TRAIN_CROP_SIZE", "56", "DATA.TEST_CROP_SIZE", "56",
     "DATA.NUM_FRAMES", "4"),
    ("TPU.REMAT", "True"),
])
def test_block_schedule_equals_jax(overrides):
    from svit_tpu.models.svit import SViTArch as JArch
    from svit_tpu_torch.models.svit import SViTArch as TArch

    jc, tc = _cfgs(overrides)
    ja, ta = JArch.from_cfg(jc), TArch.from_cfg(tc)
    assert len(ta.blocks) == 16
    for jb, tb in zip(ja.blocks, ta.blocks):
        assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    assert ta.remat == ("TPU.REMAT" in overrides)
