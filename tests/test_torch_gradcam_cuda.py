"""Grad-CAM (``svit_tpu_torch/visualization/gradcam.py``) on the card: its
backward through the hand-written kernels.

These need an NVIDIA card and ``nvcc``; without a card they skip.  Run them
there with ``python -m pytest --noconftest tests/test_torch_gradcam_cuda.py``.
The full 16-block schedule of ``configs/ssv2.yaml`` at 56 px and 4 frames,
bf16 through the kernels, random weights from the config's seed.  A call's
launches must equal ``chip_smoke.expected_gradcam_launches`` (one forward,
then K5, K2 bare and K6 through the blocks after the target), with no K7:
the pool filters want no gradient.  The map against the plain f32 model's
under ``chip_smoke.py``'s gate, all three runs on one label vector.
"""

import os
import sys

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
    sys.path.insert(0, REPO)
    return torch.device("cuda")


def _model(dtype=torch.bfloat16, kernels=True):
    from svit_tpu_torch.config import get_cfg
    from svit_tpu_torch.models import build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    return build_model(cfg, dtype=dtype, use_kernels=kernels, device="cuda")


def _clips():
    g = torch.Generator().manual_seed(0)
    return torch.randn(2, 4, 56, 56, 3, generator=g).cuda()


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-12))


@pytest.mark.parametrize("target", [0, 7])
def test_gradcam_launches(card, target):
    import chip_smoke
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.visualization.gradcam import GradCAM

    model, arch = _model()
    cam = GradCAM(model, target_layer=f"blocks_{target}_out")
    cam.layer_cam(_clips())            # builds the kernels
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    out = cam.layer_cam(_clips())
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    assert launches == dict(chip_smoke.expected_gradcam_launches(arch, target))
    assert torch.isfinite(out["cam"]).all() and out["grad"].abs().max() > 0


def test_gradcam_launches_no_k7(card):
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.visualization.gradcam import GradCAM

    model, _ = _model()
    _lib.reset_launch_counts()
    out = GradCAM(model, target_layer="blocks_0_out").layer_cam(_clips())
    torch.cuda.synchronize()
    assert _lib.LAUNCHES.get("pool_conv_dk", 0) == 0
    assert _lib.LAUNCHES["pool_conv_dx"] > 0
    assert _lib.LAUNCHES["pooled_attention_bwd"] > 0
    assert torch.isfinite(out["grad"]).all()


def test_gradcam_map_gate(card):
    from svit_tpu_torch.visualization.gradcam import GradCAM

    # one label vector for the three runs: each differentiates the same
    # class's score, whatever its own argmax
    labels = torch.randint(174, (2,),
                           generator=torch.Generator().manual_seed(1)).cuda()
    outs = {}
    for name, dtype, kernels in (("kernels", torch.bfloat16, True),
                                 ("plain_bf16", torch.bfloat16, False),
                                 ("plain_f32", torch.float32, False)):
        model, _ = _model(dtype, kernels)
        outs[name] = GradCAM(model, target_layer="blocks_7_out").layer_cam(
            _clips(), labels)
    for key in ("logits", "grad", "cam"):
        ref = outs["plain_f32"][key].float()
        err_k = _rel(outs["kernels"][key].float(), ref)
        err_p = _rel(outs["plain_bf16"][key].float(), ref)
        limit = 3 * err_p + 2e-3
        # the limit must fail an all-zero output, whose error is 1
        assert limit < 1, (key, err_p)
        assert err_k <= limit, (key, err_k, err_p)
