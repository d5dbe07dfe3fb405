"""The port's camera shim, TensorBoard writer and checkpoint conversion
against the JAX package's.

- ``yuyv_to_rgb`` equal to the JAX shim's; a missing device raises (no
  camera exists here, so capture itself is not exercised).  The JAX
  shim checks for its ``.so`` outside its build lock while ``make`` writes
  the file in place, so under xdist a worker can load a sibling's
  half-written build, fail, and remember the failure for the rest of the
  process (``svit_tpu/native/camera.py:_load``).  ``jax_camera_lib`` waits
  out any build under that lock and loads again;
- ``TensorboardWriter`` writes event files; ``confusion_matrix`` equals
  the JAX package's;
- a synthetic reference state dict (fused or separate q, k and v, BGR
  input) converts to the tensors of JAX ``flip_input_channels`` +
  ``torch_to_flax`` + the port's ``params_from_jax``, and back to the
  reference's bit for bit, through the functions and the CLI.
"""

import fcntl
import glob
import os

import numpy as np
import pytest
import torch

from svit_tpu.native import camera as jax_camera
from svit_tpu.utils import converter as jax_converter
from svit_tpu.visualization import tensorboard_vis as jax_tb
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models import build_model
from svit_tpu_torch.native import camera
from svit_tpu_torch.utils import converter
from svit_tpu_torch.visualization import tensorboard_vis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_camera_lib():
    """The JAX camera shim, loaded after any build of it has finished: its
    build lock is taken (a sibling worker's ``make`` holds it while it
    writes ``libsvit_camera.so``) and released, then a load that failed on
    a half-written file is tried again."""
    lock = os.path.join(os.path.dirname(jax_camera.__file__), ".build.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
    if jax_camera._lib is None:
        jax_camera._tried = False
    assert jax_camera.available(), (
        "svit_tpu/native/libsvit_camera.so did not build or load")


@pytest.mark.parametrize("w,h,seed", [(64, 32, 0), (4, 2, 1), (320, 240, 2)])
def test_yuyv_to_rgb_equals_jax(jax_camera_lib, w, h, seed):
    yuyv = np.random.RandomState(seed).randint(0, 256, h * w * 2,
                                               dtype=np.uint8)
    got = camera.yuyv_to_rgb(yuyv, w, h)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_camera.yuyv_to_rgb(yuyv, w, h))


def test_missing_camera_raises():
    with pytest.raises(RuntimeError, match="video997"):
        camera.CameraSource(997)


def test_tensorboard_writer(tmp_path):
    cfg = get_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE = True
    w = tensorboard_vis.TensorboardWriter(cfg)
    w.add_scalars({"train/loss": 1.0, "train/lr": 0.1}, global_step=0)
    preds = np.eye(5)[np.array([0, 1, 2, 3, 4])]
    w.add_confusion_matrix(preds, np.array([0, 1, 2, 2, 4]), num_classes=5)
    w.add_video(np.zeros((1, 2, 8, 8, 3), np.uint8))
    w.plot_weights_and_activations(
        {"a": torch.ones(3), "b": {"c": torch.zeros(2, 2, dtype=torch.bfloat16)}},
        tag="t/")
    w.close()
    assert glob.glob(os.path.join(str(tmp_path), "runs-*", "events.*"))


def test_confusion_matrix_equals_jax():
    rs = np.random.RandomState(0)
    preds, labels = rs.rand(40, 7), rs.randint(0, 7, 40)
    got = tensorboard_vis.confusion_matrix(preds, labels, 7)
    np.testing.assert_array_equal(
        got, jax_tb.confusion_matrix(preds, labels, 7))
    assert got.sum() == 40


def _tiny_cfg(separate_qkv=False):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.EMBED_DIM = 32
    cfg.MVIT.NUM_HEADS = 1
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.SEPARATE_QKV = separate_qkv
    return cfg


@pytest.fixture(scope="module")
def reference_state():
    """A reference-layout state dict (fused q, k and v) of a tiny model."""
    model, _ = build_model(_tiny_cfg(), device="cpu")
    return {k: v.clone() for k, v in model.state_dict().items()}


def _separate(state):
    return {k: torch.from_numpy(v) for k, v in jax_converter.flax_to_torch(
        jax_converter.torch_to_flax({k: v.numpy() for k, v in state.items()},
                                    separate_qkv=True)).items()}


@pytest.mark.parametrize("source", ["fused", "separate"])
@pytest.mark.parametrize("separate_qkv", [False, True])
@pytest.mark.parametrize("order", ["bgr", "rgb"])
def test_reference_to_port_equals_jax(reference_state, source, separate_qkv,
                                      order):
    ref = reference_state if source == "fused" else _separate(
        reference_state)
    got = converter.reference_to_port(ref, separate_qkv, order)
    if source == "separate" and not separate_qkv:
        # JAX torch_to_flax loads no fused qkv from separate keys: the
        # port joins them, which is the fused source's conversion
        ref_np = {k: v.numpy() for k, v in reference_state.items()}
    else:
        ref_np = {k: v.numpy() for k, v in ref.items()}
    if order == "bgr":
        ref_np = jax_converter.flip_input_channels(ref_np)
    want = converter.params_from_jax(
        jax_converter.torch_to_flax(ref_np, separate_qkv=separate_qkv))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    back = converter.port_to_reference(got, source == "separate", order)
    assert sorted(back) == sorted(ref)
    for k in ref:
        assert torch.equal(back[k], ref[k]), k


def test_convert_checkpoint_cli_round_trip(reference_state, tmp_path):
    from svit_tpu_torch.tools import convert_checkpoint
    from svit_tpu_torch.utils import checkpoint as cu

    src, port, back = (str(tmp_path / n) for n in
                       ("ref.pyth", "port.pyth", "back.pyth"))
    torch.save({"model_state": reference_state}, src)
    convert_checkpoint.main(["--input", src, "--output", port,
                             "--separate-qkv"])
    cfg = _tiny_cfg(separate_qkv=True)
    model, _ = build_model(cfg, device="cpu")
    cu.load_params_any(model, port, cfg)    # strict names
    w = reference_state["patch_embed.proj.weight"]
    assert torch.equal(model.patch_embed.proj.weight, w.flip(1))
    convert_checkpoint.main(["--to-reference", "--input", port, "--output",
                             back])
    restored = converter.load_torch_state(back)
    assert sorted(restored) == sorted(reference_state)
    for k, v in reference_state.items():
        assert torch.equal(restored[k], v), k
