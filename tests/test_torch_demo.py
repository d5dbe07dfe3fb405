"""The port's demo against the JAX package's, and the umbrella CLI.

- ``demo(cfg, device="cpu")`` on a frame directory: the JAX demo's clip
  count and file count (each clip writes its whole buffer; the JAX demo
  runs with fixed predictions);
- the drawing (``VideoVisualizer.draw_clip``, ``draw_haog_boxes``,
  ``draw_clip_haog``) bit-equal to the JAX package's for injected
  predictions and boxes;
- ``frame_source``: the JAX package's frames from a directory and from an
  mp4, and the webcam wiring with a stand-in camera;
- the ``Predictor`` bit-equal to the eager forward on the same clip;
- ``python -m svit_tpu_torch.tools.run_net`` reaching test, visualize and
  demo in that order (on the CPU, a tiny model).
"""

import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

from svit_tpu.config import assert_and_infer_cfg as jax_infer
from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.visualization import demo as jax_demo
from svit_tpu.visualization import draw as jax_draw
from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg
from svit_tpu_torch.native import video
from svit_tpu_torch.visualization import demo, draw
from tests.fixtures import make_ssv2_fixture
from tests.test_torch_trainer import _tiny_cfg

NUM_FRAMES = 20


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one thread here: beside JAX's thread pool and the suite's
    other workers, torch's eight spinning threads slow small ops a
    hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo_frames")
    rs = np.random.RandomState(0)
    for i in range(NUM_FRAMES):
        Image.fromarray(rs.randint(0, 256, (64, 80, 3), np.uint8)).save(
            str(root / f"{i:04d}.jpg"))
    return str(root)


@pytest.fixture(scope="module")
def ssv2_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ssv2"))
    make_ssv2_fixture(root)
    return root


def _cfgs(root, out, **kw):
    return (_tiny_cfg(get_cfg, assert_and_infer_cfg, root, out, **kw),
            _tiny_cfg(jax_get_cfg, jax_infer, root, out, **kw))


class _FixedPredictor:
    """The JAX demo's ``Predictor`` with fixed outputs: its counts do not
    depend on the model, and the JAX model's eager init takes most of a
    minute on the CPU."""

    def __init__(self, cfg):
        self.T = cfg.DATA.NUM_FRAMES

    def __call__(self, frames):
        return np.full(5, 0.2, np.float32), np.zeros((self.T, 4, 5),
                                                      np.float32)


def test_demo_counts_equal_jax(ssv2_root, frames_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_demo, "Predictor", _FixedPredictor)
    outs = {}
    for name, cfg, run in zip(
            ("port", "jax"), _cfgs(ssv2_root, str(tmp_path)),
            (lambda c: demo.demo(c, device="cpu"), jax_demo.demo)):
        cfg.DEMO.ENABLE = True
        cfg.DEMO.INPUT_VIDEO = frames_dir
        cfg.DEMO.OUTPUT_FILE = str(tmp_path / name)
        cfg.DATA.SAMPLING_RATE = 2
        n = run(cfg)
        outs[name] = (n, len(glob.glob(str(tmp_path / name / "*.jpg"))))
    seq, keep = 4 * 2, 4
    clips = 1 + (NUM_FRAMES - seq) // (seq - keep)
    assert outs["port"] == outs["jax"] == (clips, clips * seq)


def test_demo_writes_a_video_through_the_libav_shim(ssv2_root, frames_dir,
                                                   tmp_path, monkeypatch):
    """With cv2 hidden the encoded output goes through ``VideoEncoder``."""
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    cfg, _ = _cfgs(ssv2_root, str(tmp_path))
    cfg.DEMO.INPUT_VIDEO = frames_dir
    cfg.DEMO.OUTPUT_FILE = str(tmp_path / "out.mp4")
    cfg.DATA.SAMPLING_RATE = 2
    timings = {}
    n = demo.demo(cfg, device="cpu", timings=timings)
    monkeypatch.setattr(builtins, "__import__", real_import)
    assert video.probe(cfg.DEMO.OUTPUT_FILE)[1] == n * 8
    assert set(timings) == {"preprocess_s", "forward_s", "draw_s",
                            "write_s", "loop_s", "wall_s"}


def test_drawing_bit_equal_to_jax():
    rs = np.random.RandomState(3)
    frames = [rs.randint(0, 256, (60, 90, 3), np.uint8) for _ in range(3)]
    preds = rs.rand(7)
    names = [f"class {i}" for i in range(5)]
    for kw in ({}, {"mode": "top-k", "top_k": 4},
               {"common_class_names": ["class 2"], "thres": 0.5}):
        got = demo.VideoVisualizer(names, **kw).draw_clip(frames, preds)
        want = jax_demo.VideoVisualizer(names, **kw).draw_clip(frames, preds)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    boxes = np.concatenate([rs.rand(3, 4, 1), 0.2 + 0.5 * rs.rand(3, 4, 4)],
                           axis=-1).astype(np.float32)
    got = draw.draw_clip_haog(np.stack(frames), boxes, 0.3)
    want = jax_draw.draw_clip_haog(np.stack(frames), boxes, 0.3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        draw.draw_haog_boxes(frames[0], boxes[0, :, 1:]),
        jax_draw.draw_haog_boxes(frames[0], boxes[0, :, 1:]))


def test_frame_source_equals_jax(frames_dir, tmp_path):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for source in (frames_dir, str(tmp_path / "src.mp4")):
        if source.endswith(".mp4"):
            with video.VideoEncoder(source, 80, 64, 25) as enc:
                for f in demo.frame_source(cfg):
                    enc.write(f)
        cfg.DEMO.INPUT_VIDEO = jcfg.DEMO.INPUT_VIDEO = source
        info, jinfo = {}, {}
        got = list(demo.frame_source(cfg, info))
        want = list(jax_demo.frame_source(jcfg, jinfo))
        # both shims decode one frame fewer than VideoEncoder wrote (the
        # container counts all of them): a property the port keeps
        n = NUM_FRAMES - source.endswith(".mp4")
        assert len(got) == len(want) == n and info == jinfo
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_video_source_without_a_decoder_raises(monkeypatch, tmp_path):
    from svit_tpu_torch.native import _shim

    monkeypatch.setattr(video, "SHIM",
                        _shim.Shim("libsvit_absent.so", lambda lib: None))
    monkeypatch.setitem(__import__("sys").modules, "av", None)
    cfg = get_cfg()
    cfg.DEMO.INPUT_VIDEO = str(tmp_path / "clip.mp4")
    open(cfg.DEMO.INPUT_VIDEO, "wb").close()
    with pytest.raises(RuntimeError, match="libsvit_absent.so"):
        list(demo.frame_source(cfg))


def test_webcam_wiring(monkeypatch):
    frames = [np.full((8, 8, 3), i, np.uint8) for i in range(5)]

    class FakeCam:
        def __init__(self, index, width=0, height=0):
            assert index == 0

        def __iter__(self):
            return iter(frames)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr("svit_tpu_torch.native.camera.CameraSource", FakeCam)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    monkeypatch.setenv("SVIT_DEMO_MAX_FRAMES", "3")
    cfg = get_cfg()
    cfg.DEMO.WEBCAM = 0
    got = list(demo.frame_source(cfg))
    assert len(got) == 3
    np.testing.assert_array_equal(got[1], frames[1])


def test_predictor_equals_eager_forward(ssv2_root, frames_dir, tmp_path):
    cfg, _ = _cfgs(ssv2_root, str(tmp_path))
    pred = demo.Predictor(cfg, device="cpu")
    cfg.DEMO.INPUT_VIDEO = frames_dir
    buf = list(demo.frame_source(cfg))[:8]
    preds, boxes = pred(buf)
    with torch.inference_mode():
        logits, extra = pred.model(torch.from_numpy(pred.preprocess(buf)))
    np.testing.assert_array_equal(preds, logits.float().numpy()[0])
    np.testing.assert_array_equal(boxes,
                                  extra["pred_bboxes"].float().numpy()[0])
    assert pred.times["forward_s"] > 0


def test_run_net_dispatch_order(ssv2_root, frames_dir, tmp_path,
                                monkeypatch):
    """test, then visualize, then demo, each run for real on the CPU."""
    from svit_tpu_torch.engine import test as test_mod
    from svit_tpu_torch.tools import run_net
    from svit_tpu_torch.visualization import run as run_mod

    order = []
    for mod, name in ((test_mod, "test"), (run_mod, "visualize"),
                      (demo, "demo")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda cfg, device=None, _f=fn,
                            _n=name: (order.append((_n, device)),
                                      _f(cfg, device=device))[1])
    cfg, _ = _cfgs(ssv2_root, str(tmp_path))
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        f.write(cfg.dump())
    run_net.main(["--cfg", path, "TRAIN.ENABLE", "False", "TEST.ENABLE",
                  "True", "TENSORBOARD.ENABLE", "True",
                  "TENSORBOARD.MODEL_VIS.ENABLE", "True",
                  "TENSORBOARD.MODEL_VIS.ACTIVATIONS", "True",
                  "TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST",
                  "['blocks_0_out']", "DEMO.ENABLE", "True",
                  "DEMO.INPUT_VIDEO", frames_dir,
                  "TEST.NUM_ENSEMBLE_VIEWS", "1",
                  "TEST.NUM_SPATIAL_CROPS", "1"],
                 device="cpu")
    assert order == [("test", "cpu"), ("visualize", "cpu"), ("demo", "cpu")]
    assert glob.glob(str(tmp_path / "runs-*" / "events.*"))
    assert len(glob.glob(str(tmp_path / "demo_out" / "*.jpg"))) > 0
