"""Inference demo (counterpart of ``svit_tpu/visualization/demo.py``,
reference ``tools/demo_net.py`` and ``slowfast/visualization/{predictor,
async_predictor,demo_loader,video_visualizer}.py``).

Input is a directory of frames, a video file (the libav shim, else PyAV)
or, with ``DEMO.WEBCAM``, a camera (cv2, else the V4L2 shim).  Each buffer
of ``NUM_FRAMES x SAMPLING_RATE`` frames is one clip through the
``Predictor`` (on the card the batch-1 forward is a CUDA graph, as the JAX
demo jit-compiles it); its frames are drawn with the HAOG boxes and the
top-k classes (PIL) and written by a thread: an encoded video (cv2, else
the libav shim's ``VideoEncoder``) when ``DEMO.OUTPUT_FILE`` names one,
else JPEG frames.  Like the JAX demo, every clip writes all of its buffer's
frames (the reference writes only the frames new to the clip).

    python -m svit_tpu_torch.tools.demo_net --cfg configs/ssv2.yaml \\
        DEMO.ENABLE True DEMO.INPUT_VIDEO <frames dir or video file>
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from typing import Iterator, List

import numpy as np
import torch
from PIL import Image, ImageDraw

from svit_tpu_torch.data import transform
from svit_tpu_torch.engine import graphs
from svit_tpu_torch.models import build_model
from svit_tpu_torch.utils import checkpoint as cu
from svit_tpu_torch.utils import logging
from svit_tpu_torch.visualization.draw import draw_haog_boxes

logger = logging.get_logger(__name__)


def load_labels(path: str) -> List[str]:
    import json

    if not path:
        return []
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        out = [None] * len(data)
        for name, idx in data.items():
            out[int(idx)] = name
        return out
    return list(data)


def _webcam_source(cfg, src_info=None) -> Iterator[np.ndarray]:
    """RGB frames from camera ``DEMO.WEBCAM`` (reference
    ``demo_loader.py:28-47``): cv2 where it opens the device, else the V4L2
    shim (``native/camera.py``), which raises when it cannot be built.
    Streams until the device stalls or ``SVIT_DEMO_MAX_FRAMES`` frames
    (0: no limit)."""
    index = cfg.DEMO.WEBCAM
    limit = int(os.environ.get("SVIT_DEMO_MAX_FRAMES", "0"))
    cap = None
    try:
        # a cv2 that imports but cannot capture (a headless build) leaves
        # the camera to the V4L2 shim, as the reference tolerates absent
        # capture backends
        import cv2

        cap = cv2.VideoCapture(index)
        if not cap.isOpened():
            cap.release()
            cap = None
        else:
            if cfg.DEMO.DISPLAY_WIDTH > 0 and cfg.DEMO.DISPLAY_HEIGHT > 0:
                cap.set(cv2.CAP_PROP_FRAME_WIDTH, cfg.DEMO.DISPLAY_WIDTH)
                cap.set(cv2.CAP_PROP_FRAME_HEIGHT, cfg.DEMO.DISPLAY_HEIGHT)
            if src_info is not None:
                fps = float(cap.get(cv2.CAP_PROP_FPS) or 0)
                if fps > 0:
                    src_info["fps"] = fps
    except Exception:
        cap = None
    if cap is not None:
        n = 0
        try:
            while limit <= 0 or n < limit:
                ok, frame = cap.read()
                if not ok:
                    return
                yield frame[..., ::-1]  # BGR -> RGB
                n += 1
        finally:
            cap.release()
        return
    from svit_tpu_torch.native import camera

    with camera.CameraSource(index, cfg.DEMO.DISPLAY_WIDTH,
                             cfg.DEMO.DISPLAY_HEIGHT) as cam:
        n = 0
        for frame in cam:
            yield frame
            n += 1
            if limit > 0 and n >= limit:
                return


def frame_source(cfg, src_info=None) -> Iterator[np.ndarray]:
    """RGB uint8 frames from ``DEMO.INPUT_VIDEO`` (a frame directory or a
    video file) or, when it is unset and ``DEMO.WEBCAM >= 0``, the camera.
    A video file needs the libav shim or PyAV: without either it raises
    with the shim's build error.

    ``src_info``, when a dict, receives ``fps`` once the source's frame
    rate is known (``DEMO.OUTPUT_FPS == -1`` writes at that rate)."""
    src = cfg.DEMO.INPUT_VIDEO
    if not src and cfg.DEMO.WEBCAM >= 0:
        yield from _webcam_source(cfg, src_info)
        return
    assert src, "set DEMO.INPUT_VIDEO (file / frame dir) or DEMO.WEBCAM"
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    if os.path.isdir(src):
        names = sorted(n for n in os.listdir(src)
                       if n.lower().endswith((".jpg", ".png", ".jpeg")))
        for n in names:
            with Image.open(os.path.join(src, n)) as im:
                yield np.asarray(im.convert("RGB"))
        return
    from svit_tpu_torch.native import video as nv

    if nv.available():
        if src_info is not None:
            meta = nv.probe(src)
            if meta and meta[0] > 0:
                src_info["fps"] = meta[0]
        res = nv.decode_window(src)
        if res is None:
            raise RuntimeError(f"failed to decode {src}")
        yield from res[0]
        return
    try:
        import av
    except ImportError as e:
        raise RuntimeError(
            f"cannot decode {src}: the libav shim is missing "
            f"({nv.SHIM.error}) and PyAV is not installed") from e
    with av.open(src) as container:
        stream = container.streams.video[0]
        if src_info is not None and stream.average_rate:
            src_info["fps"] = float(stream.average_rate)
        for frame in container.decode(video=0):
            yield frame.to_rgb().to_ndarray()


class VideoVisualizer:
    """Top-k prediction overlay (PIL), reference ``video_visualizer.py:45``."""

    def __init__(self, class_names: List[str], top_k: int = 3,
                 thres: float = 0.7, lower_thres: float = 0.3,
                 common_class_names=None, mode: str = "thres"):
        self.class_names = class_names
        self.top_k = top_k
        self.thres = thres
        self.lower_thres = lower_thres
        self.common = set(common_class_names or [])
        self.mode = mode

    def draw_clip(self, frames: List[np.ndarray], preds: np.ndarray):
        order = np.argsort(-preds)[: self.top_k]
        lines = []
        for idx in order:
            score = float(preds[idx])
            name = (self.class_names[idx] if idx < len(self.class_names)
                    else f"class {idx}")
            if self.mode == "thres":
                thres = self.lower_thres if name in self.common else self.thres
                if score < thres:
                    continue
            lines.append(f"{name}: {score:.2f}")
        out = []
        for f in frames:
            img = Image.fromarray(f)
            draw = ImageDraw.Draw(img)
            y = 4
            for line in lines:
                bbox = draw.textbbox((4, y), line)
                draw.rectangle(bbox, fill=(0, 0, 0))
                draw.text((4, y), line, fill=(255, 255, 255))
                y = bbox[3] + 2
            out.append(np.asarray(img))
        return out


class Predictor:
    """Sliding-clip model runner (reference ``predictor.py:20-116``): the
    weights of ``load_test_checkpoint_path``, else the seeded random ones.
    On the card the batch-1 forward is a CUDA graph fed through a pinned
    buffer (``graphs.PinnedFeed``, as the server feeds its batches).
    ``times`` sums the seconds of host preprocessing and of the forward
    (the copy in, the replay, the copy out)."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.model, self.arch = build_model(cfg, device=device)
        self.device = next(self.model.parameters()).device
        ckpt = cu.load_test_checkpoint_path(cfg)
        if ckpt:
            cu.load_params_any(self.model, ckpt, cfg)
        self.graph = graphs.CapturedStep(self._run)
        self.feed = graphs.PinnedFeed(self.graph, self.device)
        self.times = collections.Counter()

    def _run(self, x):
        with torch.inference_mode():
            logits, extra = self.model(x)
            return logits.float(), extra["pred_bboxes"].float()

    def preprocess(self, frames: List[np.ndarray]) -> np.ndarray:
        """The clip [1, T, S, S, 3] of a buffer: normalized, short side
        scaled, centre-cropped, ``NUM_FRAMES`` frames sampled evenly."""
        cfg = self.cfg
        arr = np.stack(frames).astype(np.float32)
        arr = transform.tensor_normalize(arr, cfg.DATA.MEAN, cfg.DATA.STD)
        arr, _ = transform.short_side_scale(arr, cfg.DATA.TEST_CROP_SIZE)
        arr, _ = transform.uniform_crop(arr, cfg.DATA.TEST_CROP_SIZE, 1)
        idx = np.linspace(0, arr.shape[0] - 1, cfg.DATA.NUM_FRAMES).astype(int)
        return np.ascontiguousarray(arr[idx][None])

    @torch.inference_mode()
    def __call__(self, frames: List[np.ndarray]):
        """(class scores [C], pred_bboxes [T, O, 5]) of one buffer."""
        t0 = time.perf_counter()
        clip = self.preprocess(frames)
        t1 = time.perf_counter()
        logits, boxes = self.feed(clip)
        preds, pred_bboxes = logits.cpu().numpy()[0], boxes.cpu().numpy()[0]
        self.times["preprocess_s"] += t1 - t0
        self.times["forward_s"] += time.perf_counter() - t1
        return preds, pred_bboxes


def _video_backend(out_path: str):
    """The encoder of an encoded output: cv2 where its writer works, else
    the libav shim's; None (write JPEG frames) without either."""
    try:
        import cv2

        if callable(getattr(cv2, "VideoWriter", None)) and callable(
                getattr(cv2, "VideoWriter_fourcc", None)):
            cv2.VideoWriter_fourcc(*"mp4v")  # a stub that imports must work
            return "cv2"
    except Exception:
        pass
    from svit_tpu_torch.native import video as nv

    if nv.encoder_available():
        return "native"
    logger.warning("no video encoder (cv2 absent, the libav shim: %s); "
                   "writing frames to %s instead", nv.SHIM.error, out_path)
    return None


def demo(cfg, device=None, timings=None):
    """Run the demo of ``cfg`` on the card (``device`` elsewhere); returns
    the number of clips.  ``timings``, when a dict, receives the seconds of
    preprocessing, the forward, drawing and the writer thread, of the loop
    over the frames (until the last frame is written) and of the whole
    call."""
    logging.setup_logging(cfg.OUTPUT_DIR)
    t_start = time.perf_counter()
    predictor = Predictor(cfg, device=device)
    class_names = load_labels(cfg.DEMO.LABEL_FILE_PATH)
    vis = VideoVisualizer(
        class_names,
        top_k=cfg.TENSORBOARD.MODEL_VIS.TOPK_PREDS,
        thres=cfg.DEMO.COMMON_CLASS_THRES,
        lower_thres=cfg.DEMO.UNCOMMON_CLASS_THRES,
        common_class_names=cfg.DEMO.COMMON_CLASS_NAMES,
        mode=cfg.DEMO.VIS_MODE,
    )

    seq_len = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
    keep = seq_len // 2 if cfg.DEMO.BUFFER_SIZE == 0 else cfg.DEMO.BUFFER_SIZE
    out_frames: "queue.Queue" = queue.Queue()
    src_info: dict = {}
    writer_state = {"error": None, "write_s": 0.0}

    out_path = cfg.DEMO.OUTPUT_FILE or os.path.join(cfg.OUTPUT_DIR, "demo_out")
    as_video = out_path.lower().endswith((".mp4", ".avi", ".mkv", ".mov",
                                          ".webm"))
    # the encoder is picked here, before the writer starts
    backend = _video_backend(out_path) if as_video else None
    as_video = backend is not None

    def output_fps() -> float:
        # reference demo_loader: OUTPUT_FPS == -1 writes at the source rate
        if cfg.DEMO.OUTPUT_FPS > 0:
            return float(cfg.DEMO.OUTPUT_FPS)
        return float(src_info.get("fps") or 30)

    def open_writer(h, w):
        if backend == "cv2":
            import cv2

            vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 output_fps(), (w, h))
            return (lambda f: vw.write(np.ascontiguousarray(f[..., ::-1]))), \
                vw.release
        from svit_tpu_torch.native import video as nv

        enc = nv.VideoEncoder(out_path, w, h, output_fps())
        return enc.write, enc.close

    def writer_thread():
        write = close = None
        i, done = 0, False
        try:
            if not as_video:
                os.makedirs(out_path, exist_ok=True)
            while True:
                item = out_frames.get()
                if item is None:
                    done = True
                    break
                t0 = time.perf_counter()
                if not as_video:
                    Image.fromarray(item).save(
                        os.path.join(out_path, f"{i:06d}.jpg"))
                else:
                    if write is None:
                        write, close = open_writer(*item.shape[:2])
                    write(item)
                i += 1
                writer_state["write_s"] += time.perf_counter() - t0
            if close is not None:
                close()
        except Exception as e:   # raised again by the main thread
            writer_state["error"] = e
            while not done and out_frames.get() is not None:
                pass    # drain, so that the producer finishes

    thread = threading.Thread(target=writer_thread, daemon=True)
    thread.start()

    n_clips, draw_s = 0, 0.0
    buffer: List[np.ndarray] = []
    t_loop = time.perf_counter()
    try:
        for frame in frame_source(cfg, src_info):
            buffer.append(frame)
            if len(buffer) == seq_len:
                preds, pred_bboxes = predictor(buffer)
                t0 = time.perf_counter()
                # the HAOG boxes of the nearest model frame
                T = pred_bboxes.shape[0]
                drawn = []
                for fi, f in enumerate(buffer):
                    t = min(T - 1, fi * T // len(buffer))
                    drawn.append(draw_haog_boxes(
                        f, pred_bboxes[t, :, 1:], pred_bboxes[t, :, 0]))
                for f in vis.draw_clip(drawn, preds):
                    out_frames.put(f)
                draw_s += time.perf_counter() - t0
                n_clips += 1
                buffer = buffer[-keep:]
    finally:
        out_frames.put(None)
        thread.join()
    if writer_state["error"] is not None:
        raise RuntimeError("the demo's writer failed") from \
            writer_state["error"]
    end = time.perf_counter()
    wall = end - t_start
    if timings is not None:
        timings.update(predictor.times, draw_s=draw_s,
                       write_s=writer_state["write_s"], loop_s=end - t_loop,
                       wall_s=wall)
    logger.info("Demo done: %d clips -> %s (%.1f s)", n_clips, out_path, wall)
    return n_clips
