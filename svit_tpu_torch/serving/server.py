"""Batched inference server (counterpart of ``svit_tpu/serving/server.py``).

An HTTP endpoint with dynamic batching: requests that arrive within a short
window are padded into one fixed-shape batch and run as one forward under
``torch.inference_mode()`` on the card.  There the forward is one CUDA
graph (``engine/graphs.py``), as the JAX server jit-compiles one program
for its padded batch: the batch goes through a pinned host buffer into the
graph's static input, the graph replays, and its outputs are copied out.

API (stdlib http.server):

  POST /predict   {"frames": [<base64 JPEG> x T_any]}
      -> {"top_k": [{"class": int, "score": float}], "pred_bboxes": [...]}
  GET  /healthz   -> {"status": "ok", "model": ..., "batch": ...}
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List

import numpy as np
import torch

from svit_tpu_torch.data import transform
from svit_tpu_torch.engine import graphs
from svit_tpu_torch.models import build_model
from svit_tpu_torch.utils import checkpoint as cu
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

def load_checkpoint(model: torch.nn.Module, path: str, cfg) -> None:
    """Load a PyTorch checkpoint file into ``model`` (strict names); an
    Orbax directory raises (``utils/checkpoint.py:load_params_any``)."""
    cu.load_params_any(model, path, cfg)


class BatchedPredictor:
    """Collects requests into fixed-size batches for one forward."""

    def __init__(self, cfg, max_batch: int = 8, window_ms: float = 10.0,
                 device=None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.model, self.arch = build_model(cfg, device=device)
        self.device = next(self.model.parameters()).device
        ckpt = cu.load_test_checkpoint_path(cfg)
        if ckpt:
            load_checkpoint(self.model, ckpt, cfg)
        else:
            logger.warning("serving with RANDOM weights (no checkpoint found)")

        S, T = cfg.DATA.TEST_CROP_SIZE, cfg.DATA.NUM_FRAMES
        self.clip_shape = (T, S, S, 3)
        self.graph = graphs.CapturedStep(self._run)
        self.feed = graphs.PinnedFeed(self.graph, self.device)
        self.queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.worker = threading.Thread(target=self._loop, daemon=True)
        self.worker.start()

    def preprocess(self, frames: List[np.ndarray]) -> np.ndarray:
        cfg = self.cfg
        arr = np.stack(frames).astype(np.float32)
        arr = transform.tensor_normalize(arr, cfg.DATA.MEAN, cfg.DATA.STD)
        arr, _ = transform.short_side_scale(arr, cfg.DATA.TEST_CROP_SIZE)
        arr, _ = transform.uniform_crop(arr, cfg.DATA.TEST_CROP_SIZE, 1)
        idx = np.linspace(0, arr.shape[0] - 1, cfg.DATA.NUM_FRAMES).astype(int)
        return arr[idx]

    def _run(self, x):
        with torch.inference_mode():
            logits, extra = self.model(x)
            return logits.float(), extra["pred_bboxes"].float()

    @torch.inference_mode()
    def forward(self, clips: np.ndarray):
        """clips [B, T, S, S, 3] float32 -> (probabilities [B, C],
        pred_bboxes [B, T, O, 5]) as float32 numpy.  On the card, one
        graph per batch shape (the server's is ``max_batch``)."""
        logits, boxes = self.feed(clips)
        return logits.cpu().numpy(), boxes.cpu().numpy()

    def submit(self, clip: np.ndarray, timeout: float = 30.0):
        """Blocking: returns (logits [C], pred_bboxes [T, O, 5])."""
        done = threading.Event()
        slot = {}
        self.queue.put((clip, slot, done))
        if not done.wait(timeout):
            raise TimeoutError("inference timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["logits"], slot["boxes"]

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._run_batch(batch)

    def _run_batch(self, batch):
        try:
            clips = np.zeros((self.max_batch,) + self.clip_shape, np.float32)
            for i, (clip, _, _) in enumerate(batch):
                clips[i] = clip
            logits, boxes = self.forward(clips)
            for i, (_, slot, done) in enumerate(batch):
                slot["logits"] = logits[i]
                slot["boxes"] = boxes[i]
                done.set()
        except Exception as e:  # surface errors to all waiters
            logger.exception("batch failed")
            for _, slot, done in batch:
                slot["error"] = str(e)
                done.set()

    def stop(self, timeout: float = 10.0):
        """End the batching thread and wait for it."""
        self._stop.set()
        self.worker.join(timeout)


def make_handler(predictor: BatchedPredictor, top_k: int = 5):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model": predictor.cfg.MODEL.MODEL_NAME,
                    "batch": predictor.max_batch,
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                from PIL import Image

                frames = []
                for b64 in payload["frames"]:
                    raw = base64.b64decode(b64)
                    with Image.open(io.BytesIO(raw)) as im:
                        frames.append(np.asarray(im.convert("RGB")))
                if not frames:
                    raise ValueError("no frames")
                clip = predictor.preprocess(frames)
                logits, boxes = predictor.submit(clip)
                order = np.argsort(-logits)[:top_k]
                self._json(200, {
                    "top_k": [{"class": int(i), "score": float(logits[i])}
                              for i in order],
                    "pred_bboxes": boxes.tolist(),
                })
            except Exception as e:
                self._json(400, {"error": str(e)})

    return Handler


def make_server(cfg, host: str = "0.0.0.0", port: int = 8080,
                max_batch: int = 8, window_ms: float = 10.0, device=None):
    """The bound HTTP server (not yet serving); its predictor is
    ``httpd.predictor``.  Stop it with ``httpd.shutdown()`` and
    ``httpd.predictor.stop()``."""
    predictor = BatchedPredictor(cfg, max_batch=max_batch, window_ms=window_ms,
                                 device=device)
    httpd = ThreadingHTTPServer((host, port), make_handler(predictor))
    httpd.predictor = predictor
    return httpd


def serve(cfg, host: str = "0.0.0.0", port: int = 8080,
          max_batch: int = 8, window_ms: float = 10.0, device=None):
    httpd = make_server(cfg, host, port, max_batch, window_ms, device)
    logger.info("serving on %s:%d (batch %d, window %.0fms)",
                host, httpd.server_address[1], max_batch, window_ms)
    try:
        httpd.serve_forever()
    finally:
        httpd.predictor.stop()
        httpd.server_close()
    return httpd
