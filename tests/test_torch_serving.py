"""The port's serving stack on the CPU (``device="cpu"``): preprocessing,
dynamic batching, checkpoint loading and the HTTP handler."""

import base64
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from svit_tpu.data import transform as jax_transform
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models import build_model
from svit_tpu_torch.serving.server import (BatchedPredictor, load_checkpoint,
                                           make_server)


def _cfg():
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "SViT"
    cfg.MODEL.NUM_CLASSES = 5
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.EMBED_DIM = 32
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.REL_POS_SPATIAL = True
    cfg.MVIT.REL_POS_TEMPORAL = True
    cfg.MVIT.USE_ABS_POS = False
    cfg.TRAIN.MIXED_PRECISION = False
    return cfg


def _frames(seed, n=6, shape=(48, 64, 3)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 255, shape, dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def predictor():
    p = BatchedPredictor(_cfg(), max_batch=4, window_ms=100, device="cpu")
    yield p
    p.stop()


def test_preprocess_equals_jax_transforms(predictor):
    cfg = predictor.cfg
    frames = _frames(0)
    arr = np.stack(frames).astype(np.float32)
    arr = jax_transform.tensor_normalize(arr, cfg.DATA.MEAN, cfg.DATA.STD)
    arr, _ = jax_transform.short_side_scale(arr, cfg.DATA.TEST_CROP_SIZE)
    arr, _ = jax_transform.uniform_crop(arr, cfg.DATA.TEST_CROP_SIZE, 1)
    idx = np.linspace(0, arr.shape[0] - 1, cfg.DATA.NUM_FRAMES).astype(int)
    np.testing.assert_array_equal(predictor.preprocess(frames), arr[idx])


def test_concurrent_submits_equal_direct_forward(predictor):
    clips = [predictor.preprocess(_frames(i)) for i in range(3)]
    results = [None] * 3

    def call(i):
        results[i] = predictor.submit(clips[i], timeout=120)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    with torch.inference_mode():
        logits, extra = predictor.model(torch.from_numpy(np.stack(clips)))
    for i, (lg, boxes) in enumerate(results):
        np.testing.assert_allclose(lg, logits[i].numpy(), atol=1e-5)
        np.testing.assert_allclose(boxes, extra["pred_bboxes"][i].numpy(),
                                   atol=1e-5)


def test_load_checkpoint_strict_and_orbax_refused(predictor, tmp_path):
    state = {k: v.clone() + 1.0 for k, v in predictor.model.state_dict().items()}
    path = str(tmp_path / "ckpt.pyth")
    torch.save({"model_state": {"module." + k: v for k, v in state.items()}},
               path)
    model, _ = build_model(_cfg(), device="cpu")
    load_checkpoint(model, path, _cfg())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, state[k])
    with pytest.raises(ValueError, match="Orbax"):
        load_checkpoint(model, str(tmp_path), _cfg())


def _post(url, frames):
    body = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG")
        body.append(base64.b64encode(buf.getvalue()).decode())
    req = urllib.request.Request(
        url + "/predict", data=json.dumps({"frames": body}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_http_healthz_and_predict():
    httpd = make_server(_cfg(), "127.0.0.1", 0, max_batch=2, window_ms=10,
                        device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health == {"status": "ok", "model": "SViT", "batch": 2}
        status, out = _post(url, _frames(5, n=8))
        assert status == 200
        assert len(out["top_k"]) == 5
        assert all(0.0 <= t["score"] <= 1.0 for t in out["top_k"])
        assert np.asarray(out["pred_bboxes"]).shape == (4, 4, 5)
    finally:
        httpd.shutdown()
        httpd.predictor.stop()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
