"""Batched inference server on the card.

    python -m svit_tpu_torch.serving --cfg configs/ssv2.yaml \
        TEST.CHECKPOINT_FILE_PATH ckpt.pyth

Serves POST /predict (base64 JPEG frames -> top-k classes + HAOG boxes) and
GET /healthz on port 8080.  ``SERVE_PORT``, ``SERVE_MAX_BATCH`` and
``SERVE_WINDOW_MS`` override the port, the batch and the batching window.
"""

import os

from svit_tpu_torch.config import assert_and_infer_cfg, load_config, parse_args
from svit_tpu_torch.serving.server import serve
from svit_tpu_torch.utils.logging import setup_logging


def main():
    cfg = assert_and_infer_cfg(load_config(parse_args()))
    setup_logging()
    serve(
        cfg,
        port=int(os.environ.get("SERVE_PORT", "8080")),
        max_batch=int(os.environ.get("SERVE_MAX_BATCH", "8")),
        window_ms=float(os.environ.get("SERVE_WINDOW_MS", "10")),
    )


if __name__ == "__main__":
    main()
