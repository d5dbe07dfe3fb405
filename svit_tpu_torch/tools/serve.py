"""Batched inference server CLI (counterpart of ``tools/serve.py``):

    python -m svit_tpu_torch.tools.serve --cfg configs/ssv2.yaml \
        TEST.CHECKPOINT_FILE_PATH ckpt.pyth

Serves POST /predict (base64 JPEG frames -> top-k classes + HAOG boxes) and
GET /healthz on port 8080; ``SERVE_PORT``, ``SERVE_MAX_BATCH`` and
``SERVE_WINDOW_MS`` override the port, the batch and the batching window.
"""

from svit_tpu_torch.serving.__main__ import main

if __name__ == "__main__":
    main()
