"""Multi-view test engine (counterpart of ``svit_tpu/engine/test.py``,
reference ``tools/test_net.py``).

The test dataset replicates every video ``NUM_ENSEMBLE_VIEWS x
NUM_SPATIAL_CROPS`` times; batched inference runs on the card, and the
host-side ``TestMeter`` sums (or maxes) the per-clip softmax scores into
video slots and finalizes top-1/top-5 (reference ``test_net.py:24-171``,
``meters.py:237-398``).  One card holds the whole batch: the JAX engine's
mesh and sharding have no counterpart here (ROADMAP Queue 1 item 5).  On
the card the test step is a CUDA graph per batch shape
(``engine/graphs.py``), as the JAX engine jit-compiles it.

    python -m svit_tpu_torch.engine.test --cfg configs/ssv2.yaml [KEY VALUE ...]

runs on the card, and raises without one.
"""

from __future__ import annotations

import pickle
import pprint

import numpy as np
import torch

from svit_tpu_torch.config import assert_and_infer_cfg, load_config, parse_args
from svit_tpu_torch.data.loader import construct_loader
from svit_tpu_torch.engine import meters as meters_lib
from svit_tpu_torch.engine import graphs, steps
from svit_tpu_torch.models import build_model
from svit_tpu_torch.utils import checkpoint as cu
from svit_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


def to_device(array: np.ndarray, device: torch.device,
              dtype: torch.dtype = None) -> torch.Tensor:
    """One host-to-device copy of a batch array (cast to ``dtype`` on the
    host first), from pinned memory on the card."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device=device, dtype=dtype)
    if dtype is not None and dtype != t.dtype:
        t = torch.empty(t.shape, dtype=dtype, pin_memory=True).copy_(t)
    else:
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def perform_test(test_step, test_loader, test_meter, device):
    """Every test batch through ``test_step``; the rows with ``weight > 0``
    (the last batch is padded) go to ``test_meter``."""
    test_meter.iter_tic()
    for cur_iter, batch in enumerate(test_loader):
        preds = test_step({"clips": to_device(batch["clips"], device)})
        preds = preds.float().cpu().numpy()
        valid = batch["weight"] > 0
        test_meter.update_stats(preds[valid], batch["labels"][valid],
                                batch["index"][valid])
        test_meter.iter_toc()
        test_meter.log_iter_stats(cur_iter)
        test_meter.iter_tic()
    return test_meter.finalize_metrics()


def test(cfg, device=None):
    """Multi-view test of ``cfg``'s model on ``TEST.DATASET``: the weights
    of ``utils/checkpoint.py:load_test_checkpoint_path`` (TEST path > last
    checkpoint > TRAIN path), or the seeded random ones.  Runs on the card
    unless ``device`` says otherwise; returns the final stats, and writes
    the video preds and labels to ``TEST.SAVE_RESULTS_PATH`` when set."""
    np.random.seed(cfg.RNG_SEED)
    logging.setup_logging(cfg.OUTPUT_DIR)
    logger.info("Test with config:")
    logger.info(pprint.pformat(cfg.to_dict()))

    model, arch = build_model(cfg, device=device)
    device = next(model.parameters()).device
    test_loader = construct_loader(cfg, "test")

    num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    num_items = test_loader.dataset.num_videos
    assert num_items % num_clips == 0, (
        f"test set size {num_items} not divisible by {num_clips} views")

    ckpt_path = cu.load_test_checkpoint_path(cfg)
    if ckpt_path:
        cu.load_params_any(model, ckpt_path, cfg)
        logger.info("Loaded test checkpoint %s", ckpt_path)

    nc = arch.num_classes if isinstance(arch.num_classes, int) else 0
    test_meter = meters_lib.TestMeter(num_items // num_clips, num_clips, nc,
                                      len(test_loader),
                                      cfg.DATA.ENSEMBLE_METHOD)
    stats = perform_test(graphs.CapturedStep(steps.make_test_step(model)),
                         test_loader, test_meter, device)

    if cfg.TEST.SAVE_RESULTS_PATH:
        with open(cfg.TEST.SAVE_RESULTS_PATH, "wb") as f:
            pickle.dump({"video_preds": test_meter.video_preds,
                         "video_labels": test_meter.video_labels}, f)
    return stats


def main(argv=None):
    cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
    test(cfg)


if __name__ == "__main__":
    main()
