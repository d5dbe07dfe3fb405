"""The data-loading benchmark (counterpart of ``tools/benchmark.py``,
reference ``tools/benchmark.py`` and ``slowfast/utils/benchmark.py``):

    python -m svit_tpu_torch.tools.benchmark --cfg configs/ssv2.yaml
        [--device cpu] [KEY VALUE ...]

iterates the train loader (``data/loader.py:construct_loader``, reshuffled
per epoch by ``shuffle_dataset`` with ``BENCHMARK.SHUFFLE``) for
``BENCHMARK.NUM_EPOCHS`` epochs, with the config's
``DATA_LOADER.NUM_WORKERS``, and logs a ``benchmark_iter`` record (iters/s
over the last ``BENCHMARK.LOG_PERIOD`` batches, clips/s since the epoch
began) every ``LOG_PERIOD`` batches and a ``benchmark_epoch`` record
(seconds, clips/s) per epoch, as ``json_stats`` lines.  Nothing reaches
the card: it measures the host's decoding and augmentation alone.  The
records also go to ``chiprun_out/benchmark.json``.  It runs where the card
is, unless given ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "chiprun_out", "benchmark.json")


def benchmark_data_loading(cfg) -> list:
    """Iterate the train loader; returns the logged records."""
    from svit_tpu_torch.data.loader import construct_loader, shuffle_dataset
    from svit_tpu_torch.utils import logging

    logging.setup_logging(cfg.OUTPUT_DIR)
    records = []

    def log(stats):
        records.append(stats)
        logging.log_json_stats(stats)

    video_loader, image_loader = construct_loader(cfg, "train")
    log_period = cfg.BENCHMARK.LOG_PERIOD
    for epoch in range(cfg.BENCHMARK.NUM_EPOCHS):
        if cfg.BENCHMARK.SHUFFLE:
            shuffle_dataset((video_loader, image_loader), epoch)
        num_clips = 0
        t_start = time.perf_counter()
        t0 = t_start
        for it, batch in enumerate(video_loader):
            num_clips += int(batch["weight"].sum())
            if (it + 1) % log_period == 0:
                dt = time.perf_counter() - t0
                log({"_type": "benchmark_iter", "epoch": epoch,
                     "iter": it + 1, "iters_per_sec": log_period / dt,
                     "clips_per_sec":
                         num_clips / (time.perf_counter() - t_start)})
                t0 = time.perf_counter()
        total = time.perf_counter() - t_start
        log({"_type": "benchmark_epoch", "epoch": epoch, "seconds": total,
             "clips_per_sec": num_clips / total})
    return records


def main(argv=None, device=None):
    from svit_tpu_torch.config import (assert_and_infer_cfg, load_config,
                                       parse_args)
    from svit_tpu_torch.models.build import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        at = argv.index("--device")
        device = device or argv[at + 1]
        del argv[at:at + 2]
    resolve_device(device)
    cfg = assert_and_infer_cfg(load_config(parse_args(argv)))
    records = benchmark_data_loading(cfg)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(records, f, indent=1)
    return records


if __name__ == "__main__":
    main()
