"""The train loop's steady-state step time at production shapes
(counterpart of ``tools/engine_steady_state.py``).

    python -m svit_tpu_torch.tools.engine_steady_state [--steps 30]
        [--warmup 4] [--device cpu] [--cfg FILE] [KEY VALUE ...]

A bench times the bare captured step; the CLI's loop
(``engine/train.py:train_epoch``) adds the batch hand-over, the generator's
reseed per step, the meters, the ``LOG_PERIOD``-batched metric fetch and
the preemption poll.  This tool runs that real ``train_epoch`` on the
bench's shapes (16 frames at 224, video 8 + image 8 + the consistency
forward, bf16 through the kernels, the step captured in a CUDA graph) on
staged batches (``_StagedLoader``): two distinct batches, cycled, already
on the card, so neither host decoding nor the host-to-device copy enters
the measurement (the JAX tool's ``--preput``).  The loaders hand out the
host's per-sample weights, as ``train_epoch``'s host-side clip count
wants, and ``put_ahead`` the staged device batches.  One warm-up epoch of
``--warmup`` steps takes the capture; then ``--steps`` steps are timed,
to the trailing metric fetch, which waits for the last step.

It prints one JSON object and writes it to
``chiprun_out/engine_steady_state.json``: ``engine_step_ms``, ``steps``,
``video_clips_per_sec_chip`` and ``log_period`` (the JAX tool's keys but
its comparison with a bench's step time, which the benchmark,
``port_bench/``, now measures).  ``LOG_PERIOD`` is
``SVIT_ENGINE_LOG_PERIOD`` (10).  It runs on the card and raises without
one unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from svit_tpu_torch.tools.common import (CFG, REPO, load_cfg, train_batches,
                                         train_state)

OUT = os.path.join(REPO, "chiprun_out", "engine_steady_state.json")
TRAIN_BATCH_VIDEO = 8
TRAIN_BATCH_IMAGE = 8


class _StagedLoader:
    """Staged batches behind the loaders' iterator API."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)

    def iter_batches(self, start=0):
        yield from self.batches[start:]


def _staged(cfg, video, image, device):
    """Two distinct (video, image) pairs of the bench's shapes (one
    ``RandomState(0)`` stream) as host twins: the device tensors, clips and
    frames in the pixel dtype as ``put_batch`` hands them over, with the
    per-sample weights on the host; and the device weight each host
    weight stands for."""
    from svit_tpu_torch.models.build import compute_dtype

    rs = np.random.RandomState(0)
    pairs, weights = [], {}
    for _ in range(2):
        twins = []
        for dev in train_batches(cfg, video, image, device, rs,
                                 compute_dtype(cfg)):
            host = dev["weight"].cpu().numpy()
            weights[id(host)] = dev["weight"]
            twins.append(dict(dev, weight=host))
        pairs.append(tuple(twins))
    return pairs, weights


def measure(steps=30, warmup=4, device=None, cfg_file=None, opts=(),
            verbose=True) -> dict:
    from svit_tpu_torch.engine import graphs
    from svit_tpu_torch.engine import meters as meters_lib
    from svit_tpu_torch.engine.train import train_epoch
    from svit_tpu_torch.models.build import resolve_device

    device = resolve_device(device)
    cfg = load_cfg(cfg_file or CFG, opts)
    cfg.LOG_PERIOD = int(os.environ.get("SVIT_ENGINE_LOG_PERIOD", "10"))

    _, arch, state, packed = train_state(cfg, device, packed=True)
    step, metric_names = packed
    pairs, weights = _staged(cfg, TRAIN_BATCH_VIDEO, TRAIN_BATCH_IMAGE,
                             device)

    def loaders(n):
        picks = [pairs[i % 2] for i in range(n)]
        return (_StagedLoader([v for v, _ in picks]),
                _StagedLoader([i for _, i in picks]))

    def put_ahead(*batches):
        """Each host twin's device batch; nothing to wait for."""
        return [None if b is None
                else dict(b, weight=weights[id(b["weight"])])
                for b in batches], None

    trainer = SimpleNamespace(
        arch=arch, step_fn=graphs.CapturedTrainStep(step),
        metric_names=metric_names, steps_per_epoch=warmup + steps,
        generator=torch.Generator(device=device),
        put_ahead=put_ahead, wait_for=lambda batches, ready: None)
    trainer.train_loader, trainer.image_loader = loaders(warmup)
    if verbose:
        print(f"warm-up ({warmup} steps, with the capture)...",
              file=sys.stderr)
    state, _ = train_epoch(cfg, trainer, state,
                           meters_lib.TrainMeter(warmup + steps, cfg), 0)

    trainer.train_loader, trainer.image_loader = loaders(steps)
    meter = meters_lib.TrainMeter(steps, cfg)
    if verbose:
        print(f"measuring {steps} steps through train_epoch...",
              file=sys.stderr)
    t0 = time.perf_counter()
    state, _ = train_epoch(cfg, trainer, state, meter, 1)
    # train_epoch's last metric fetch waits for the last step
    dt = time.perf_counter() - t0

    return {
        "engine_step_ms": dt / steps * 1e3,
        "steps": steps,
        "video_clips_per_sec_chip": TRAIN_BATCH_VIDEO / (dt / steps),
        "log_period": cfg.LOG_PERIOD,
        "h2d_excluded": True,
        "note": ("the real train_epoch at the bench's shapes, the step a "
                 "CUDA graph; host data production and the host-to-device "
                 "copy excluded (batches staged on the device)"),
    }


def main(argv=None, device=None):
    from svit_tpu_torch.models.build import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--device", default=None)
    ap.add_argument("--cfg", dest="cfg_file", default=CFG)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    device = resolve_device(device or args.device)
    out = measure(args.steps, args.warmup, device, args.cfg_file, args.opts)
    print(json.dumps(out))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
