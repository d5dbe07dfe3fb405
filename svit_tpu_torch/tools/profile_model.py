"""The ablation profiler: where the forward's milliseconds live (counterpart
of ``tools/profile_model.py``).

    python -m svit_tpu_torch.tools.profile_model [--batch 16] [--iters 10]
        [--variants full,no_kernels,maxpool,prefix] [--device cpu]
        [--cfg FILE] [KEY VALUE ...]

Times variants of the SViT-B/16 serving forward (``configs/ssv2.yaml``, the
JAX tool's random weights) as the entry points run it: captured in a CUDA
graph (``engine/graphs.py``), warmed up, then ``--iters`` chained replays
with one synchronize at the end.  Each variant toggles one suspect:

  full         the main path (the hand-written kernels, bf16)
  no_kernels   the plain PyTorch versions (``use_kernels=False``), bf16
  maxpool      q and k|v pooling by max (``MVIT.MODE max``: no depthwise
               convolutions and no per-head LN)
  prefix:K     the first K blocks only (the per-stage cost curve), for K
               in 1, 2, 3, 8, 14, 16, the schedule lists cut to them as
               ``tools/profile_model.py:87-95`` cuts them

It prints ms per forward and clips/s and writes them to
``chiprun_out/profile_model.json``.  It runs on the card and raises
without one unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from svit_tpu_torch.tools.common import CFG, REPO, fixed_params, load_cfg

OUT = os.path.join(REPO, "chiprun_out", "profile_model.json")
VARIANTS = ("full", "no_kernels", "maxpool", "prefix")
PREFIXES = (1, 2, 3, 8, 14, 16)
WARMUP = 3


def maxpool(cfg) -> None:
    cfg.MVIT.MODE = "max"


def prefix(k: int):
    """The config edit that keeps the first ``k`` blocks."""
    def edit(cfg):
        cfg.MVIT.DEPTH = k
        cfg.MVIT.DIM_MUL = [m for m in cfg.MVIT.DIM_MUL if m[0] < k]
        cfg.MVIT.HEAD_MUL = [m for m in cfg.MVIT.HEAD_MUL if m[0] < k]
        cfg.MVIT.POOL_Q_STRIDE = [m for m in cfg.MVIT.POOL_Q_STRIDE
                                  if m[0] < k]
    return edit


def build(edit=None, device=None, cfg_file=None, opts=(), **build_kw):
    """(model, arch, cfg): the config, ``opts``, then ``edit``; the model
    with the JAX tool's random weights."""
    from svit_tpu_torch.models import build_model

    cfg = load_cfg(cfg_file or CFG, opts, edit)
    model, arch = build_model(cfg, device=device, **build_kw)
    fixed_params(model, seed=1, fresh=True)
    return model, arch, cfg


def time_forward(model, cfg, batch, iters, tag, device, verbose=True):
    """ms per forward over ``iters`` chained replays of the captured
    forward, one synchronize at the end."""
    from svit_tpu_torch.engine import graphs

    S, T = cfg.DATA.TEST_CROP_SIZE, cfg.DATA.NUM_FRAMES
    x = torch.from_numpy(np.random.RandomState(0).randn(
        batch, T, S, S, 3).astype(np.float32)).to(device)

    def fwd(inp):
        with torch.inference_mode():
            return model(inp)[0]

    step = graphs.CapturedStep(fwd)
    for _ in range(WARMUP):
        step(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(x)
    float(out.float().sum())   # one sync, after the last replay
    ms = (time.perf_counter() - t0) / iters * 1e3
    if verbose:
        print(f"{tag:24s} {ms:8.2f} ms/fwd   {batch / ms * 1e3:8.1f} clips/s",
              flush=True)
    return ms


def variants(names=VARIANTS):
    """(tag, config edit, build keywords) of each variant asked for."""
    out = []
    if "full" in names:
        out.append(("full", None, {}))
    if "no_kernels" in names:
        out.append(("no_kernels", None, {"use_kernels": False}))
    if "maxpool" in names:
        out.append(("maxpool", maxpool, {}))
    if "prefix" in names:
        out += [(f"prefix:{k}", prefix(k), {}) for k in PREFIXES]
    return out


def profile(names=VARIANTS, batch=16, iters=10, device=None, cfg_file=None,
            opts=(), verbose=True) -> dict:
    """{tag: {"ms", "clips_per_s"}} of each variant."""
    from svit_tpu_torch.models.build import resolve_device

    device = resolve_device(device)
    result = {}
    for tag, edit, kw in variants(names):
        model, _, cfg = build(edit, device, cfg_file, opts, **kw)
        ms = time_forward(model, cfg, batch, iters, tag, device, verbose)
        result[tag] = {"ms": ms, "clips_per_s": batch / ms * 1e3}
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return result


def main(argv=None, device=None):
    from svit_tpu_torch.models.build import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default=None)
    ap.add_argument("--cfg", dest="cfg_file", default=CFG)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    device = resolve_device(device or args.device)
    result = profile(args.variants.split(","), args.batch, args.iters,
                     device, args.cfg_file, args.opts)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(result, batch=args.batch, iters=args.iters), f,
                  indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
