"""A device trace of the SViT forward or train step, with time per kernel
(counterpart of ``tools/trace_forward.py``).

    python -m svit_tpu_torch.tools.trace_forward [--batch 16] [--iters 5]
        [--eager-iters N] [--train] [--top 40] [--out DIR] [--device cpu]
        [--cfg FILE] [KEY VALUE ...]

Builds the SViT-B/16 serving model of ``configs/ssv2.yaml`` at ``--batch``
with the JAX tool's random weights (``common.fixed_params(seed=1,
fresh=True)``: normal(0, 0.02) from a new ``RandomState(1)`` per leaf), or
with ``--train`` the fused train step at ``bench.py:171-192``'s shapes
(video ``batch // 2``, image ``batch // 2``, the consistency forward, AdamW
as ``engine/steps.py`` builds it).  Each path runs twice under
``torch.profiler`` (CPU and CUDA activities):

- ``graph``: the CUDA graph that ``engine/graphs.py`` captures, replayed
  ``--iters`` times: the device time per iteration as the entry points run
  it.  A replay's kernels have no launching op;
- ``eager``: the same call op by op, ``--eager-iters`` times, with every
  module's scope recorded (``module_scopes``: forward pre- and post-hooks
  installed only while it traces), so that ``trace_attrib --by-owner``
  maps each kernel to the module that launched it.

Warm-up and capture (and the train step's restore after its warm-up
steps) stay outside the traced window.  Each trace is exported as a
gzipped Chrome trace to ``--out`` (``chiprun_out/traces/`` by default)
and summarized by ``trace_attrib``: device ms per iteration in all and by
kernel name, busiest first.  The summaries go to
``chiprun_out/trace_forward.json``.  It runs on the card and raises
without one unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from svit_tpu_torch.tools import trace_attrib as ta
from svit_tpu_torch.tools.common import (CFG, REPO, fixed_params, load_cfg,
                                         train_batches, train_state)

OUT_DIR = os.path.join(REPO, "chiprun_out", "traces")
REPORT = os.path.join(REPO, "chiprun_out", "trace_forward.json")


@contextlib.contextmanager
def module_scopes(model, prefix: str = ta.MODULE):
    """Record a profiler range ``<prefix><path>`` around every module's
    forward (the model's own path is its class name) while the block
    runs; the hooks go when it ends."""
    from torch.autograd.profiler import record_function

    open_ranges, hooks = [], []

    def enter(path):
        def pre(mod, args):
            rf = record_function(prefix + path)
            rf.__enter__()
            open_ranges.append(rf)
        return pre

    def leave(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    for path, mod in model.named_modules():
        hooks.append(mod.register_forward_pre_hook(
            enter(path or type(model).__name__)))
        hooks.append(mod.register_forward_hook(leave))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        while open_ranges:   # a forward that raised left its ranges open
            open_ranges.pop().__exit__(None, None, None)


def _forward_path(cfg, batch, device):
    """(the model, an eager forward, the captured forward)."""
    from svit_tpu_torch.engine import graphs
    from svit_tpu_torch.models import build_model

    model, arch = build_model(cfg, device=device)
    fixed_params(model, seed=1, fresh=True)
    S, T = cfg.DATA.TEST_CROP_SIZE, cfg.DATA.NUM_FRAMES
    x = torch.from_numpy(np.random.RandomState(0).randn(
        batch, T, S, S, 3).astype(np.float32)).to(device)

    def fwd(inp):
        with torch.inference_mode():
            return model(inp)[0]

    captured = graphs.CapturedStep(fwd)
    return model, lambda: fwd(x), lambda: captured(x)


def _train_path(cfg, batch, device):
    from svit_tpu_torch.engine import graphs

    model, _, state, step = train_state(cfg, device)
    video, image = train_batches(cfg, max(batch // 2, 1),
                                 max(batch // 2, 1), device)
    gen = torch.Generator(device=device).manual_seed(1)
    captured = graphs.CapturedTrainStep(step)

    def eager():
        return step(state, video, image, gen)[1]["loss"]

    def graph():
        return captured(state, video, image, gen)[1]["loss"]

    return model, eager, graph


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_calls(fn, iters, device, path, model=None, warmup=1):
    """``iters`` calls of ``fn`` under torch.profiler (after ``warmup``
    calls outside it), with ``model``'s module scopes if given; the trace
    exported to ``path`` and read back (None off the card, where it has
    no device events)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for _ in range(warmup):
        fn()
    _sync(device)
    scopes = module_scopes(model) if model is not None else \
        contextlib.nullcontext()
    with profile(activities=acts) as prof, scopes:
        for _ in range(iters):
            fn()
        _sync(device)
    if device.type == "cuda":
        return ta.from_profiler(prof, path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    return None


def trace(train=False, batch=16, iters=5, eager_iters=None, out=OUT_DIR,
          device=None, cfg_file=None, opts=(), top=40, verbose=True) -> dict:
    """Trace the forward (or the train step) as a replayed graph and
    eager; returns each path's ``trace_attrib.summarize`` and its trace's
    path."""
    from svit_tpu_torch.models.build import resolve_device

    device = resolve_device(device)
    cfg = load_cfg(cfg_file or CFG, opts)
    what = "train" if train else "forward"
    model, eager, graph = (_train_path if train else _forward_path)(
        cfg, batch, device)
    result = {"what": what, "batch": batch}
    for kind, fn, n, scoped in (("graph", graph, iters, None),
                                ("eager", eager, eager_iters or iters,
                                 model)):
        path = os.path.join(out, f"{what}_{kind}.json.gz")
        tr = profile_calls(fn, n, device, path, scoped)
        result[kind] = {"trace": path, "iters": n}
        if tr is None:         # no device events off the card
            continue
        s = ta.summarize(tr, n, top)
        result[kind].update(s)
        if verbose:
            print(f"== {what}, {kind}: {s['device_ms']:.3f} device ms/iter "
                  f"(batch {batch}, {n} iterations)")
            for name, ms, count in s["ops"][:top]:
                print(f"{ms:9.3f} ms {count:7.1f}x  {name[:110]}")
    return result


def main(argv=None, device=None):
    from svit_tpu_torch.models.build import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--eager-iters", type=int, default=None)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--train", action="store_true",
                    help="trace the fused train step (bench.py's shapes) "
                         "instead of the forward")
    ap.add_argument("--device", default=None)
    ap.add_argument("--cfg", dest="cfg_file", default=CFG)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    device = resolve_device(device or args.device)
    result = trace(args.train, args.batch, args.iters, args.eager_iters,
                   args.out, device, args.cfg_file, args.opts, args.top)
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {REPORT}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
