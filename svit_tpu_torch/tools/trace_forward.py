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
- ``eager``: the same call op by op, ``--eager-iters`` times.  Under the
  profiler the program records its device owners as ranges
  (``utils/tracing.py``: ``module::<path>``), so that ``trace_attrib
  --by-owner`` maps each kernel to the owner that launched it, under the
  names of the replay's owner table.

The graph path also reports the program's owner table: the device ms of
each owner in its last replay, from the marks captured with it
(``owner_table``), and ``attention``: each attention owner's ms summed
over the blocks, by name and direction, in the replay and in the eager
trace.

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
import json
import os
import sys

import numpy as np
import torch

from svit_tpu_torch.tools import trace_attrib as ta
from svit_tpu_torch.tools.common import (CFG, REPO, fixed_params, load_cfg,
                                         train_batches, train_state)
from svit_tpu_torch.utils import tracing

OUT_DIR = os.path.join(REPO, "chiprun_out", "traces")
REPORT = os.path.join(REPO, "chiprun_out", "trace_forward.json")


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


def profile_calls(fn, iters, device, path, warmup=1):
    """``iters`` calls of ``fn`` under torch.profiler (after ``warmup``
    calls outside it); the trace exported to ``path`` and read back (None
    off the card, where it has no device events)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for _ in range(warmup):
        fn()
    _sync(device)
    with profile(activities=acts) as prof:
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
    _, eager, graph = (_train_path if train else _forward_path)(
        cfg, batch, device)
    result = {"what": what, "batch": batch}
    for kind, fn, n in (("graph", graph, iters),
                        ("eager", eager, eager_iters or iters)):
        path = os.path.join(out, f"{what}_{kind}.json.gz")
        tr = profile_calls(fn, n, device, path)
        result[kind] = {"trace": path, "iters": n}
        if kind == "graph":
            result[kind]["owner_table"] = tracing.last_table(
                "train" if train else "eval")
        if tr is None:         # no device events off the card
            continue
        s = ta.summarize(tr, n, top=None)    # every owner, for ``attention``
        s["ops"] = s["ops"][:top]
        result[kind].update(s)
        if verbose:
            print(f"== {what}, {kind}: {s['device_ms']:.3f} device ms/iter "
                  f"(batch {batch}, {n} iterations)")
            for name, ms, count in s["ops"][:top]:
                print(f"{ms:9.3f} ms {count:7.1f}x  {name[:110]}")
    if result["graph"]["owner_table"] and "owners" in result["eager"]:
        result["attention"] = attention_owners(
            result["graph"]["owner_table"]["ms"],
            {o: ms for o, ms, _ in result["eager"]["owners"]})
    return result


def attention_owners(replay: dict, eager: dict) -> dict:
    """{"<name>[ (backward)]": [replay ms, eager ms]}: each attention
    owner (``attn`` and the owners inside it) summed over the blocks and
    the step's forwards, from a replay's owner table and an eager trace's
    ``trace_attrib`` owners, which share the names.  In the forward the
    sub owners count as ``attn``, which holds them in a replay."""
    out = {}
    for src, i in ((replay, 0), (eager, 1)):
        for label, ms in src.items():
            names = tracing.parts(label)
            if "attn" not in names:
                continue
            if label.endswith(tracing.BACKWARD):
                key = names[-1] + tracing.BACKWARD
            else:
                key = "attn"
            out.setdefault(key, [0.0, 0.0])[i] += ms
    return out


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
