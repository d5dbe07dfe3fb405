"""A traced slice of a run: ``torch.profiler`` over a few steps, reduced
to what the per-layer readers take.

The profiler records the device's kernels, copies and sets (CUPTI: a
replayed CUDA graph's kernels each have a record) and the host's ops.
From them: the device's busy time (the union of the device intervals),
the device time by family (``yardstick.family``), the heaviest device
operations and the longest idle gaps, each named by the host op that
covered most of it.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import torch

from port_bench.core import yardstick


def _events(prof):
    """(name, device?, memory op?, start ns, end ns) of every record."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        name = e.name()
        lo = e.start_ns()
        out.append((name, dev, dev and _is_memop(name), lo,
                    lo + e.duration_ns()))
    return out


def _is_memop(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def _union(intervals):
    total, end = 0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def traced(run: Callable[[], int], device) -> dict:
    """Run ``run()`` (which returns the units of work it did: steps or
    batches) under the profiler, from a synchronised start to a
    synchronised end; returns the reduction."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        units = run()
        _sync(device)
        window = time.perf_counter() - t0
    return reduce(_events(prof), window, units)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reduce(events, window_s: float, units: int) -> dict:
    dev = [e for e in events if e[1]]
    host = [e for e in events if not e[1] and e[4] > e[3]]
    if not dev:
        return {"window_s": window_s, "units": units, "busy_s": 0.0,
                "families": {}, "device_ops": [], "idle_gaps": []}
    busy = _union([(lo, hi) for _, _, _, lo, hi in dev]) / 1e9
    fams = collections.Counter()
    ops = collections.Counter()
    for name, _, mem, lo, hi in dev:
        fams[yardstick.family(name, mem)] += (hi - lo) / 1e9
        ops[yardstick.short(name)] += (hi - lo) / 1e9
    return {"window_s": window_s, "units": units, "busy_s": busy,
            "families": dict(fams),
            "device_ops": [[n, s] for n, s in ops.most_common(10)],
            "idle_gaps": _gaps(dev, host)}


def _gaps(dev, host, top: int = 10):
    """The longest gaps between device activity, each named by the host op
    that overlaps it most (ops of the same name summed)."""
    spans = sorted((lo, hi) for _, _, _, lo, hi in dev)
    gaps, end = [], spans[0][1]
    for lo, hi in spans[1:]:
        if lo > end:
            gaps.append((end, lo))
        end = max(end, hi)
    named = collections.Counter()
    host = sorted(host, key=lambda e: e[3])
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        best, most = "host", 0
        for name, _, _, hlo, hhi in host:
            if hlo >= hi:
                break
            over = min(hi, hhi) - max(lo, hlo)
            if over > most:
                best, most = name, over
        named[best] += (hi - lo) / 1e9
    return [[n, s] for n, s in named.most_common(top)]


def per_unit(summary: dict, key: str) -> float:
    """Device seconds a unit (step or batch) in the hand-written kernels
    (``key`` "hand") or in everything else ("glue")."""
    hand = key == "hand"
    s = sum(v for f, v in summary["families"].items()
            if yardstick.is_hand_written(f) == hand)
    return s / max(summary["units"], 1)
