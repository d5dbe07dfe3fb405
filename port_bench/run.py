"""The benchmark of the PyTorch and CUDA port (``svit_tpu_torch``): one run
of one cell.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A run loads the cell's files by the names ``BENCHMARK.json`` gives
(``core/cells.py``), builds the program on the card with weights made on
the device from the seed, warms up the cell's own shapes and captures its
step (the set-up), then measures for ``--seconds`` (``--trace 0``: the
cell's end-to-end metrics) or profiles a short slice (``--trace 1``: its
per-layer metrics, each read by ``metrics/<metric>.py``).  After the
window it reads the device's peak memory, frees the program, holds what
the timed path produced against the plain reference (``reference/``),
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``), and last ``checked``: each number
compared, with its limit, which also close standard error.

It runs on the card and nowhere else: without one, or with fewer cards
than the cell asks for, it exits 2 and prints no result.  It prints no
result and exits 3 if the process has loaded JAX, flax or the JAX
package.
Kernel builds, the modules' bytecode and other caches stay inside the
checkout, at fixed paths.
"""

import time

T_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, "port_bench", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# The modules' bytecode too: an installation without it (or that may not be
# written) has its sources compiled in every process, some 8 s of each
# set-up on the card's machine; here only a checkout's first run does that.
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False

import torch  # noqa: E402

from port_bench.core import cells, check, guard, trace  # noqa: E402
from port_bench.core.test_cell import TestCell  # noqa: E402
from port_bench.core.train_cell import TrainCell  # noqa: E402
from port_bench.core.yardstick import PEAK_BF16  # noqa: E402

RUNNERS = {"train": TrainCell, "test": TestCell}


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def runner(cell, seed, device):
    return RUNNERS[cell.mix["kind"]](cell, seed, device)


def end_to_end(cell, run, units, window_s, setup_s) -> dict:
    """The cell's end-to-end metrics from the window: all the work over all
    of its time."""
    per_unit = {"train": int(cell.mix.get("video_batch", 0)),
                "test": int(cell.mix.get("batch", 0))}[run.kind]
    values = {"train_clips_per_s": units * per_unit / window_s,
              "test_views_per_s": units * per_unit / window_s,
              "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, run, summary) -> dict:
    ctx = {"kind": run.kind, "chips": cell.chips, "summary": summary,
           "flops_per_unit": run.flops_per_unit(),
           "bound_s_per_unit": run.bound_s_per_unit(),
           "peak_flops": PEAK_BF16}
    out = {}
    for m in cell.per_layer:
        v = cells.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def measure(cell, seed, seconds, traced, device, started=None):
    """One run of ``cell`` on ``device``: (the result, the compared rows);
    set-up counts from ``started`` (wall clock, the process's start by
    default)."""
    run = runner(cell, seed, device)
    run.setup()
    setup_s = time.time() - (T_WALL if started is None else started)
    say(f"set-up {setup_s:.3f} s: {json.dumps(run.phases)}")
    breakdown = None
    if traced:
        summary = trace.traced(run.traced_units, run.device)
        metrics = per_layer(cell, run, summary)
        units, window_s = summary["units"], summary["window_s"]
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    else:
        units, window_s = run.window(seconds)
    say(f"window {window_s:.3f} s, {units} {run.kind} units")
    on_card = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    run.release()
    t0 = time.perf_counter()
    numbers = run.numbers()
    say(f"check {time.perf_counter() - t0:.3f} s: "
        + json.dumps({k: v for k, v in numbers.items()
                      if k.startswith("_")}))
    if not traced:
        metrics = end_to_end(cell, run, units, window_s, setup_s)
    correct, rows = check.judge(numbers, cell.limits)
    attempted = units * (int(cell.mix["batch"]) if run.kind == "test"
                         else 1)
    device_info = {"platform": "gpu" if on_card else run.device.type,
                   "kind": (torch.cuda.get_device_name(run.device)
                            if on_card else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = window_s
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": 0, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, rows = measure(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda"))
    bad = guard.forbidden()
    if bad:
        say(f"the run loaded forbidden modules: {bad}")
        return 3
    for name, value, limit in rows:
        say(f"checked {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
