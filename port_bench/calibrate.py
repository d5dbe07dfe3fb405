"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size, in one process.

    python port_bench/calibrate.py --workload <cell> --seeds 12
        [--controls 3] [--first-seed N] [--seconds 2] [--out FILE]

- the lower readings: full runs of the program (``run.measure``, with a
  short window) on ``--seeds`` seeds, each number compared as the
  benchmark compares it;
- the control: the reference computed with fp8 products (``prec="fp8"``)
  put in the program's place, against the f32 reference, on the first
  ``--controls`` seeds; for a train cell also the control confined to
  the backward (``prec="fp8_bwd"``: the forward in f32);
- the faults, planted in the reference put in the program's place, on the
  same seeds: for a train cell half of each batch left out (the losses'
  means over the rest) and, reading 1 by the measure, a state left
  unchanged; for a test cell one score of every view altered (two classes
  swapped).

Each reading is a JSON line on standard output; the summary (per number:
the largest sound reading, the smallest control and fault readings) goes
to ``--out`` (``chiprun_out/port_bench_calibrate_<cell>.json``).  It runs
on the card only.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import run  # noqa: E402
from port_bench.core import cells, check, traffic  # noqa: E402
from port_bench.core.train_cell import _no_tf32  # noqa: E402


def _half(batch):
    out = {}
    for k, v in batch.items():
        out[k] = v[: len(v) // 2]
    return out


def train_controls(cell, seed, device):
    tc = run.runner(cell, seed, device)
    pool = traffic.train_pool(cell.mix, tc.arch, seed, device,
                              torch.bfloat16)
    with _no_tf32():
        ref = tc.reference("f32", pool)
        got = {f"control_{p}": check.train_numbers(tc.reference(p, pool),
                                                   ref)
               for p in ("fp8", "fp8_bwd")}
        half = tc.reference("f32", [(_half(v), _half(i)) for v, i in pool])
    got["fault_half_batch"] = check.train_numbers(half, ref)
    return got


def test_controls(cell, seed, device):
    tc = run.runner(cell, seed, device)
    views, _ = traffic.test_pool(cell.mix, tc.arch, seed, device)
    tc.views = views
    idx = list(range(len(views)))
    with _no_tf32():
        ref = tc.reference("f32", idx)
        fp8 = tc.reference("fp8", idx)
    altered = {}
    for i, s in ref.items():
        a = s.clone()
        top = a.argmax(-1)
        low = a.argmin(-1)
        rows = torch.arange(a.shape[0])
        a[rows, top], a[rows, low] = s[rows, low], s[rows, top]
        altered[i] = a
    return {"control_fp8": {"score_gap": max(
                check.score_gap(fp8[i], ref[i]) for i in idx)},
            "fault_altered_answer": {"score_gap": max(
                check.score_gap(altered[i], ref[i]) for i in idx)}}


def calibrate(cell, seeds, n_controls, seconds, device) -> dict:
    """The readings on ``seeds`` (and the control's and the faults' on the
    first ``n_controls``), in this process."""
    names = sorted(cell.limits["numbers"])
    sound = {n: [] for n in names}
    upper = {}
    for seed in seeds:
        t0 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        result, rows = run.measure(cell, seed, seconds, False, device,
                                   started=time.time())
        for n, v, _ in rows:
            sound[n].append(v)
        print(json.dumps({"seed": seed, "kind": "program",
                          "readings": {n: v for n, v, _ in rows},
                          "metrics": result["metrics"],
                          "peak": result["device"]["memory_peak_bytes"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    controls = train_controls if cell.mix["kind"] == "train" else \
        test_controls
    for seed in seeds[:n_controls]:
        got = controls(cell, seed, device)
        for what, numbers in got.items():
            for n in names:
                if n in numbers:
                    upper.setdefault(what, {}).setdefault(n, []).append(
                        numbers[n])
            print(json.dumps({"seed": seed, "kind": what, "readings": {
                n: numbers.get(n) for n in names}, "worst": numbers.get(
                "_worst"), "video_leaves": numbers.get("_video_leaves"),
                "loss_gaps": numbers.get("_loss_gaps")}), flush=True)
    return {"workload": cell.name, "seeds": seeds,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "lower": {n: max(v) for n, v in sound.items() if v},
            "sound": sound,
            "upper": {w: {n: min(v) for n, v in d.items()}
                      for w, d in upper.items()},
            "readings": upper}


def _write(summary, out):
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"summary": {k: summary[k] for k in
                                  ("lower", "upper")}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    out = args.out or os.path.join(
        ROOT, "chiprun_out", f"port_bench_calibrate_{args.workload}.json")
    _write(calibrate(cell, seeds, args.controls, args.seconds,
                     torch.device("cuda")), out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
