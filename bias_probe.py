#!/usr/bin/env python3
"""How much of the train step's f32 GEMM time the rel-pos bias builder owns.

    python3 bias_probe.py

On one NVIDIA card: the full-size train step of ``chip_smoke.py``'s phase 7
(SViT-B/16, 16 x 224, bf16 kernels, video 8 + image 8 + the 128-frame
consistency forward) profiled with ``torch.profiler`` in turns with two
builders of ``ops/attention.py:build_bias_inputs_grid``:

- ``io``: the port's builder, bf16 operands with an f32 sum (cuBLAS's
  batched GEMM with an f32 output, on the tensor cores);
- ``f32``: the formulation it replaced, queries and tables upcast to f32
  and the einsums (and autograd's backward of them) in f32.

Order io, f32, f32, io, each after a warm-up step.  Per run it prints the
step's device time, its GEMM rows by operand type, and the kernels inside
the builder's profiler ranges (its forward; for ``io`` also the backward of
its products).  The f32 GEMM time that the ``f32`` builder adds over
``io`` is the builder's share.  Writes ``chiprun_out/bias_probe.json``.
Without a card it exits 2.
"""

import collections
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def f32_builder(q_grid, num_heads, q_shape, k_shape, *, rel_pos_h, rel_pos_w,
                rel_pos_t):
    """The builder before the repair: f32 einsums of upcast operands."""
    import torch

    from svit_tpu_torch.ops import rel_pos as rp
    from svit_tpu_torch.utils import tracing

    B, Tq, Hq, Wq, C = q_grid.shape
    k_t, k_h, k_w = k_shape
    dt = q_grid.dtype
    with tracing.owner("bias"):
        rq = q_grid.reshape(B, Tq, Hq, Wq, num_heads, C // num_heads).float()

        def term(eq, table):
            return torch.einsum(eq, rq, table.to(dt).float()).to(dt)

        terms = [term("btpwhc,tuc->bhtpwu",
                      rp.rel_table(rel_pos_t, q_shape[0], k_t)),
                 term("btpwhc,pkc->bhtpwk",
                      rp.rel_table(rel_pos_h, q_shape[1], k_h)),
                 term("btpwhc,wkc->bhtpwk",
                      rp.rel_table(rel_pos_w, q_shape[2], k_w))]
        q_l = Tq * Hq * Wq
        return torch.cat([t.reshape(B, num_heads, q_l, t.shape[-1])
                          for t in terms], dim=-1).contiguous()


def main():
    import torch

    if not torch.cuda.is_available():
        print("bias_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from svit_tpu_torch.config import get_cfg
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.ops import attention as ta

    card = cs.card_line()
    cs.log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _lib.build()
    _lib.library()
    cfg = get_cfg()
    cfg.merge_from_file(cs.CFG)
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    state, step, _ = cs.train_setup(cfg, torch, torch.bfloat16, True)
    video, image = cs.train_batch(cfg, torch)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    io_builder = ta.build_bias_inputs_grid
    builders = {"io": io_builder, "f32": f32_builder}
    runs = []
    for name in ("io", "f32", "f32", "io"):
        ta.build_bias_inputs_grid = builders[name]
        try:
            step(state, video, image, gen)          # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(state, video, image, gen)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            ta.build_bias_inputs_grid = io_builder
        rows = cs.device_rows(prof, torch)
        by_type = collections.Counter()
        for g in cs.gemm_rows(rows):
            by_type[g["dtype"]] += g["ms"]
        run = {"builder": name, "wall_ms": wall_ms,
               "device_ms": sum(r[2] for r in rows),
               "gemm_ms_by_type": dict(by_type),
               "bias_builder": cs.bias_rows(prof, torch)}
        runs.append(run)
        cs.log(f"[{name}] device {run['device_ms']:.3f} ms (profiled wall "
               f"{wall_ms:.1f} ms); GEMM rows by operand type (ms) "
               f"{ {k: round(v, 3) for k, v in by_type.items()} }; builder "
               f"ranges {run['bias_builder']['ms']:.3f} ms, GEMMs "
               f"{ {k: round(v, 3) for k, v in run['bias_builder']['gemm_ms_by_type'].items()} }")
        for r in run["bias_builder"]["top"]:
            cs.log(f"    {r['ms']:9.3f} ms x{r['count']:<4d} {r['name'][:80]}")

    def mean(name, value):
        vals = [value(r) for r in runs if r["builder"] == name]
        return sum(vals) / len(vals)

    f32 = {n: mean(n, lambda r: r["gemm_ms_by_type"].get("f32", 0.0))
           for n in builders}
    device = {n: mean(n, lambda r: r["device_ms"]) for n in builders}
    share = f32["f32"] - f32["io"]
    summary = {"card": card, "runs": runs, "f32_gemm_ms": f32,
               "device_ms": device, "builder_f32_gemm_ms": share}
    cs.log(f"f32 GEMM rows a step: f32 builder {f32['f32']:.3f} ms, io "
           f"builder {f32['io']:.3f} ms: the builder's share {share:.3f} ms; "
           f"device time {device['f32']:.3f} -> {device['io']:.3f} ms")
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "bias_probe.json"), "w") as f:
        json.dump(summary, f, indent=1)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
