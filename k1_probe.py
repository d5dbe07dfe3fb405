#!/usr/bin/env python3
"""Probe kernel K1 (``svit_tpu_torch/csrc/ln_linear.cu``) on one NVIDIA card.

    python3 k1_probe.py --sweep [--plan-only]
    python3 k1_probe.py --trace

``--sweep``: every K1 call shape of the SViT-B/16 batch-8 forward (and the
masked fc1 / fc2 of the train step), each on random bf16 inputs from a
seed, launched with the plan of ``ops/ln_linear.py:ln_linear_plan`` and
(without ``--plan-only``) with the other block shapes, ring depths and N
splits the kernel takes: device time (``chip_smoke.device_time_ms``), error
against the plain twin, beside the library yardstick and the bound.

``--trace``: a debug build (``-DSVIT_K1_TRACE``) that stamps each block's
phases with ``clock64``; per shape, at the plan's launch, the median
cycles of the prologue, of a tile's products (its N tile's K chunks) and of
its epilogue, and the blocks each SM ran.

Results go to ``chiprun_out/k1_probe_{sweep,trace}.json``.  Without a card
it exits 2.
"""

import ctypes
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def shapes():
    """(label, M, N, K, options) of the K1 calls probed."""
    out = []
    for C, M in ((96, 200704), (192, 50176), (384, 12544), (768, 3136)):
        out += [(f"qkv C{C}", M, 3 * C, C, dict(ln=1, split=C)),
                (f"projection C{C}", M, C, C, dict(rtb=1)),
                (f"fc1 C{C}", M, 4 * C, C, dict(ln=1, gelu=1)),
                (f"fc2 C{C}", M, C, 4 * C, dict(res=1)),
                (f"projection (extras) C{C}", 520, C, C, dict(rtb=1))]
        if C < 768:
            out += [(f"qkv (next stage) C{C}", M, 6 * C, C,
                     dict(ln=1, split=2 * C)),
                    (f"dense C{C}", M, 2 * C, C, dict(ln=1))]
    for C, M in ((192, 100352), (384, 25088), (768, 6272)):
        out += [(f"masked fc1 C{C}", M, 4 * C, C,
                 dict(ln=1, gelu=1, xadd=1, mask=1)),
                (f"masked fc2 C{C}", M, C, 4 * C, dict(res=1, mask=1))]
    out += [("fc1 without GELU C384", 12544, 1536, 384, dict(ln=1)),
            ("fc1 without GELU C768", 3136, 3072, 768, dict(ln=1))]
    return out


def make(torch, M, N, K, o, gen):
    def r(*s, scale=1.0, dt=torch.bfloat16):
        return (scale * torch.randn(s, device="cuda", generator=gen)).to(dt)

    f32 = torch.float32
    args = (r(M, K), r(N, K, scale=K ** -0.5), r(N, scale=0.1, dt=f32))
    kw = {}
    if o.get("ln"):
        kw["ln"] = (1 + r(K, scale=0.1, dt=f32), r(K, scale=0.1, dt=f32))
    if o.get("gelu"):
        kw["gelu"] = True
    if o.get("split"):
        kw["split"] = o["split"]
    if o.get("rtb"):
        kw["round_then_bias"] = True
    if o.get("res"):
        kw["residual"] = r(M, N)
    if o.get("xadd"):
        kw["x_add"] = r(M, K)
    if o.get("mask"):
        rows = 49
        m = (torch.rand(M // rows, device="cuda", generator=gen) > 0.3).float()
        kw["mask_add" if o.get("xadd") else "mask_out"] = m
        kw["keep"], kw["rows"] = 0.6, rows
    return args, kw


def launches(tl, M, N, K, prologue, split, plan_only):
    """The plan's launch first, then every other one the kernel takes."""
    base = tl.ln_linear_plan(M, N, K, prologue=prologue, split=split)
    out = [base]
    if plan_only:
        return out
    kc, n_tiles = -(-K // tl.BK), -(-N // tl.BN)
    for ncw, bm in ((1, 64), (2, 64), (2, 128)):
        for stages in (2, 4, 6):
            if (ncw, bm) == (2, 64) and stages < 4:
                continue
            smem = tl.ln_linear_smem(bm, prologue, kc, stages, ncw)
            if smem > tl.SMEM_BLOCK:
                continue
            for per in sorted({1, n_tiles, base.tiles_per_split}):
                p = tl.Plan(prologue, bm, ncw, stages, -(-n_tiles // per),
                            per, -(-M // bm), n_tiles, smem, 1)
                if p not in out:
                    out.append(p)
    return out


def sweep(torch, cs, tl, plan_only):
    plan_fn = tl.ln_linear_plan
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows = []
    for label, M, N, K, o in shapes():
        args, kw = make(torch, M, N, K, o, gen)
        prologue = "ln" in kw or "x_add" in kw
        res = []
        with torch.inference_mode():
            ref = cs.cat_outputs(tl.ln_linear_reference(*args, **kw)).float()
            lib_ms = cs.device_time_ms(cs.library_call("ln_linear", args, kw), 3)
            for p in launches(tl, M, N, K, prologue, kw.get("split"),
                              plan_only):
                tl.ln_linear_plan = lambda *a, _p=p, **k: _p
                try:
                    y = cs.cat_outputs(tl.ln_linear(*args, **kw)).float()
                    err = float((y - ref).norm() / ref.norm())
                    ms = cs.device_time_ms(lambda: tl.ln_linear(*args, **kw))
                finally:
                    tl.ln_linear_plan = plan_fn
                res.append(dict(ms=ms, err=err, plan=dataclass_dict(p)))
        byts, flops, _ = cs.cost("ln_linear", args, kw)
        bound = max(byts / cs.HBM_BPS, flops / cs.TENSOR_FLOPS) * 1e3
        best = min(res, key=lambda r: r["ms"])
        print(f"{label} [{M}, {K}] -> {N}: plan {desc(res[0]['plan'])} "
              f"ms={res[0]['ms']:.4f} err={res[0]['err']:.1e} | best "
              f"{desc(best['plan'])} ms={best['ms']:.4f} | library_ms="
              f"{lib_ms:.4f} bound_ms={bound:.4f}", flush=True)
        if any(not r["err"] < 1e-2 for r in res):
            raise SystemExit(f"{label}: a launch disagrees with the plain twin")
        rows.append(dict(label=label, M=M, N=N, K=K, library_ms=lib_ms,
                         bound_ms=bound, launches=res))
        del args, kw, ref
        torch.cuda.empty_cache()
    return rows


def dataclass_dict(p):
    return {k: getattr(p, k) for k in p.__dataclass_fields__}


def desc(p):
    return f"ncw{p['ncw']} bm{p['bm']} s{p['stages']} x{p['splits']}"


TRACE_SHAPES = ("qkv C96", "projection C96", "fc1 C96", "fc2 C384",
                "fc1 C384", "fc1 without GELU C384", "qkv C768",
                "fc1 without GELU C768", "fc2 C768")


def trace(torch, cs, tl, _lib):
    lib = _lib.library()
    lib.svit_k1_set_trace.argtypes = [ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    med = lambda v: statistics.median(v) if v else 0.0
    rows = []
    for label, M, N, K, o in shapes():
        if label not in TRACE_SHAPES:
            continue
        args, kw = make(torch, M, N, K, o, gen)
        plan = tl.ln_linear_plan(M, N, K, prologue="ln" in kw,
                                 split=kw.get("split"))
        buf = torch.zeros(plan.blocks * 64, dtype=torch.int64, device="cuda")
        with torch.inference_mode():
            ms = cs.device_time_ms(lambda: tl.ln_linear(*args, **kw))
            torch.cuda.synchronize()
            lib.svit_k1_set_trace(buf.data_ptr())
            tl.ln_linear(*args, **kw)
            torch.cuda.synchronize()
            lib.svit_k1_set_trace(None)
        t = buf.view(plan.blocks, 64).cpu().tolist()
        pro, prod, epi, per_sm = [], [], [], {}
        for b in t:
            pro.append(b[3] - b[2])
            per_sm[b[1]] = per_sm.get(b[1], 0) + 1
            for wg in range(2):
                for j in range(9):
                    start, done, out = b[4 + wg * 30 + 3 * j: 7 + wg * 30 + 3 * j]
                    if not start:
                        break
                    prod.append(done - start)
                    epi.append(out - done)
        kc = -(-K // tl.BK)
        row = dict(label=label, M=M, N=N, K=K, plan=dataclass_dict(plan),
                   ms=ms, prologue_cycles=med(pro), tile_product_cycles=med(prod),
                   chunk_cycles=med(prod) / kc, epilogue_cycles=med(epi),
                   block_cycles=med([b[62] - b[2] for b in t]),
                   blocks_per_sm=[min(per_sm.values()), max(per_sm.values())])
        print(f"{label} [{M}, {K}] -> {N}: plan {desc(row['plan'])} "
              f"ms={ms:.4f}; median cycles: block {row['block_cycles']:.0f}, "
              f"prologue {row['prologue_cycles']:.0f}, a tile's products "
              f"{row['tile_product_cycles']:.0f} ({row['chunk_cycles']:.0f} "
              f"per 64-wide K chunk), its epilogue {row['epilogue_cycles']:.0f}",
              flush=True)
        rows.append(row)
        del args, kw, buf
        torch.cuda.empty_cache()
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 2
    mode = "trace" if "--trace" in sys.argv else "sweep"
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.ops import ln_linear as tl

    if mode == "trace":
        _lib.NVCC_FLAGS.append("-DSVIT_K1_TRACE")
    print(cs.card_line(), flush=True)
    _lib.library()
    if mode == "trace":
        rows = trace(torch, cs, tl, _lib)
    else:
        rows = sweep(torch, cs, tl, "--plan-only" in sys.argv)
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"k1_probe_{mode}.json"), "w") as f:
        json.dump(dict(card=cs.card_line(), rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
