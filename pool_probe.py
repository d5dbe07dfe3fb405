#!/usr/bin/env python3
"""Sweep kernels K2, K3, K6 and K7 (``svit_tpu_torch/csrc/pool.cu``) on
one NVIDIA card.

    python3 pool_probe.py [--sweep | --no-math] [--k3]

Every distinct pool call of the SViT-B/16 forwards (``configs/ssv2.yaml``:
video batch 8 and 1, image batch 8, the train step's 128-frame consistency
forward) as K2 with its LN, and every call of the train step's backward
(video and image batch 8) as K2 in bare mode, as K6 (the input gradient:
K2's bare loop on the flipped filter at stride 1, the parity-class kernel
at strides 2, 4 and 8) and as K7, and every skip pool of the backward
passes as K3's backward (``pool_max_bwd``, on the argmax of its input)
and as K3's forward instance that writes that argmax, and every skip pool
of the forwards as K3's serving instance, on random bf16 inputs from a
seed: each at the launch of ``ops/pool.py:pool_plan`` (K3's backward:
``max_bwd_plan``; K3's forward rows are also timed beside a copy of x, the
bytes the card moves in practice),
checked against its plain twin in f32 (``chip_smoke``'s gate) and timed by
device time (``chip_smoke.device_time_ms``) beside the library yardstick
and the bound (``chip_smoke.cost``).  Then the same four kernels at shapes
beyond the main path's (``WIDE``: head widths 64 and 128, a (3, 5, 5)
kernel, a T stride of 2, strides that differ between H and W), which the
general instance serves; they are left out of the main path's sums.
``--sweep`` also times each main-path call
under other tiles (rows, columns, frames) than the plan's, where its bound
is above 5 us, and each K3 backward call under other tiles (rows, columns,
ring stages) of its tuned instance.  ``--k3`` runs K3's rows alone; K3's
rows are gated bit for bit against the plain twins.  ``--no-math``
leaves K3's forward out (it has no ring) and times a build
(``-DSVIT_POOL_NO_MATH``) whose
kernels run only the tiles' loads and barriers, ungated: what the TMA halo
ring costs alone.  Results go to ``chiprun_out/pool_probe.json`` (or
``pool_probe_no_math.json``).  Without a card it exits 2.
"""

import functools
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FORWARDS = {"video 8": (8, 16), "video 1": (1, 16), "image 8": (8, 1),
            "consistency 128": (128, 1)}
BACKWARD = ("video 8", "image 8")      # the train step's backward passes


def calls():
    """{(kind, input shape, kernel, stride, head_dim): [uses, launches]}:
    K2 ("pool_ln") for every forward's q and k|v pools, K2 bare
    ("pool_conv"), K6 ("pool_conv_dx") and K7 ("pool_conv_dk") for the
    backward's; K3's backward ("pool_max_bwd") and its argmax instance
    ("pool_max_arg") for the backward's skip pools, and its serving
    instance ("pool_max") for every forward's."""
    from svit_tpu_torch.config import get_cfg
    from svit_tpu_torch.models.svit import SViTArch
    from svit_tpu_torch.ops.pooling import out_size

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    arch = SViTArch.from_cfg(cfg)
    out = {}
    for name, (B, frames) in FORWARDS.items():
        size = (arch.patch_dims[0] if frames > 1 else 1, *arch.patch_dims[1:])
        for s in arch.blocks:
            q_shape = tuple(out_size(d, k, st) for d, k, st in
                            zip(size, s.kernel_q, s.stride_q))
            for C, stride in ((s.dim_out, tuple(s.stride_q)),
                              (2 * s.dim_out, tuple(s.stride_kv))):
                kinds = ["pool_ln"] + (
                    ["pool_conv", "pool_conv_dx", "pool_conv_dk"]
                    if name in BACKWARD else [])
                for kind in kinds:
                    row = out.setdefault((kind, (B, *size, C), (3, 3, 3),
                                          stride, 96), [set(), 0])
                    row[0].add(name)
                    row[1] += 1
            if int(np.prod(s.stride_q)) > 1:
                kernel = tuple(k + 1 if k > 1 else k for k in s.stride_q)
                for kind in K3_KINDS:
                    if kind != "pool_max" and name not in BACKWARD:
                        continue
                    out[(kind, (B, *size, s.dim_out), kernel,
                         tuple(s.stride_q), None)] = [{name}, 1]
            size = q_shape
    return out


# (input shape, kernel, stride, head_dim) beyond the main path's, at the
# grids of a batch-8 clip of 8 latent frames
WIDE = [((8, 8, 56, 56, 128), (3, 3, 3), (1, 1, 1), 64),
        ((8, 8, 56, 56, 128), (3, 3, 3), (1, 2, 2), 64),
        ((8, 8, 28, 28, 256), (3, 3, 3), (1, 2, 2), 128),
        ((8, 8, 28, 28, 192), (3, 5, 5), (1, 1, 1), 96),
        ((8, 8, 56, 56, 192), (3, 5, 5), (1, 4, 4), 96),
        ((8, 8, 56, 56, 192), (3, 3, 3), (2, 2, 2), 96),
        ((8, 8, 56, 56, 192), (3, 3, 3), (1, 2, 1), 96)]


def wide_calls():
    """``WIDE`` as K2 (both modes), K6 and, where it takes the stride, K7:
    {(kind, input shape, kernel, stride, head_dim): [{"wide"}, 1]}."""
    from svit_tpu_torch.ops import pool as tp

    return {(kind, shape, kernel, stride, hd): [{"wide"}, 1]
            for shape, kernel, stride, hd in WIDE
            for kind in ("pool_ln", "pool_conv", "pool_conv_dx",
                         "pool_conv_dk")
            if kind != "pool_conv_dk" or tp.dk_takes(shape, kernel, stride)}


PLAN_KIND = {"pool_ln": "pool", "pool_conv": "pool", "pool_conv_dx": "dx",
             "pool_conv_dk": "dk"}
K3_KINDS = ("pool_max_bwd", "pool_max_arg", "pool_max")


def tiles(plan):
    """Other launches of one call for ``--sweep``: rows, columns and frames
    of a tile of base positions (the ring as planned)."""
    To, Wo = plan.axes[0].base, plan.axes[2].base
    chunks = sorted({To, -(-To // 2), -(-To // 4), 1})
    widths = sorted({min(Wo, w) for w in (4, 7, 8, 14, 16)})
    return [dict(rows=r, cols=c, frames=f, ring=plan.ring)
            for r in (1, 2, 3, 4) for c in widths for f in chunks
            if (r, c, f) != (plan.rows, plan.cols, plan.frames)]


def max_bwd_tiles(plan, Wo):
    """Other launches of one K3 backward call for ``--sweep``: rows (consumer
    warps), columns and ring stages of its tuned instance's tile."""
    widths = sorted({min(Wo, w) for w in (4, 7, 8, 14, 16, 28)})
    return [dict(rows=r, cols=c, ring=q) for r in (1, 2, 3, 4, 6, 8)
            for c in widths for q in (2, 3, 4)
            if (r, c, q) != (plan.rows, plan.cols, plan.ring)]


def main():
    import torch

    if not torch.cuda.is_available():
        print("pool_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.ops import pool as tp

    sweep = "--sweep" in sys.argv[1:]
    no_math = "--no-math" in sys.argv[1:]
    k3_only = "--k3" in sys.argv[1:]
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    if no_math:
        _lib.NVCC_FLAGS.append("-DSVIT_POOL_NO_MATH")
    _lib.build()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    sms = _lib.sm_count(torch.device("cuda"))
    plan_fn, max_bwd_plan = tp.pool_plan, tp.max_bwd_plan

    def r(*s, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(s, device="cuda", generator=gen)).to(dtype)

    rows, ok_all = [], True
    todo = {**calls(), **wide_calls()}
    for (kind, shape, kern, stride, hd), (uses, count) in todo.items():
        if (k3_only and kind not in K3_KINDS) or (
                no_math and kind in ("pool_max_arg", "pool_max")):
            continue
        B, T, H, W, C = shape
        To, Ho, Wo = (tp.out_size(d, k, s) for d, k, s in
                      zip((T, H, W), kern, stride))
        x, w = r(*shape), r(C, 1, *kern, scale=0.2, dtype=torch.float32)
        if kind in K3_KINDS:
            rows.append(k3_row(kind, x, kern, stride, uses, count, sweep,
                               no_math, max_bwd_plan, sms, gen))
            ok_all &= rows[-1]["ok"]
            print(json.dumps({k: v for k, v in rows[-1].items()
                              if k != "sweep"}), flush=True)
            continue
        if kind == "pool_ln":
            ls = 1 + r(C, scale=0.1, dtype=torch.float32)
            lb = r(C, scale=0.1, dtype=torch.float32)
            args = (x, w, ls, lb, stride, hd)
            kernel, plain = tp.fused_pool_ln, tp.pool_ln_reference
        elif kind == "pool_conv":
            args = (x, w, stride, hd)
            kernel = tp.depthwise_conv

            def plain(x, w, stride, hd):
                return tp.depthwise_conv_reference(x, w, stride)
        elif kind == "pool_conv_dx":
            args = (r(B, To, Ho, Wo, C), w, stride, shape)
            kernel, plain = tp.depthwise_conv_dx, tp.depthwise_conv_dx_reference
        else:
            args = (x, r(B, To, Ho, Wo, C), kern, stride)
            kernel, plain = tp.depthwise_conv_dk, tp.depthwise_conv_dk_reference
        plan_kw = dict(head_dim=hd if kind == "pool_ln" else None, sms=sms)
        plan = plan_fn(shape, kern, stride, PLAN_KIND[kind], **plan_kw)
        with torch.inference_mode():
            if no_math:                       # nothing computed to gate
                err = err_p = float("nan")
                ok = True
            else:
                y32 = cs.cat_outputs(plain(*cs.to_f32(args)))
                err_p = cs.rel_err(cs.cat_outputs(plain(*args)), y32)
                err = cs.rel_err(cs.cat_outputs(kernel(*args)), y32)
                ok = err <= cs.TOL_RATIO * err_p + cs.TOL_ABS
            ms = cs.device_time_ms(lambda: kernel(*args))
            lib_ms = cs.device_time_ms(cs.library_call(kind, args, {}), 2)
            byts, _, cflops = cs.cost(kind, args, {})
            bound = max(byts / cs.HBM_BPS, cflops / cs.CORE_FLOPS) * 1e3
            row = dict(kind=kind, shape=list(shape), kernel=list(kern),
                       stride=list(stride), head_dim=hd,
                       uses=sorted(uses), launches=count, err=err,
                       plain_err=err_p, ok=ok, ms=ms, library_ms=lib_ms,
                       bound_ms=bound,
                       plan=dict(route=plan.route, rows=plan.rows,
                                 cols=plan.cols,
                                 frames=plan.frames, ring=plan.ring,
                                 grid=plan.grid, smem=plan.smem))
            if sweep and bound > 0.005 and "wide" not in uses:
                row["sweep"] = []
                for over in tiles(plan):
                    try:
                        tp.pool_plan = functools.partial(plan_fn, **over)
                        alt = tp.pool_plan(shape, kern, stride,
                                           PLAN_KIND[kind], **plan_kw)
                        row["sweep"].append(dict(
                            over, grid=alt.grid, smem=alt.smem,
                            ms=cs.device_time_ms(lambda: kernel(*args))))
                    except ValueError:     # no such tile fits
                        pass
                    finally:
                        tp.pool_plan = plan_fn
                best = min(row["sweep"] + [dict(ms=ms)], key=lambda d: d["ms"])
                row["best"] = best
        ok_all &= ok
        print(json.dumps({k: v for k, v in row.items() if k != "sweep"}),
              flush=True)
        rows.append(row)
    total = {}
    for row in rows:
        name = row["kind"] + (" (wide)" if "wide" in row["uses"] else "")
        t = total.setdefault(name, dict(ms=0.0, bound_ms=0.0,
                                        library_ms=0.0))
        for k in t:
            t[k] += row[k] * row["launches"]
    print("summed over the launches of the four forwards (pool_ln, pool_max) "
          "and of the step's backward (pool_conv, pool_conv_dx, pool_conv_dk, "
          "pool_max_bwd, pool_max_arg), and over the WIDE shapes once each: "
          + json.dumps(total), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    name = "pool_probe_no_math.json" if no_math else "pool_probe.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump(dict(card=card, rows=rows, total=total), f, indent=1)
    print(card)
    return 0 if ok_all else 1


def k3_row(kind, x, kern, stride, uses, count, sweep, no_math, plan_fn, sms,
           gen):
    """One K3 call: its backward (``pool_max_bwd``: on the argmax of ``x``,
    timed at the plan and, with ``sweep``, under other tiles), its
    argmax-writing forward (``pool_max_arg``) or its serving forward
    (``pool_max``; a forward also timed beside a copy of ``x``), gated bit
    for bit against the plain twins, beside the bound and the library
    yardstick."""
    import torch

    import chip_smoke as cs
    from svit_tpu_torch.ops import pool as tp

    shape = tuple(x.shape)
    out, arg = tp._pool_max(x, kern, stride, with_arg=True)
    copy_ms = None
    if kind in ("pool_max_arg", "pool_max"):
        args = (x, kern, stride)
        kwargs = {"with_arg": True} if kind == "pool_max_arg" else {}
        kernel, plain = tp._pool_max, cs.pool_max_with_arg_reference
        name, plan = "pool_max", None
    else:
        g = torch.randn(out.shape, device="cuda", generator=gen).to(x.dtype)
        args, kwargs = (g, arg, kern, stride, shape), {}
        kernel, plain = tp.pool_max_bwd, tp.pool_max_backward_reference
        name, plan = kind, plan_fn(shape, kern, stride, sms=sms)
    with torch.inference_mode():
        if no_math:
            ok, err = True, float("nan")
        else:
            got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
            ok = cs.bits_equal(got, want)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = float(max((a.float() - b.float()).abs().max()
                            for a, b in zip(got, want)))
        ms = cs.device_time_ms(lambda: kernel(*args, **kwargs))
        if plan is None:   # a forward: x read once and written once
            copy_ms = cs.device_time_ms(lambda: x.clone())
        lib_ms = cs.device_time_ms(cs.library_call(name, args, kwargs), 2)
    byts, _, cflops = cs.cost(name, args, kwargs)
    bound = max(byts / cs.HBM_BPS, cflops / cs.CORE_FLOPS) * 1e3
    row = dict(kind=kind, shape=list(shape), kernel=list(kern),
               stride=list(stride), head_dim=None, uses=sorted(uses),
               launches=count, bit_equal=ok, max_abs_err=err, ok=ok, ms=ms,
               copy_ms=copy_ms, library_ms=lib_ms, bound_ms=bound, bytes=byts,
               plan=None if plan is None else dict(
                   route=plan.route, rows=plan.rows, cols=plan.cols,
                   ring=plan.ring, grid=plan.grid, smem=plan.smem))
    if sweep and plan is not None and plan.route == "tile":
        row["sweep"] = []
        Wo = out.shape[3]
        for over in max_bwd_tiles(plan, Wo):
            try:
                tp.max_bwd_plan = functools.partial(plan_fn, **over)
                alt = tp.max_bwd_plan(shape, kern, stride, sms=sms)
                with torch.inference_mode():
                    row["sweep"].append(dict(
                        over, grid=alt.grid, smem=alt.smem,
                        ms=cs.device_time_ms(lambda: kernel(*args))))
            except ValueError:     # no such tile fits
                pass
            finally:
                tp.max_bwd_plan = plan_fn
        row["best"] = min(row["sweep"] + [dict(ms=ms)],
                          key=lambda d: d["ms"])
    return row


if __name__ == "__main__":
    sys.exit(main())
