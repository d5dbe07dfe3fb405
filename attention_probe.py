#!/usr/bin/env python3
"""Sweep kernels K4 and K5 (``svit_tpu_torch/csrc/attention.cu``) on one
NVIDIA card.

    python3 attention_probe.py

Every distinct pooled-attention call shape of the SViT-B/16 batch-8 video
forward and the batch-8 image forward (the grid queries with their rel-pos
bias, the extras without), on random bf16 inputs from a seed: K4 and K5 at
the launch of ``ops/attention.py:attention_plan``, each checked against the
plain twin in f32 (``chip_smoke``'s gate) and timed by device time
(``chip_smoke.device_time_ms``) beside the library yardstick and the bound,
and K5 split into its launches by ``torch.profiler``.
Results go to ``chiprun_out/attention_probe.json``.  Without a card it
exits 2.
"""

import json
import math
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def calls(B, frames):
    """(label, B, Nq, k_shape, extras, C, heads, bias) of the distinct K4
    calls of one forward of ``configs/ssv2.yaml``."""
    from svit_tpu_torch.config import get_cfg
    from svit_tpu_torch.models.svit import SViTArch
    from svit_tpu_torch.ops.pooling import out_size

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    arch = SViTArch.from_cfg(cfg)
    size = (arch.patch_dims[0] if frames > 1 else 1, *arch.patch_dims[1:])
    extras = int(arch.cls_embed_on) + frames * arch.num_obj_per_frame
    out = {}
    for s in arch.blocks:
        q_shape = tuple(out_size(d, k, st) for d, k, st in
                        zip(size, s.kernel_q, s.stride_q))
        k_shape = tuple(out_size(d, k, st) for d, k, st in
                        zip(size, s.kernel_kv, s.stride_kv))
        Nk = math.prod(k_shape) + extras
        for what, Nq, bias in (("grid", math.prod(q_shape), True),
                               ("extras", extras, False)):
            label = (f"B{B} {what} Nq {Nq} Nk {Nk} C {s.dim_out} "
                     f"heads {s.num_heads}")
            out.setdefault(label, [label, B, Nq, k_shape, extras, s.dim_out,
                                   s.num_heads, bias, 0])[-1] += 1
        size = q_shape
    return list(out.values())


def launch_split(torch, kernel, args):
    """Device ms of each of K5's launches (query side, key side, reduce) in
    one call, from a profile of three calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kernel(*args)
        torch.cuda.synchronize()
    return {e.key.split("<")[0].split("::")[-1]:
            getattr(e, "self_device_time_total", 0) / 3e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main():
    import torch

    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.ops import attention as ta

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.build()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    sms = _lib.sm_count(torch.device("cuda"))

    def r(*s, scale=1.0):
        return (scale * torch.randn(s, device="cuda", generator=gen)).to(
            torch.bfloat16)

    rows = []
    for label, B, Nq, k_shape, E, C, heads, bias, count in (
            calls(8, 16) + calls(8, 1)):
        hd = C // heads
        Nk = math.prod(k_shape) + E
        q, kv, do = r(B, Nq, C), r(B, Nk, 2 * C), r(B, Nq, C)
        b = r(B, heads, Nq, sum(k_shape), scale=0.5) if bias else None
        R = sum(k_shape) if bias else 0
        args = (q, kv, b, k_shape, hd ** -0.5, heads, True)
        row = dict(label=label, count=count)
        for kind, backward in (("fwd", False), ("bwd", True)):
            name = "pooled_attention_bwd" if backward else "pooled_attention"
            a = args[:3] + (do,) + args[3:] if backward else args
            kernel = ta.pooled_attention_bwd if backward else \
                ta.pooled_attention_fwd
            plain = (ta.pooled_attention_bwd_reference if backward
                     else ta.pooled_attention_reference)
            plan = ta.attention_plan(B, Nq, Nk, C, heads, R,
                                     backward=backward, sms=sms)
            with torch.inference_mode():
                y32 = cs.cat_outputs(plain(*cs.to_f32(a)))
                err_p = cs.rel_err(cs.cat_outputs(plain(*a)), y32)
                err = cs.rel_err(cs.cat_outputs(kernel(*a)), y32)
                row[kind] = dict(
                    ms=cs.device_time_ms(lambda: kernel(*a)), err=err,
                    ok=err <= cs.TOL_RATIO * err_p + cs.TOL_ABS,
                    stages=plan.stages, splits=plan.splits,
                    kv_stages=plan.kv_stages)
                if backward:
                    row["bwd_launches_ms"] = launch_split(torch, kernel, a)
            with torch.enable_grad():
                row[f"{kind}_library_ms"] = cs.device_time_ms(
                    cs.library_call(name, a, {}), 2)
            byts, tflops, _ = cs.cost(name, a, {})
            row[f"{kind}_bound_ms"] = max(byts / cs.HBM_BPS,
                                          tflops / cs.TENSOR_FLOPS) * 1e3
        print(json.dumps(row), flush=True)
        rows.append(row)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "attention_probe.json"),
              "w") as f:
        json.dump(dict(card=card, rows=rows), f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
