#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``svit_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the hand-written kernels of ``svit_tpu_torch/csrc`` (nvcc, sm_90a)
   and the seconds it took;
3. model: the SViT-B/16 serving forward (``configs/ssv2.yaml``: 16 frames at
   224 px, 16 blocks, bf16) at batch 8 with random weights from a seed, run
   three ways: kernels in bf16, plain PyTorch in bf16, plain in f32 (TF32
   off).  The kernel run's outputs must pass
   ``err(kernels) <= 3 * err(plain bf16) + 2e-3`` (relative L2 error against
   the f32 run) on the logits and the boxes, and every kernel's launch count
   over that one forward must equal what the architecture implies;
4. kernels: every distinct call the kernel forward made to a kernel wrapper
   is replayed on the same tensors: the kernel against its plain version in
   bf16 and in f32 (same gate), and timed (device time, queued behind a
   sleep kernel: ``device_time_ms``) beside the plain version, one PyTorch
   library yardstick and the card's bound; the per-forward totals are
   printed per kernel and
   per JAX function served.  4b: ``fused_ffn`` (off the model path) is
   replayed the same way at the MLP shapes of stage 0 and stage 3;
5. forward time and clips/s at batch 8 and batch 1, and one profiled
   forward at each: device time by kernel, the hand-written kernels' share
   and the device's idle share of the wall time;
6. serving: ``make_server`` (what ``serve()`` runs) on localhost, GET
   /healthz and three concurrent POST /predict of 16 JPEG frames;
7. train: the fused train step (``engine/steps.py``) of the same model at
   full size with ``SVIT.CONSISTENCY_LOSS = "l1"``: video batch 8, image
   batch 8 and the 128-frame consistency forward, drop-path 0.4 and head
   dropout 0.5 on, built from seed 0 as ``bench.py`` builds its train batch.
   Three models from the same seed (kernels in bf16, plain in bf16, plain
   in f32 with TF32 off) take one step each on the same batch and the same
   masks (one generator seed, one draw order); the loss and the global
   gradient vector must pass the gate above, and the worst leaf by excess
   is printed.  The kernel step's launch counts must equal what the
   architecture implies; every distinct call of the backward kernels (K5,
   K6, K7), K2's bare mode, K1's masked mode and K4 is replayed against
   its plain version, timed beside its bound and a library yardstick, and
   so is every K2 call of the step's three forwards (the ``pool_ln (train
   step)`` row).  Then
   five timed steps of the kernel model: median step time, clips/s, peak
   memory, a profiled step's device time by kernel and idle share (with its
   GEMM rows by operand type, and the operand types of every product of
   the LN-linear backward), a finite loss and parameters that move.

8. test: a synthetic SSv2 tree in a temp dir (4 videos of 24 JPEG frames
   at 427 x 240, written through PIL from seed 0), then at
   ``configs/ssv2.yaml``'s full size: one timed and one profiled batch-64
   forward; ``engine.test.test(cfg)`` (10 views x 3 crops, 120 clips) for
   kernels in bf16 at the config's batch of 64, and the plain versions in
   bf16 and f32 at batch 16, the video-level scores gated as above, each
   run's top-1 and top-5, the kernel run's launches against the forward's
   per batch, its test loop's clips/s; ``make_eval_step`` with the loss
   (consistency l1: a 128-frame frames forward) on a val batch of 8 from
   the tree and ``make_image_eval_step`` on phase 7's image batch, the
   losses gated, the top-k verdicts of kernels and plain f32 compared
   (a row may differ only within bf16's resolution), the launches
   counted; and a two-block model whose first block has no k|v pool at 16
   x 224 (key grid 8 x 56 x 56, kT + kH + kW = 120) forward and backward
   through K4 and K5's wide instance, gated.

It prints the ``{"kernels": [...]}`` line (``launches`` of the forward
kernels count the serving forward, those of the train step's new kernels
and modes, and of K2's and K4's train-step rows, the train step;
``train_launches`` counts the train step for all, ``test_launches`` one
batch-64 test forward; K1, K4 and K5 carry their uses), the card's name
and power limit, and last
``{"ok": true, "device": {...}}``.  Per-call details go to
``chiprun_out/chip_smoke_detail.json``.  Without a card it exits 2.
"""

import base64
import collections
import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "configs", "ssv2.yaml")
BATCH = 8
TRAIN_VIDEO, TRAIN_IMAGE = 8, 8          # bench.py:43-44, per card
SEED = 0
TOL_RATIO, TOL_ABS = 3.0, 2e-3
# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core flop/s,
# f32 flop/s outside the tensor cores
HBM_BPS, TENSOR_FLOPS, CORE_FLOPS = 3.35e12, 989e12, 67e12

KERNELS = {  # counter name -> (source, TPU kernels it replaces)
    "ln_linear": ("svit_tpu_torch/csrc/ln_linear.cu",
                  "svit_tpu/ops/pallas_ffn.py:205 _ln_qkv_kernel; "
                  "svit_tpu/ops/pallas_ffn.py:153 _ln_dense_kernel; "
                  "svit_tpu/ops/pallas_ffn.py:322 _ffn_res_kernel; "
                  "svit_tpu/ops/pallas_ffn.py:66 _ffn_kernel (fused_ffn "
                  ":500, off the model path: replayed)"),
    "pool_ln": ("svit_tpu_torch/csrc/pool.cu",
                "svit_tpu/ops/pallas_pool.py:175 _kernel_s1; "
                "svit_tpu/ops/pallas_pool.py:250 _kernel_strided"),
    "pool_max": ("svit_tpu_torch/csrc/pool.cu",
                 "svit_tpu/ops/pallas_pool.py:695 _kernel_strided_max"),
    "pooled_attention": ("svit_tpu_torch/csrc/attention.cu",
                         "svit_tpu/ops/pallas_attention.py:167 _attn_kernel"),
}
# fused_ffn's replay: [M, C] -> 4C -> C, the MLP of stage 0 and of stage 3
# of the batch-8 forward
FFN_SHAPES = ((200704, 96), (3136, 768))
TRAIN_K4 = "pooled_attention (train step)"
TRAIN_K2 = "pool_ln (train step)"
TRAIN_KERNELS = {  # the train step's new kernels and modes, and K4
    "ln_linear_masked": ("svit_tpu_torch/csrc/ln_linear.cu",
                         "svit_tpu/ops/pallas_ffn.py:322 _ffn_res_kernel "
                         "(masked, fused_ffn_residual_masked :469)"),
    "pool_conv": ("svit_tpu_torch/csrc/pool.cu",
                  "svit_tpu/ops/pallas_pool.py:175 _kernel_s1; "
                  "svit_tpu/ops/pallas_pool.py:250 _kernel_strided "
                  "(apply_ln=False, pallas_depthwise_conv :1095)"),
    "pool_conv_dx": ("svit_tpu_torch/csrc/pool.cu",
                     "svit_tpu/ops/pallas_pool.py:175 _kernel_s1; "
                     "svit_tpu/ops/pallas_pool.py:250 _kernel_strided (dx "
                     "of _pdc_bwd :1115: the zero-stuffed cotangent, "
                     "flipped filter)"),
    "pool_conv_dk": ("svit_tpu_torch/csrc/pool.cu",
                     "svit_tpu/ops/pallas_pool.py:898 _kernel_dk_s1; "
                     "svit_tpu/ops/pallas_pool.py:935 _kernel_dk_strided"),
    "pooled_attention_bwd": ("svit_tpu_torch/csrc/attention.cu",
                             "svit_tpu/ops/pallas_attention.py:317 "
                             "_attn_bwd_kernel"),
    TRAIN_K4: ("svit_tpu_torch/csrc/attention.cu",
               "svit_tpu/ops/pallas_attention.py:167 _attn_kernel (the "
               "train step's three forwards)"),
    TRAIN_K2: ("svit_tpu_torch/csrc/pool.cu",
               "svit_tpu/ops/pallas_pool.py:175 _kernel_s1; "
               "svit_tpu/ops/pallas_pool.py:250 _kernel_strided (the train "
               "step's three forwards)"),
}
# a kernel table row -> the launch counter it reads
COUNTER = {TRAIN_K4: "pooled_attention", TRAIN_K2: "pool_ln"}
# a recorded call's name -> the kernel whose cost and yardstick it takes
KIND = {"ln_linear_masked": "ln_linear", TRAIN_K4: "pooled_attention",
        TRAIN_K2: "pool_ln"}


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def rel_err(a, b):
    a = a.double().flatten()
    b = b.double().flatten()
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def flat_outputs(out):
    import torch

    if torch.is_tensor(out):
        return [out]
    return [t for o in out if o is not None for t in flat_outputs(o)]


def cat_outputs(out):
    import torch

    return torch.cat([t.float().flatten() for t in flat_outputs(out)])


def to_f32(obj):
    import torch

    if torch.is_tensor(obj):
        return obj.float() if obj.dtype == torch.bfloat16 else obj
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_f32(o) for o in obj)
    if isinstance(obj, dict):
        return {k: to_f32(v) for k, v in obj.items()}
    return obj


def signature(obj):
    import torch

    if torch.is_tensor(obj):
        return ("T", tuple(obj.shape), str(obj.dtype))
    if isinstance(obj, (tuple, list)):
        return tuple(signature(o) for o in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, signature(v)) for k, v in obj.items()))
    return obj


def device_time_ms(fn, reps=5):
    """Device time of one call of ``fn`` in milliseconds.  On the card's
    host, Python paces the smaller calls: an event window around calls
    issued back to back would time the host.  So a sleep kernel first holds
    the stream for longer than the host takes to issue ``reps`` calls; the
    calls queue behind it, then run back to back between the two events."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0           # the host's time for one call
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(0.5, 2 * reps * one + 2e-3) * 2e9))  # cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Wraps the kernel wrappers for one forward: keeps the first call of
    each distinct signature (its tensors, by reference) and a count."""

    def __init__(self):
        self.calls = collections.OrderedDict()

    def wrap(self, name, fn):
        """``name`` is the counter, or a function of the call's arguments
        that gives it (None: not recorded)."""
        def recorded(*args, **kwargs):
            n = name(args, kwargs) if callable(name) else name
            if n is not None:
                key = (n, signature(args), signature(kwargs))
                if key in self.calls:
                    self.calls[key]["count"] += 1
                else:
                    self.calls[key] = dict(name=n, args=args, kwargs=kwargs,
                                           count=1)
            return fn(*args, **kwargs)

        return recorded

    def patch(self, table):
        """Wrap every ``(module, attribute, name)`` of ``table``; returns
        the originals for ``restore``."""
        originals = []
        for mod, attr, name in table:
            originals.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, self.wrap(name, getattr(mod, attr)))
        return originals

    @staticmethod
    def restore(originals):
        for mod, attr, fn in reversed(originals):
            setattr(mod, attr, fn)


def wrappers():
    """counter name -> (module, attribute, plain twin)."""
    from svit_tpu_torch.ops import attention as attn_ops
    from svit_tpu_torch.ops import ln_linear as ll
    from svit_tpu_torch.ops import pool

    return {
        "ln_linear": (ll, "ln_linear", ll.ln_linear_reference),
        "pool_ln": (pool, "fused_pool_ln", pool.pool_ln_reference),
        "pool_max": (pool, "fused_pool_max", pool.pool_max_reference),
        "pooled_attention": (attn_ops, "pooled_attention_fwd",
                             attn_ops.pooled_attention_reference),
    }


def _masked(args, kwargs):
    masked = (kwargs.get("mask_add") is not None
              or kwargs.get("mask_out") is not None)
    return "ln_linear_masked" if masked else None


def train_wrappers():
    """The train step's new kernels: counter name -> (module, attribute,
    plain twin with the kernel's signature, recorder name)."""
    from svit_tpu_torch.ops import attention as attn_ops
    from svit_tpu_torch.ops import ln_linear as ll
    from svit_tpu_torch.ops import pool

    return {
        "ln_linear_masked": (ll, "ln_linear", ll.ln_linear_reference,
                             _masked),
        "pool_conv": (pool, "depthwise_conv",
                      lambda x, w, stride, hd: pool.depthwise_conv_reference(
                          x, w, stride), "pool_conv"),
        "pool_conv_dx": (pool, "depthwise_conv_dx",
                         pool.depthwise_conv_dx_reference, "pool_conv_dx"),
        "pool_conv_dk": (pool, "depthwise_conv_dk",
                         pool.depthwise_conv_dk_reference, "pool_conv_dk"),
        "pooled_attention_bwd": (attn_ops, "pooled_attention_bwd",
                                 attn_ops.pooled_attention_bwd_reference,
                                 "pooled_attention_bwd"),
        TRAIN_K4: (attn_ops, "pooled_attention_fwd",
                   attn_ops.pooled_attention_reference, TRAIN_K4),
        TRAIN_K2: (pool, "fused_pool_ln", pool.pool_ln_reference, TRAIN_K2),
    }


def touched(D, k, s):
    """Input positions along one axis that some window of a pool (kernel
    ``k``, stride ``s``, padding k//2) reads."""
    out = (D + 2 * (k // 2) - k) // s + 1
    return len({o * s - k // 2 + d for o in range(out) for d in range(k)}
               & set(range(D)))


def window_bytes(x, kernel, stride):
    """Bytes of ``x`` [B, T, H, W, C] at the positions some window reads.
    At stride <= kernel that is all of ``x``; at stride (1, 4, 4) with
    kernel 3 the windows read 9/16 of the positions, at (1, 8, 8) 9/64.
    Each position is C contiguous values (at least 192 bytes), so a kernel
    can read only those rows: the bound counts no more."""
    B, T, H, W, C = x.shape
    return B * C * x.element_size() * math.prod(
        touched(d, k, s) for d, k, s in zip((T, H, W), kernel, stride))


def cost(name, args, kwargs):
    """(bytes the call must move, tensor-core flops, CUDA-core flops)."""

    def nb(t):
        return 0 if t is None else t.numel() * t.element_size()

    if name in ("pool_conv", "pool_conv_dx", "pool_conv_dk"):
        # the taps of a depthwise conv: one multiply-add per (output
        # element, tap) in f32 on the CUDA cores
        if name == "pool_conv":
            x, w, stride, _ = args
            B, T, H, W, C = x.shape
            g_numel = B * C * math.prod(
                (d + 2 * (k // 2) - k) // s + 1
                for d, k, s in zip((T, H, W), w.shape[2:], stride))
            byts = window_bytes(x, w.shape[2:], stride) + nb(w) + 2 * g_numel
            taps = math.prod(w.shape[2:])
        elif name == "pool_conv_dx":
            g, w, stride, in_shape = args
            g_numel, taps = g.numel(), math.prod(w.shape[2:])
            byts = nb(g) + nb(w) + 2 * math.prod(in_shape)
        else:
            x, g, kernel, stride = args
            g_numel, taps = g.numel(), math.prod(kernel)
            byts = (window_bytes(x, kernel, stride) + nb(g)
                    + 4 * taps * x.shape[-1])
        return byts, 0.0, 2.0 * taps * g_numel
    if name == "pooled_attention_bwd":
        # five Nq x Nk x head_dim products per head: S, dP, dq, dK, dV
        q, kv, bias_src, do = args[:4]
        B, Nq, C = q.shape
        Nk = kv.shape[1]
        byts = 2 * (nb(q) + nb(kv) + nb(bias_src)) + nb(do)
        return byts, 10.0 * B * Nq * Nk * C, 0.0
    name = KIND.get(name, name)
    if name == "ln_linear":
        x, w = args[0], args[1]
        bias = args[2] if len(args) > 2 else kwargs.get("bias")
        M, K = x.shape
        N = w.shape[0]
        ln = kwargs.get("ln")
        x_add, res = kwargs.get("x_add"), kwargs.get("residual")
        byts = nb(x) + nb(w) + nb(bias) + 2 * M * N
        byts += (nb(ln[0]) + nb(ln[1])) if ln else 0
        byts += 2 * nb(x_add) + nb(res)      # x_add read, the sum written
        return byts, 2.0 * M * N * K, 0.0
    if name == "pool_ln":
        x, w, ls, lb, stride, hd = args
        B, T, H, W, C = x.shape
        taps = math.prod(w.shape[2:])
        out = B * C * math.prod(
            (d + 2 * (k // 2) - k) // s + 1
            for d, k, s in zip((T, H, W), w.shape[2:], stride))
        return (window_bytes(x, w.shape[2:], stride) + nb(w) + nb(ls)
                + nb(lb) + 2 * out, 0.0, out * (2.0 * taps + 8))
    if name == "pool_max":
        x, kernel, stride = args
        B, T, H, W, C = x.shape
        out = B * C * math.prod(
            (d + 2 * (k // 2) - k) // s + 1
            for d, k, s in zip((T, H, W), kernel, stride))
        return nb(x) + 2 * out, 0.0, float(out * math.prod(kernel))
    if name == "pooled_attention":
        q, kv, bias_src, k_shape, scale, heads = args[:6]
        B, Nq, C = q.shape
        Nk = kv.shape[1]
        return (nb(q) + nb(kv) + nb(bias_src) + nb(q),
                4.0 * B * Nq * Nk * C, 0.0)
    raise KeyError(name)


def library_call(name, args, kwargs):
    """One PyTorch library computation of the same function (a yardstick;
    the port never calls it)."""
    import torch
    import torch.nn.functional as F

    if name in ("pool_conv", "pool_conv_dx", "pool_conv_dk"):
        # cuDNN's grouped conv3d and its two gradients, channels-last
        cf = (lambda t: t.permute(0, 4, 1, 2, 3))
        if name == "pool_conv":
            x, w, stride, _ = args
            wb = w.to(x.dtype)
            pad = tuple(k // 2 for k in w.shape[2:])
            return lambda: F.conv3d(cf(x), wb, None, stride, pad,
                                    groups=x.shape[-1])
        if name == "pool_conv_dx":
            g, w, stride, in_shape = args
            B, T, H, W, C = in_shape
            wb = w.to(g.dtype)
            pad = tuple(k // 2 for k in w.shape[2:])
            return lambda: torch.nn.grad.conv3d_input(
                (B, C, T, H, W), wb, cf(g), stride, pad, groups=C)
        x, g, kernel, stride = args
        C = x.shape[-1]
        pad = tuple(k // 2 for k in kernel)
        return lambda: torch.nn.grad.conv3d_weight(
            cf(x), (C, 1, *kernel), cf(g), stride, pad, groups=C)
    if name == "pooled_attention_bwd":
        from svit_tpu_torch.ops.attention import _gather_bias

        q, kv, bias_src, do, k_shape, scale, heads = args[:7]
        B, Nq, C = q.shape
        Nk = kv.shape[1]
        hd = C // heads

        def leaf(t):
            return t.view(B, t.shape[1], heads, hd).transpose(1, 2).detach(
                ).requires_grad_()

        qh, kh, vh = leaf(q), leaf(kv[..., :C]), leaf(kv[..., C:])
        doh = do.view(B, Nq, heads, hd).transpose(1, 2)
        mask = (None if bias_src is None
                else _gather_bias(bias_src, k_shape, Nk).to(q.dtype))
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                             scale=scale)
        return lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                           retain_graph=True)
    name = KIND.get(name, name)
    if name == "ln_linear":
        x, w = args[0], args[1]
        bias = args[2] if len(args) > 2 else kwargs.get("bias")
        ln, x_add = kwargs.get("ln"), kwargs.get("x_add")
        res, gelu = kwargs.get("residual"), kwargs.get("gelu", False)
        dt, K = x.dtype, x.shape[1]
        b = None if bias is None else bias.to(dt)
        lw = None if ln is None else (ln[0].to(dt), ln[1].to(dt))

        def fn():
            s = x if x_add is None else x + x_add
            if lw is not None:
                s = F.layer_norm(s, (K,), lw[0], lw[1], 1e-6)
            y = F.linear(s, w, b)
            if gelu:
                y = F.gelu(y)
            return y if res is None else y + res
        return fn
    if name == "pool_ln":
        x, w, ls, lb, stride, hd = args
        C = x.shape[-1]
        wb = w.to(x.dtype)
        pad = tuple(k // 2 for k in w.shape[2:])
        g = (ls if ls.numel() == C else ls.repeat(C // hd)).to(x.dtype)
        bb = (lb if lb.numel() == C else lb.repeat(C // hd)).to(x.dtype)

        def fn():
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), wb, None, stride, pad,
                         groups=C).permute(0, 2, 3, 4, 1)
            y = F.layer_norm(y.reshape(*y.shape[:4], C // hd, hd), (hd,),
                             eps=1e-6)
            return y.reshape(*y.shape[:4], C) * g + bb
        return fn
    if name == "pool_max":
        x, kernel, stride = args
        pad = tuple(k // 2 for k in kernel)
        return lambda: F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel, stride,
                                    pad)
    if name == "pooled_attention":
        from svit_tpu_torch.ops.attention import _gather_bias

        q, kv, bias_src, k_shape, scale, heads = args[:6]
        B, Nq, C = q.shape
        Nk = kv.shape[1]
        hd = C // heads

        def heads_first(t):
            return t.view(B, t.shape[1], heads, hd).transpose(1, 2)

        qh, kh, vh = heads_first(q), heads_first(kv[..., :C]), \
            heads_first(kv[..., C:])
        mask = (None if bias_src is None
                else _gather_bias(bias_src, k_shape, Nk).to(q.dtype))
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=scale)
    raise KeyError(name)


def use_of(name, args, kwargs):
    """The JAX package's fused function that a recorded call stands for."""
    if name == "ln_linear_masked":
        return ("fused_ffn_residual_masked (fc1)"
                if kwargs.get("x_add") is not None
                else "fused_ffn_residual_masked (fc2)")
    if name in ("pooled_attention_bwd", "pooled_attention", TRAIN_K4):
        what = ("pooled_attention_bwd" if name == "pooled_attention_bwd"
                else "fused_attention_proj")
        rows = "grid" if args[2] is not None else "extras"
        return f"{what} ({rows} queries, Nk {args[1].shape[1]})"
    if name in ("pool_conv", "pool_conv_dx", "pool_conv_dk"):
        stride = tuple(args[2]) if name != "pool_conv_dk" else tuple(args[3])
        what = {"pool_conv": "pallas_depthwise_conv (recompute)",
                "pool_conv_dx": "_pdc_bwd dx", "pool_conv_dk": "_dk_pallas"}
        return f"{what[name]} stride {stride}"
    if name == "ln_linear":
        if kwargs.get("split") is not None:
            return "fused_ln_qkv"
        if kwargs.get("x_add") is not None:
            return "fused_ffn_residual (fc1)"
        if kwargs.get("residual") is not None:
            return "fused_ffn_residual (fc2)"
        if kwargs.get("round_then_bias"):
            return "fused_attention_proj (projection)"
        return "fused_ln_dense"
    if name in ("pool_ln", TRAIN_K2):
        return f"fused_pool_ln stride {tuple(args[4])}"
    return "fused_pool_max"


def expected_launches(arch):
    n = collections.Counter()
    for s in arch.blocks:
        n["ln_linear"] += 5 + (s.dim != s.dim_out)
        n["pool_ln"] += 2
        n["pooled_attention"] += 2
        n["pool_max"] += int(np.prod(s.stride_q)) > 1
    return n


def run_model_phase(model, arch, torch):
    """Phase 3: the three forwards, the gate and the launch counts.
    Returns the recorded kernel calls."""
    from svit_tpu_torch.ops import _lib

    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((BATCH, arch.num_frames, arch.crop_size, arch.crop_size, 3),
                    generator=gen).cuda()
    rec = Recorder()
    originals = rec.patch((mod, attr, name)
                          for name, (mod, attr, _) in wrappers().items())
    try:
        model.dtype, model.use_kernels = torch.bfloat16, True
        _lib.reset_launch_counts()
        with torch.inference_mode():
            _, ek = model(x)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
    finally:
        Recorder.restore(originals)
    with torch.inference_mode():
        model.use_kernels = False
        _, e16 = model(x)
        model.dtype = torch.float32
        _, e32 = model(x)
    torch.cuda.synchronize()
    model.dtype, model.use_kernels = torch.bfloat16, True

    result = {"launches": launches}
    for key in ("raw_logits", "pred_bboxes"):
        ek_, e16_, e32_ = ek[key].float(), e16[key].float(), e32[key].float()
        if not bool(torch.isfinite(ek_).all()):
            raise SystemExit(f"model gate: non-finite {key}")
        err_k, err_p = rel_err(ek_, e32_), rel_err(e16_, e32_)
        ok = err_k <= TOL_RATIO * err_p + TOL_ABS
        log(f"model gate {key}: err(kernels)={err_k:.3e} "
            f"err(plain bf16)={err_p:.3e} shape={tuple(ek_.shape)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"model gate failed on {key}")
        result[key] = {"err_kernels": err_k, "err_plain_bf16": err_p}
    want = expected_launches(arch)
    log(f"launches in one forward: {launches} (expected {dict(want)})")
    if launches != dict(want):
        raise SystemExit("kernel launch counts differ from the forward's")
    return rec, result


def expected_train_launches(arch, forwards=3, backwards=2):
    """Launches of one train step: three train-mode forwards (the
    consistency frames, the video, the image) and two backward passes.  A
    block with a drop-path rate runs its residual tail in K1's masked mode;
    each fused_pool_ln backward runs K2 bare, K6 and K7, each attention
    backward K5.  With a cls token the head reads only the extras, so the
    last block's grid output feeds nothing: its grid attention and its q
    pool take no backward."""
    n = collections.Counter()
    for i, s in enumerate(arch.blocks):
        masked = 2 * (s.drop_path > 0)
        n["ln_linear"] += forwards * (5 + (s.dim != s.dim_out) - masked)
        n["ln_linear_masked"] += forwards * masked
        n["pool_ln"] += forwards * 2
        n["pooled_attention"] += forwards * 2
        n["pool_max"] += forwards * (int(np.prod(s.stride_q)) > 1)
        dead = int(arch.cls_embed_on and i == len(arch.blocks) - 1)
        for k in ("pool_conv", "pool_conv_dx", "pool_conv_dk",
                  "pooled_attention_bwd"):
            n[k] += backwards * (2 - dead)
    return n


def train_batch(cfg, torch):
    """The train batch of bench.py:171-192, from seed 0, on the card."""
    S, T = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES
    rs = np.random.RandomState(SEED)
    video = {
        "clips": rs.randn(TRAIN_VIDEO, T, S, S, 3).astype(np.float32),
        "labels": rs.randint(0, cfg.MODEL.NUM_CLASSES, TRAIN_VIDEO),
        "weight": np.ones((TRAIN_VIDEO,), np.float32),
    }
    image = {
        "frames": rs.randn(TRAIN_IMAGE, 1, S, S, 3).astype(np.float32),
        "haog_bboxes": (rs.rand(TRAIN_IMAGE, 1, cfg.SVIT.O, 4) * 0.5
                        + 0.1).astype(np.float32),
        "contact_state": rs.randint(-1, 5, (TRAIN_IMAGE, 2)),
        "weight": np.ones((TRAIN_IMAGE,), np.float32),
    }
    return ({k: torch.as_tensor(v).cuda() for k, v in video.items()},
            {k: torch.as_tensor(v).cuda() for k, v in image.items()})


def train_setup(cfg, torch, dtype, use_kernels):
    from svit_tpu_torch.engine import steps
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.models.optimizer import construct_optimizer

    model, arch = build_model(cfg, dtype=dtype, use_kernels=use_kernels,
                              train=True)
    state = steps.create_train_state(
        model, construct_optimizer(cfg, model, steps_per_epoch=1000)[0])
    step = steps.make_train_step(
        model, get_loss_func(cfg), state.tx, video_weight=7 / 8,
        image_weight=1 / 8, with_image=True, with_consistency=True)
    return state, step, arch


def raw_grads(state, metrics):
    """The step's gradients before the clip, by parameter name (the clip
    scaled them in place by max / norm when the norm reached max)."""
    clip = state.tx.clip_l2norm
    norm = float(metrics["grad_norm"])
    undo = norm / clip if clip and norm >= clip else 1.0
    return {n: p.grad.float() * undo
            for n, p in state.model.named_parameters()}


def run_train_phase(cfg, torch):
    """Phase 7.  Returns its results and the kernel step's launch counts."""
    from svit_tpu_torch.ops import _lib

    video, image = train_batch(cfg, torch)
    result, grads, losses = {}, {}, {}
    rec = Recorder()
    for name, dtype, kernels in (("kernels", torch.bfloat16, True),
                                 ("plain_bf16", torch.bfloat16, False),
                                 ("plain_f32", torch.float32, False)):
        state, step, arch = train_setup(cfg, torch, dtype, kernels)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        originals = []
        if kernels:
            originals = rec.patch((mod, attr, rname) for mod, attr, _, rname
                                  in train_wrappers().values())
        try:
            torch.cuda.synchronize()
            _lib.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, video, image, gen)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = dict(_lib.LAUNCHES)
        finally:
            Recorder.restore(originals)
        losses[name] = {k: float(v) for k, v in metrics.items()}
        grads[name] = raw_grads(state, metrics)
        log(f"train step [{name}]: loss {losses[name]['loss']:.6f} "
            f"grad_norm {losses[name]['grad_norm']:.4f} first step "
            f"{first_s:.2f} s")
        if kernels:
            kernel_state, kernel_step = state, step
            result["launches"] = launches
            result["metrics"] = losses[name]
        else:
            del state, step
        torch.cuda.empty_cache()

    # the gate: the loss and the global gradient vector against f32
    for key in ("loss",):
        vk, v16, v32 = (torch.tensor(losses[n][key], dtype=torch.float64)
                        for n in ("kernels", "plain_bf16", "plain_f32"))
        err_k, err_p = rel_err(vk, v32), rel_err(v16, v32)
        ok = err_k <= TOL_RATIO * err_p + TOL_ABS
        log(f"train gate {key}: err(kernels)={err_k:.3e} "
            f"err(plain bf16)={err_p:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"train gate failed on {key}")
        result[f"gate_{key}"] = {"err_kernels": err_k, "err_plain_bf16": err_p}
    names = list(grads["plain_f32"])
    flat = {n: torch.cat([g[k].flatten() for k in names])
            for n, g in grads.items()}
    err_k = rel_err(flat["kernels"], flat["plain_f32"])
    err_p = rel_err(flat["plain_bf16"], flat["plain_f32"])
    ok = err_k <= TOL_RATIO * err_p + TOL_ABS
    log(f"train gate grads_global: err(kernels)={err_k:.3e} "
        f"err(plain bf16)={err_p:.3e} {'ok' if ok else 'FAIL'}")
    # a leaf whose f32 gradient is below 1e-4 of the global norm (the k LN
    # bias: softmax ignores a per-row constant, so its true gradient is 0)
    # holds rounding noise, and its relative error says nothing
    floor = 1e-4 * float(flat["plain_f32"].norm())
    noise = [k for k in names if float(grads["plain_f32"][k].norm()) < floor]
    worst = (0.0, None, 0.0, 0.0, 0.0)
    for k in names:
        if k in noise:
            continue
        e_k = rel_err(grads["kernels"][k], grads["plain_f32"][k])
        e_p = rel_err(grads["plain_bf16"][k], grads["plain_f32"][k])
        if e_k - e_p > worst[0]:
            worst = (e_k - e_p, k, e_k, e_p,
                     float(grads["plain_f32"][k].norm()))
    log(f"train worst leaf by excess: {worst[1]} excess={worst[0]:.3e} "
        f"err(kernels)={worst[2]:.3e} err(plain bf16)={worst[3]:.3e} "
        f"f32 grad norm={worst[4]:.3e} ({len(noise)} leaves under "
        f"{floor:.2e} skipped as noise)")
    result["gate_grads_global"] = {"err_kernels": err_k, "err_plain_bf16": err_p}
    result["worst_leaf"] = dict(zip(
        ("excess", "name", "err_kernels", "err_plain_bf16", "f32_norm"), worst))
    if not ok:
        raise SystemExit("train gate failed on the global gradient")
    del grads, flat

    want = dict(expected_train_launches(arch))
    log(f"launches in one train step: {result['launches']} (expected {want})")
    if result["launches"] != want:
        raise SystemExit("train step launch counts differ from the step's")

    fns = {n: (getattr(mod, attr), plain)
           for n, (mod, attr, plain, _) in train_wrappers().items()}
    # the masked K1 launches go through the ln_linear wrapper
    table, uses, details = run_kernel_phase(rec, torch, fns, unit="train step")
    del rec

    # five timed steps of the kernel model
    params = dict(kernel_state.model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    times, step_losses = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        kernel_state, metrics = kernel_step(kernel_state, video, image, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        step_losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(step_losses)):
        raise SystemExit(f"train: non-finite loss {step_losses}")
    moved = sum(int(not torch.equal(before[k], p.detach()))
                for k, p in params.items())
    if moved < len(params) // 2:
        raise SystemExit(f"train: only {moved} of {len(params)} parameters "
                         "changed over five steps")
    ms = statistics.median(times)
    log(f"train step (video {TRAIN_VIDEO} + image {TRAIN_IMAGE} + "
        f"{TRAIN_VIDEO * cfg.DATA.NUM_FRAMES} consistency frames): "
        f"{ms:.1f} ms median of 5 {[round(t, 1) for t in times]}, "
        f"{TRAIN_VIDEO / ms * 1e3:.2f} clips/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, losses {[round(v, 4) for v in step_losses]}, "
        f"{moved}/{len(params)} parameters moved")
    result["timed"] = {"ms": times, "median_ms": ms,
                       "clips_per_s": TRAIN_VIDEO / ms * 1e3,
                       "peak_bytes": peak, "losses": step_losses,
                       "params_moved": moved, "params": len(params)}
    result["profile"] = profile_step(kernel_step, kernel_state, video, image,
                                     torch, ms)
    return result, table, uses, details


def gemm_rows(rows):
    """The profile's GEMM rows (cuBLAS and CUTLASS kernels), each with the
    operand type its kernel name gives.  cuBLAS's Hopper kernels are named
    ``nvjet_<operands><accumulator><output>_...`` (t bf16, s f32, h f16):
    ``torch.mm`` of bf16 operands with an f32 output runs
    ``nvjet_tss_...`` (measured on an H100, torch 2.11)."""
    out = []
    for name, count, ms in rows:
        low = name.lower()
        if low.startswith("nvjet_"):
            kind = {"t": "bf16", "s": "f32", "h": "f16"}.get(low[6], "other")
        elif any(k in low for k in ("gemm", "xmma", "cutlass")):
            kind = ("bf16" if "bf16" in low else "tf32" if "tf32" in low
                    else "f32" if any(k in low for k in ("sgemm", "f32f32"))
                    else "other")
        else:
            continue
        out.append({"name": name, "count": count, "ms": ms, "dtype": kind})
    return out


def tagged_rows(prof, tags, torch):
    """(kernel name, launches, device ms) of the kernels launched inside the
    profiler ranges named ``tags`` (``record_function`` on the host: every
    op below such a range, with the kernels each launched), busiest
    first."""
    acc = collections.defaultdict(lambda: [0, 0.0])

    def walk(e):
        for k in e.kernels:
            acc[k.name][0] += 1
            acc[k.name][1] += k.duration / 1e3
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name in tags and e.device_type == torch.autograd.DeviceType.CPU:
            walk(e)
    return sorted(((n, c, ms) for n, (c, ms) in acc.items()),
                  key=lambda r: -r[2])


def bias_rows(prof, torch):
    """The rel-pos bias builder's kernels in a profile (forward and the
    backward of its products), with their GEMM rows by operand type."""
    from svit_tpu_torch.ops import attention as ta

    rows = tagged_rows(prof, (ta.BIAS_TAG, ta.BIAS_BWD_TAG), torch)
    by_type = collections.Counter()
    for g in gemm_rows(rows):
        by_type[g["dtype"]] += g["ms"]
    return {"ms": sum(r[2] for r in rows),
            "launches": sum(r[1] for r in rows),
            "gemm_ms_by_type": dict(by_type),
            "top": [{"name": n, "count": c, "ms": m} for n, c, m in rows[:8]]}


def gemm_owners(prof, torch):
    """The ops that launched the profile's f32 GEMM kernels: (the launching
    op, its nearest autograd node or outermost op, its input shapes) ->
    [launches, device ms], busiest first."""
    acc = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        for g in gemm_rows([(k.name, 1, k.duration / 1e3)
                            for k in e.kernels]):
            if g["dtype"] != "f32":
                continue
            top, p = e, e.cpu_parent
            while p is not None:
                top = p
                if p.name.startswith("autograd::engine::evaluate_function"):
                    break
                p = p.cpu_parent
            key = f"{e.name} < {top.name} {e.input_shapes}"
            acc[key][0] += 1
            acc[key][1] += g["ms"]
    return sorted(([k, c, ms] for k, (c, ms) in acc.items()),
                  key=lambda r: -r[2])


def profile_step(step, state, video, image, torch, step_ms):
    """One train step under torch.profiler: device time by kernel, the
    hand-written kernels' share and the idle share against ``step_ms``;
    the GEMM rows by name and operand type, and the operand types of every
    product of the LN-linear backward (``ops/ln_linear.py:_mm``, recorded
    for this step)."""
    from torch.profiler import ProfilerActivity, profile

    from svit_tpu_torch.ops import ln_linear as ll

    products, flop = collections.Counter(), [0]
    mm = ll._mm

    def recorded(a, b):
        products[f"{a.dtype} x {b.dtype}"] += 1
        flop[0] += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        return mm(a, b)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ll._mm = recorded
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            step(state, video, image, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ll._mm = mm
    rows = device_rows(prof, torch)
    device_ms = sum(r[2] for r in rows)
    ours_ms = sum(r[2] for r in rows if any(k in r[0] for k in OUR_KERNELS))
    idle = max(0.0, 1 - device_ms / step_ms)
    log(f"profile train step: wall {wall_ms:.1f} ms (profiled), device "
        f"{device_ms:.1f} ms, hand-written kernels {ours_ms:.1f} ms, idle "
        f"share {idle:.3f} against the unprofiled {step_ms:.1f} ms")
    for name, count, ms in rows[:16]:
        log(f"  {ms:9.3f} ms x{count:<5d} {name[:90]}")
    gemms = gemm_rows(rows)
    by_type = collections.Counter()
    for g in gemms:
        by_type[g["dtype"]] += g["ms"]
    log(f"LN-linear backward products: {sum(products.values())} calls, "
        f"operands {dict(products)}, {flop[0] / 1e12:.3f} TFLOP; GEMM rows "
        f"of the step by operand type (ms): "
        f"{ {k: round(v, 3) for k, v in by_type.items()} }")
    for g in gemms[:12]:
        log(f"  {g['ms']:9.3f} ms x{g['count']:<5d} {g['dtype']:5s} "
            f"{g['name'][:80]}")
    bias = bias_rows(prof, torch)
    log(f"rel-pos bias builder (forward and its products' backward): "
        f"{bias['ms']:.3f} ms over {bias['launches']} launches, GEMM rows by "
        f"operand type (ms) "
        f"{ {k: round(v, 3) for k, v in bias['gemm_ms_by_type'].items()} }")
    owners = gemm_owners(prof, torch)
    log("f32 GEMM rows of the step by launching op:")
    for key, count, ms in owners[:8]:
        log(f"  {ms:9.3f} ms x{count:<5d} {key[:150]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "kernels_ms": ours_ms,
            "idle_share": idle, "bias_builder": bias, "f32_gemm_owners": owners,
            "ln_linear_bwd_products": dict(products),
            "ln_linear_bwd_tflop": flop[0] / 1e12,
            "gemm_ms_by_type": dict(by_type), "gemms": gemms,
            "top": [{"name": n, "count": c, "ms": m} for n, c, m in rows[:30]]}


def run_kernel_phase(rec, torch, fns, unit="forward"):
    """Phases 4 and 7: replay each recorded call: gate, times, bound.
    ``fns`` maps a counter name to (kernel, plain twin).  Returns the
    totals per kernel and per JAX function, and the per-call rows."""
    table = {n: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                     library_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
             for n in fns}
    uses = collections.defaultdict(collections.Counter)
    details = []
    for call in rec.calls.values():
        name, args, kwargs, count = (call["name"], call["args"],
                                     call["kwargs"], call["count"])
        kernel, plain = fns[name]
        with torch.inference_mode():
            yk = kernel(*args, **kwargs)
            y16 = plain(*args, **kwargs)
            y32 = plain(*to_f32(args), **to_f32(kwargs))
            torch.cuda.synchronize()
            k_, p_, f_ = cat_outputs(yk), cat_outputs(y16), cat_outputs(y32)
            if not bool(torch.isfinite(k_).all()):
                raise SystemExit(f"{name}: non-finite kernel output")
            err_k, err_p = rel_err(k_, f_), rel_err(p_, f_)
            max_abs = float((k_ - p_).abs().max())
            ok = err_k <= TOL_RATIO * err_p + TOL_ABS
            del yk, y16, y32, k_, p_, f_
            ms = device_time_ms(lambda: kernel(*args, **kwargs))
            plain_ms = device_time_ms(lambda: plain(*args, **kwargs), 2)
        with torch.enable_grad():   # the attention yardstick's backward
            lib_ms = device_time_ms(library_call(name, args, kwargs), 2)
        byts, tflops, cflops = cost(name, args, kwargs)
        bytes_ms = byts / HBM_BPS * 1e3
        ops_ms = max(tflops / TENSOR_FLOPS, cflops / CORE_FLOPS) * 1e3
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        log(f"{name} x{count} {shapes}: err={err_k:.2e} plain_err={err_p:.2e} "
            f"max_abs={max_abs:.2e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={max(bytes_ms, ops_ms):.4f} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel gate failed: {name} {shapes}")
        row = table[name]
        row["max_abs_err"] = max(row["max_abs_err"], max_abs)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bound_ms", max(bytes_ms, ops_ms)),
                     ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            row[k] += v * count
        use = use_of(name, args, kwargs)
        u = uses[f"{name}: {use}"]
        u["launches"] += count
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bound_ms", max(bytes_ms, ops_ms))):
            u[k] += v * count
        details.append(dict(name=name, use=use, count=count, shapes=shapes,
                            err=err_k, plain_err=err_p, max_abs_err=max_abs,
                            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bytes_ms=bytes_ms, ops_ms=ops_ms))
    log(f"per {unit}, by the JAX function each call stands for:")
    for key, u in uses.items():
        log(f"  {key}: launches {u['launches']} ms={u['ms']:.4f} "
            f"plain_ms={u['plain_ms']:.4f} library_ms={u['library_ms']:.4f} "
            f"bound_ms={u['bound_ms']:.4f}")
    return table, {k: dict(u) for k, u in uses.items()}, details


def run_ffn_phase(torch):
    """Phase 4b: ``fused_ffn`` (two K1 launches; no model path calls it, as
    in the JAX package) at ``FFN_SHAPES`` on random bf16 inputs from the
    seed, outside every counted run: gated against its plain twin in bf16
    and f32, timed beside the plain twin, the library yardstick
    (``F.layer_norm``, ``F.linear``, ``F.gelu``, ``F.linear``) and its
    bound (x, the weights and y moved once; h stays inside the function)."""
    import torch.nn.functional as F
    from svit_tpu_torch.ops import ln_linear as ll

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(shape, device="cuda", generator=gen)
                ).to(dtype)

    rows = []
    for M, C in FFN_SHAPES:
        H = 4 * C
        args = (randn(M, C), 1 + randn(C, scale=0.1, dtype=f32),
                randn(C, scale=0.1, dtype=f32), randn(H, C, scale=C ** -0.5),
                randn(H, scale=0.1, dtype=f32), randn(C, H, scale=H ** -0.5),
                randn(C, scale=0.1, dtype=f32))
        x, lw, lb, w1, b1, w2, b2 = args
        with torch.inference_mode():
            k_ = ll.fused_ffn(*args).float()
            p_ = ll.ffn_reference(*args).float()
            f_ = ll.ffn_reference(*to_f32(args)).float()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(k_).all()) or k_.shape != (M, C):
                raise SystemExit(f"fused_ffn [{M}, {C}]: bad output")
            err_k, err_p = rel_err(k_, f_), rel_err(p_, f_)
            max_abs = float((k_ - p_).abs().max())
            del k_, p_, f_
            ms = device_time_ms(lambda: ll.fused_ffn(*args))
            plain_ms = device_time_ms(lambda: ll.ffn_reference(*args), 2)
            lnw, lnb, b1b, b2b = (t.to(bf) for t in (lw, lb, b1, b2))
            lib_ms = device_time_ms(lambda: F.linear(F.gelu(F.linear(
                F.layer_norm(x, (C,), lnw, lnb, 1e-6), w1, b1b)), w2, b2b), 2)
        byts = sum(t.numel() * t.element_size() for t in args) + 2 * M * C
        bytes_ms = byts / HBM_BPS * 1e3
        ops_ms = 4.0 * M * C * H / TENSOR_FLOPS * 1e3
        ok = err_k <= TOL_RATIO * err_p + TOL_ABS
        log(f"fused_ffn [{M}, {C}] -> {H} -> {C}: err={err_k:.2e} "
            f"plain_err={err_p:.2e} max_abs={max_abs:.2e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={max(bytes_ms, ops_ms):.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"kernel gate failed: fused_ffn [{M}, {C}]")
        rows.append(dict(shape=[M, C, H], err=err_k, plain_err=err_p,
                         max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                         bound_ms=max(bytes_ms, ops_ms)))
    return rows


def k1_uses(uses, train_uses, ffn):
    """K1 by use: the forward's uses per forward, the masked uses per train
    step, and the fused_ffn replays (printed, and kept in the kernels
    line)."""
    table = {}
    for src, unit in ((uses, "per forward"), (train_uses, "per train step")):
        for key, u in src.items():
            name, use = key.split(": ", 1)
            if name.startswith("ln_linear"):
                table[f"{use} ({name}, {unit})"] = {
                    k: u[k] for k in ("launches", "ms", "bound_ms",
                                      "library_ms", "plain_ms")}
    for r in ffn:
        table[f"fused_ffn {r['shape']} (replay, 2 launches each)"] = {
            "launches": 0, "ms": r["ms"], "bound_ms": r["bound_ms"],
            "library_ms": r["library_ms"], "plain_ms": r["plain_ms"]}
    log("K1 by use (ms, bound and library ms summed over the launches):")
    for key, u in table.items():
        log(f"  {key}: launches {u['launches']} ms={u['ms']:.4f} "
            f"bound_ms={u['bound_ms']:.4f} ms/bound="
            f"{u['ms'] / u['bound_ms']:.2f} library_ms={u['library_ms']:.4f} "
            f"plain_ms={u['plain_ms']:.4f}")
    return table


def ptxas_report(text):
    """{kernel function: [its ptxas -v lines]} from the build log."""
    out, fn = collections.OrderedDict(), None
    for line in text.splitlines():
        for marker in ("Compiling entry function '", "Function properties for "):
            if marker in line:
                fn = line.split(marker, 1)[1].split("'")[0].strip()
                out.setdefault(fn, [])
        if fn and ("registers" in line or "spill" in line):
            out[fn].append(line.split(":", 1)[-1].strip())
    return out


def spilling(ptxas):
    """The kernel instances whose ptxas lines report spill stores or loads."""
    import re

    return sorted(fn for fn, lines in ptxas.items()
                  if any(int(n) for line in lines
                         for n in re.findall(r"(\d+) bytes spill", line)))


def time_forward(model, arch, torch, batch):
    x = torch.randn((batch, arch.num_frames, arch.crop_size, arch.crop_size, 3),
                    generator=torch.Generator().manual_seed(SEED + batch)).cuda()
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    log(f"forward batch {batch}: {ms:.2f} ms median of 10, "
        f"{batch / ms * 1e3:.2f} clips/s")
    return {"batch": batch, "ms": ms, "clips_per_s": batch / ms * 1e3}


OUR_KERNELS = ("ln_linear_kernel", "pool_ln_kernel", "pool_max_kernel",
               "attn_fwd_kernel", "attn_bwd_", "halo_gen_kernel",
               "dx_kernel", "conv_dk_", "dk_gen_kernel")


def device_rows(prof, torch):
    """(kernel name, launches, device ms) of a profile, busiest first.  A
    user annotation's device range (``Optimizer.step#AdamW.step``) spans
    kernels that have rows of their own and is left out."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if (dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            rows.append((e.key, e.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    return rows


def profile_forward(model, arch, torch, batch, fwd_ms):
    """One forward under torch.profiler: device time by kernel name.  The
    profiler slows the host, so the idle share is also given against
    ``fwd_ms``, the unprofiled forward's time."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((batch, arch.num_frames, arch.crop_size, arch.crop_size, 3),
                    generator=torch.Generator().manual_seed(SEED + batch)).cuda()
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof, torch)
    device_ms = sum(r[2] for r in rows)
    ours_ms = sum(r[2] for r in rows if any(k in r[0] for k in OUR_KERNELS))
    idle = max(0.0, 1 - device_ms / wall_ms)
    idle_unprofiled = max(0.0, 1 - device_ms / fwd_ms)
    log(f"profile batch {batch}: wall {wall_ms:.2f} ms (profiled), device "
        f"{device_ms:.2f} ms, hand-written kernels {ours_ms:.2f} ms, "
        f"idle share {idle:.3f} (profiled), {idle_unprofiled:.3f} against "
        f"the unprofiled {fwd_ms:.2f} ms")
    for name, count, ms in rows[:12]:
        log(f"  {ms:9.3f} ms x{count:<5d} {name[:90]}")
    return {"batch": batch, "wall_ms": wall_ms, "device_ms": device_ms,
            "kernels_ms": ours_ms, "idle_share": idle,
            "idle_share_unprofiled": idle_unprofiled,
            "top": [{"name": n, "count": c, "ms": m} for n, c, m in rows[:25]]}


def jpeg_frames(n, seed):
    from PIL import Image

    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(n):
        img = Image.fromarray(rng.randint(0, 255, (240, 320, 3), np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        frames.append(base64.b64encode(buf.getvalue()).decode())
    return frames


def run_serving_phase(cfg, torch):
    from svit_tpu_torch.serving.server import make_server

    httpd = make_server(cfg, "127.0.0.1", 0, max_batch=BATCH, window_ms=10.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if r.status != 200 or health.get("status") != "ok":
            raise SystemExit(f"/healthz answered {r.status} {health}")
        bodies = [json.dumps({"frames": jpeg_frames(16, i)}).encode()
                  for i in range(3)]
        results, errors = [None] * 3, []

        def post(i):
            t0 = time.perf_counter()
            req = urllib.request.Request(
                url + "/predict", data=bodies[i],
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    results[i] = (r.status, json.loads(r.read()),
                                  (time.perf_counter() - t0) * 1e3)
            except Exception as e:  # reported below, fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if errors or any(r is None for r in results):
            raise SystemExit(f"/predict failed: {errors}")
        lat = []
        for status, out, ms in results:
            boxes = np.asarray(out["pred_bboxes"])
            if status != 200 or len(out["top_k"]) != 5 or boxes.shape != (16, 4, 5):
                raise SystemExit(f"/predict answered {status}: top_k "
                                 f"{len(out.get('top_k', []))}, boxes {boxes.shape}")
            if not np.isfinite(boxes).all():
                raise SystemExit("/predict returned non-finite boxes")
            lat.append(ms)
        log(f"serving: /healthz ok; 3 concurrent /predict ok, latency ms "
            f"{[round(v, 1) for v in lat]}")
        return {"latency_ms": lat}
    finally:
        httpd.shutdown()
        httpd.predictor.stop()
        httpd.server_close()
        thread.join(timeout=60)


# ---------------------------------------------------------------------------
# Phase 8: the multi-view test path, the eval steps, K4 and K5 at R = 120
# ---------------------------------------------------------------------------

TEST_VIDEOS, TEST_FRAMES = 4, 24
SSV2_FRAME = (427, 240)      # width, height of an SSv2 frame
# The plain twins test at this batch: at 64 the f32 twin's dense attention
# logits of the first stage are 10.5 GB a tensor.  A clip's scores do not
# depend on the clips beside it in the batch.
PLAIN_TEST_BATCH = 16
EVAL_BATCH = 8


def make_ssv2_tree(root, num_classes):
    """A standard-split SSv2 tree in the layout ``data/ssv2.py`` reads:
    ``TEST_VIDEOS`` videos of ``TEST_FRAMES`` JPEG frames at 427 x 240
    (random pixels through PIL, from seed 0), labels under
    ``num_classes``, the label and split JSONs and a box-tracking JSON per
    video.  Video ids are kept out of the repo's ``empty_bbox_*.json`` skip
    lists.  Returns (ids, labels)."""
    from PIL import Image

    rng = np.random.RandomState(SEED)
    skip = set()
    for split in ("train", "val"):
        with open(os.path.join(REPO, "data", "ssv2",
                               f"empty_bbox_{split}.json")) as f:
            skip |= set(json.load(f))
    vids = [str(9000000 + i) for i in range(TEST_VIDEOS)]
    assert not skip & set(vids)
    labels = rng.randint(0, num_classes, TEST_VIDEOS)
    for d in ("sm/annotations", "json_files", "bbox_jsons"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    templates = [f"Doing thing {i}" for i in range(num_classes)]
    with open(os.path.join(root, "sm/annotations",
                           "something-something-v2-labels.json"), "w") as f:
        json.dump({t: str(i) for i, t in enumerate(templates)}, f)
    entries = [{"id": v, "template": templates[l]}
               for v, l in zip(vids, labels)]
    for split in ("train", "validation"):
        with open(os.path.join(root, "json_files",
                               f"something-something-v2-{split}.json"),
                  "w") as f:
            json.dump(entries, f)
    W, H = SSV2_FRAME
    for v in vids:
        os.makedirs(os.path.join(root, "frames", v))
        frames = []
        for t in range(TEST_FRAMES):
            name = "%04d.jpg" % (t + 1)
            Image.fromarray(rng.randint(0, 255, (H, W, 3), np.uint8)).save(
                os.path.join(root, "frames", v, name))
            x1, y1 = float(rng.uniform(0, W / 2)), float(rng.uniform(0, H / 2))
            frames.append({"name": f"frames/{v}/{name}", "labels": [{
                "standard_category": "hand",
                "box2d": {"x1": x1, "y1": y1, "x2": x1 + 40.0,
                          "y2": y1 + 40.0}}]})
        with open(os.path.join(root, "bbox_jsons", f"{int(v)}.json"),
                  "w") as f:
            json.dump(frames, f)
    return vids, labels


def test_cfg(root, name, batch=None):
    """configs/ssv2.yaml at full size on the tree at ``root`` (its test
    batch unless ``batch`` is given): ``name`` is kernels (bf16),
    plain_bf16 or plain_f32."""
    from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(CFG)
    cfg.SSV2.DATA_ROOT = root
    cfg.OUTPUT_DIR = root
    if batch is not None:
        cfg.TEST.BATCH_SIZE = batch
    cfg.TEST.SAVE_RESULTS_PATH = os.path.join(root, f"results_{name}.pkl")
    cfg.TRAIN.MIXED_PRECISION = name != "plain_f32"
    cfg.TPU.USE_PALLAS_ATTENTION = name == "kernels"
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    return assert_and_infer_cfg(cfg)


RUNS = ("kernels", "plain_bf16", "plain_f32")


def gate(what, values, result):
    """The gate on ``values[run]`` (tensors or arrays), relative L2 against
    plain_f32; records and raises on failure."""
    import torch

    vk, v16, v32 = (torch.as_tensor(np.asarray(values[n], np.float64))
                    for n in RUNS)
    err_k, err_p = rel_err(vk, v32), rel_err(v16, v32)
    ok = bool(np.isfinite(vk.numpy()).all()) and \
        err_k <= TOL_RATIO * err_p + TOL_ABS
    log(f"phase 8 gate {what}: err(kernels)={err_k:.3e} err(plain bf16)="
        f"{err_p:.3e} {'ok' if ok else 'FAIL'}")
    result[f"gate_{what}"] = {"err_kernels": err_k, "err_plain_bf16": err_p}
    if not ok:
        raise SystemExit(f"test gate failed on {what}")


def run_multiview_test(root, arch, torch):
    """``engine.test.test(cfg)`` three times from one weight seed: the
    video-level scores gated against plain f32, each run's top-1 and
    top-5, the kernel run's launches against ``expected_launches`` per
    batch, its wall time and clips/s."""
    import pickle

    from svit_tpu_torch.engine import test as test_mod
    from svit_tpu_torch.ops import _lib

    result, preds = {}, {}
    loop = {}
    perform = test_mod.perform_test

    def timed(*args):
        t0 = time.perf_counter()
        out = perform(*args)
        torch.cuda.synchronize()
        loop["s"] = time.perf_counter() - t0
        loop["batches"] = len(args[1])
        return out

    test_mod.perform_test = timed
    try:
        for name in RUNS:
            cfg = test_cfg(root, name, None if name == "kernels"
                           else PLAIN_TEST_BATCH)
            torch.cuda.synchronize()
            _lib.reset_launch_counts()
            t0 = time.perf_counter()
            stats = test_mod.test(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_lib.LAUNCHES)
            with open(cfg.TEST.SAVE_RESULTS_PATH, "rb") as f:
                saved = pickle.load(f)
            preds[name] = saved["video_preds"]
            clips = len(saved["video_labels"]) * cfg.TEST.NUM_ENSEMBLE_VIEWS \
                * cfg.TEST.NUM_SPATIAL_CROPS
            run = {"stats": stats, "wall_s": wall, "loop_s": loop["s"],
                   "batches": loop["batches"], "batch": cfg.TEST.BATCH_SIZE,
                   "clips": clips, "clips_per_s": clips / loop["s"],
                   "labels": saved["video_labels"].tolist()}
            log(f"test [{name}]: top1 {stats['top1_acc']} top5 "
                f"{stats['top5_acc']}, {clips} clips at batch "
                f"{cfg.TEST.BATCH_SIZE} in {loop['batches']} batches: test "
                f"loop {loop['s']:.2f} s ({run['clips_per_s']:.2f} clips/s), "
                f"test() {wall:.2f} s")
            if name == "kernels":
                want = {k: v * loop["batches"]
                        for k, v in expected_launches(arch).items()}
                log(f"test launches: {launches} over {loop['batches']} "
                    f"batch-64 forwards (expected {want})")
                if launches != want:
                    raise SystemExit("test path launch counts differ")
                run["launches"] = launches
                run["launches_per_forward"] = dict(expected_launches(arch))
            result[name] = run
    finally:
        test_mod.perform_test = perform
    if not all(result[n]["labels"] == result["kernels"]["labels"]
               for n in RUNS):
        raise SystemExit("test: the runs' video labels differ")
    gate("video_preds", preds, result)
    return result


def topk_flips(pk, p16, p32, labels, weight):
    """Rows (weight > 0) where the kernel run's top-1 or top-5 verdict
    differs from plain f32's, with the f32 margin of the label over the
    k-th other class, and the resolution it is held to: one bf16 ulp of
    the label's score plus 3 x the plain bf16 run's largest error on the
    row (the gate's ratio)."""
    flips = []
    for i in np.flatnonzero(weight > 0):
        lab = int(labels[i])
        err16 = float(np.abs(p16[i] - p32[i]).max())
        for k in (1, 5):
            def inside(p):
                return p[lab] > np.sort(np.delete(p, lab))[-k]
            if inside(pk[i]) == inside(p32[i]):
                continue
            kth = float(np.sort(np.delete(p32[i], lab))[-k])
            margin = float(p32[i, lab]) - kth
            res = 2.0 ** (np.floor(np.log2(abs(p32[i, lab]) + 1e-30)) - 7) \
                + 3 * err16
            flips.append({"row": int(i), "k": k, "margin": margin,
                          "resolution": float(res),
                          "ok": abs(margin) <= res})
    return flips


def run_eval_steps(root, torch):
    """``make_eval_step`` with the loss (consistency l1: a 128-frame
    frames forward) on one val batch of 8 clips from the tree, and
    ``make_image_eval_step`` on phase 7's image batch of 8, for the three
    runs: losses gated as phase 7 gates the step loss, top-k verdicts
    compared, the kernel run's launches counted."""
    from svit_tpu_torch.data.loader import construct_loader
    from svit_tpu_torch.engine import steps
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.ops import _lib

    cfg = test_cfg(root, "kernels")
    cfg.TRAIN.BATCH_SIZE = EVAL_BATCH
    batch = next(iter(construct_loader(cfg, "val")))
    video = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    image = train_batch(cfg, torch)[1]
    losses, probs, result = {}, {}, {}
    for name in RUNS:
        c = test_cfg(root, name)
        model, arch = build_model(c)
        loss_obj = get_loss_func(c)
        ev = steps.make_eval_step(model, arch.num_classes, loss_obj,
                                  with_consistency=True)
        iev = steps.make_image_eval_step(model, loss_obj)
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        out = ev(video)
        torch.cuda.synchronize()
        video_launches = dict(_lib.LAUNCHES)
        _lib.reset_launch_counts()
        iout = iev(image)
        torch.cuda.synchronize()
        image_launches = dict(_lib.LAUNCHES)
        steps.check_nan(out)
        steps.check_nan(iout)
        if name == "kernels":
            per = expected_launches(arch)
            want_v = {k: 2 * v for k, v in per.items()}
            log(f"eval step launches: video {video_launches} (expected "
                f"{want_v}), image {image_launches} (expected {dict(per)})")
            if video_launches != want_v or image_launches != dict(per):
                raise SystemExit("eval step launch counts differ")
            result["launches"] = {"video": video_launches,
                                  "image": image_launches}
        losses[name] = {**{k: float(v) for k, v in out.items()
                           if k != "logits"},
                        **{f"image_{k}": float(v) for k, v in iout.items()}}
        probs[name] = out["logits"].float().cpu().numpy()
        log(f"eval [{name}]: " + ", ".join(
            f"{k} {v:.6f}" for k, v in losses[name].items()))
        del model
        torch.cuda.empty_cache()
    result["losses"] = losses
    keys = [k for k in losses["plain_f32"]
            if "loss" in k and not k.startswith("image_count")]
    for k in keys:
        gate(k, {n: losses[n][k] for n in RUNS}, result)
    for k in ("top1_correct", "top5_correct", "count"):
        log(f"eval {k}: " + ", ".join(f"{n} {losses[n][k]:g}" for n in RUNS))
    flips = topk_flips(probs["kernels"], probs["plain_bf16"],
                       probs["plain_f32"], batch["labels"], batch["weight"])
    for f in flips:
        log(f"eval top-{f['k']} verdict differs on row {f['row']}: f32 "
            f"margin {f['margin']:.3e}, resolution {f['resolution']:.3e} "
            f"{'ok' if f['ok'] else 'FAIL'}")
    result["topk_flips"] = flips
    if not all(f["ok"] for f in flips):
        raise SystemExit("eval: a top-k verdict differs beyond bf16's "
                         "resolution")
    return result


def run_wide_bias(torch):
    """A.2 at full size: a block without k|v pooling at 16 x 224 (its key
    grid 8 x 56 x 56, kT + kH + kW = 120) in a two-block SViT-B/16 at batch
    1, forward and backward through K4 and K5's wide instance, the logits
    and the global gradient vector gated against the plain twins."""
    from svit_tpu_torch.config import get_cfg
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.ops import attention as ta

    cfg = get_cfg()
    cfg.merge_from_file(CFG)
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = None
    cfg.MVIT.POOL_KV_STRIDE = [[1, 1, 2, 2]]
    gen = torch.Generator().manual_seed(SEED)
    models = [build_model(cfg, dtype=dt, use_kernels=k, train=True)[0]
              for dt, k in ((torch.bfloat16, True), (torch.bfloat16, False),
                            (torch.float32, False))]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    arch = models[0].arch
    grid = tuple(arch.patch_dims)
    R = sum(grid)
    extras = 1 + arch.num_frames * arch.num_obj_per_frame
    plan = ta.attention_plan(1, math.prod(grid), math.prod(grid) + extras,
                             arch.blocks[0].dim_out, arch.blocks[0].num_heads,
                             R)
    x = torch.randn((1, arch.num_frames, arch.crop_size, arch.crop_size, 3),
                    generator=gen).cuda()
    cot = torch.randn((1, cfg.MODEL.NUM_CLASSES), generator=gen).cuda()
    values, grads, launches = {}, {}, {}
    for name, m in zip(RUNS, models):
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        logits, _ = m(x, train=False)
        (logits.float() * cot).sum().backward()
        torch.cuda.synchronize()
        launches[name] = dict(_lib.LAUNCHES)
        values[name] = logits.detach().float().flatten().cpu()
        grads[name] = torch.cat([p.grad.float().flatten() for p in
                                 m.parameters() if p.grad is not None]).cpu()
    del models
    torch.cuda.empty_cache()
    log(f"wide bias: first block's key grid {grid} (R = {R}, the plan's rk "
        f"{plan.rk}); kernel launches {launches['kernels']}")
    if plan.rk != ta.RK_WIDE or R <= 48:
        raise SystemExit(f"wide bias: R = {R} takes rk {plan.rk}, not the "
                         "wide instance")
    if not (launches["kernels"].get("pooled_attention", 0) >= 4 and
            launches["kernels"].get("pooled_attention_bwd", 0) >= 2):
        raise SystemExit("wide bias: K4 or K5 did not launch")
    result = {"R": R, "rk": plan.rk, "launches": launches["kernels"]}
    gate("wide_bias_logits", values, result)
    gate("wide_bias_grads", grads, result)
    return result


def run_test_phase(torch):
    """Phase 8.  Returns its results and the launches of one batch-64
    forward."""
    import tempfile

    from svit_tpu_torch.models import build_model

    result = {}
    with tempfile.TemporaryDirectory() as root:
        cfg = test_cfg(root, "kernels")
        vids, labels = make_ssv2_tree(root, cfg.MODEL.NUM_CLASSES)
        from svit_tpu_torch.native import jpeg

        result["decoder"] = "libjpeg shim" if jpeg.available() else "PIL"
        log(f"test tree: {len(vids)} videos x {TEST_FRAMES} JPEG frames at "
            f"{SSV2_FRAME[0]} x {SSV2_FRAME[1]}, labels {labels.tolist()}; "
            f"decoded by the {result['decoder']}")
        model, arch = build_model(cfg)
        fwd = time_forward(model, arch, torch, cfg.TEST.BATCH_SIZE)
        result["forward"] = fwd
        result["profile"] = profile_forward(model, arch, torch,
                                            cfg.TEST.BATCH_SIZE, fwd["ms"])
        del model
        torch.cuda.empty_cache()
        result["multiview"] = run_multiview_test(root, arch, torch)
        result["eval"] = run_eval_steps(root, torch)
    result["wide_bias"] = run_wide_bias(torch)
    return result, result["multiview"]["kernels"]["launches_per_forward"]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import svit_tpu_torch

    if not os.path.abspath(svit_tpu_torch.__file__).startswith(REPO + os.sep):
        raise SystemExit("svit_tpu_torch is not this checkout's package")
    from svit_tpu_torch.config import get_cfg
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.ops import _lib

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = _lib.build()
    _lib.library()
    build_s = time.perf_counter() - t0
    log(f"build: {so.name} in {build_s:.1f} s")
    build_log = (_lib.BUILD / "build.log").read_text()
    ptxas = ptxas_report(build_log)
    for fn, lines in ptxas.items():   # every instance, with its spills
        log(f"  {fn}: " + "; ".join(lines))
    for line in build_log.splitlines():
        if "Performance Loss" in line:
            log("  " + line.strip())
    spills = spilling(ptxas)
    log(f"kernel instances that spill: {spills or 'none'}")

    cfg = get_cfg()
    cfg.merge_from_file(CFG)
    model, arch = build_model(cfg)
    log(f"model: {cfg.MODEL.MODEL_NAME} {arch.num_frames}x{arch.crop_size} "
        f"depth {arch.depth}, {sum(p.numel() for p in model.parameters())} "
        f"params, batch {BATCH}")
    rec, model_result = run_model_phase(model, arch, torch)
    fns = {n: (getattr(mod, attr), plain)
           for n, (mod, attr, plain) in wrappers().items()}
    table, uses, details = run_kernel_phase(rec, torch, fns)
    del rec
    ffn = run_ffn_phase(torch)
    fwd =[time_forward(model, arch, torch, b) for b in (BATCH, 1)]
    prof = [profile_forward(model, arch, torch, f["batch"], f["ms"])
            for f in fwd]
    del model
    torch.cuda.empty_cache()
    serving = run_serving_phase(cfg, torch)
    torch.cuda.empty_cache()

    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    train, train_table, train_uses, train_details = run_train_phase(cfg, torch)
    k1 = k1_uses(uses, train_uses, ffn)
    torch.cuda.empty_cache()
    test, test_launches = run_test_phase(torch)

    kernels = []
    for names, rows, launches in (
            (KERNELS, table, model_result["launches"]),
            (TRAIN_KERNELS, train_table, train["launches"])):
        for name, (source, replaces) in names.items():
            row = rows[name]
            counter = COUNTER.get(name, name)
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.get(counter, 0),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"]
                else "operations",
                "library_ms": row["library_ms"],
                "train_launches": train["launches"].get(counter, 0),
                "test_launches": test_launches.get(counter, 0),
            })
            if name == "ln_linear":
                kernels[-1]["uses"] = k1
            elif "attention" in name:   # K4 and K5 by use and Nk
                kernels[-1]["uses"] = {
                    k.split(": ", 1)[1]: u for k, u in
                    (train_uses if names is TRAIN_KERNELS else uses).items()
                    if k.split(": ", 1)[0] == name}
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_detail.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, ptxas=ptxas, spills=spills,
                       model=model_result, forward=fwd, profile=prof,
                       serving=serving, uses=uses, calls=details, ffn=ffn,
                       train=train, train_uses=train_uses,
                       train_calls=train_details, test=test,
                       kernels=kernels), f,
                  indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
