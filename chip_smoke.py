#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``svit_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the hand-written kernels of ``svit_tpu_torch/csrc`` (nvcc, sm_90a)
   and the seconds it took; every instance's ``ptxas`` registers and
   spills (K3's instances, its gathers and its backward's tuned tile,
   must be there and spill nothing);
3. model: the SViT-B/16 serving forward (``configs/ssv2.yaml``: 16 frames at
   224 px, 16 blocks, bf16) at batch 8 with random weights from a seed, run
   three ways: kernels in bf16, plain PyTorch in bf16, plain in f32 (TF32
   off).  The kernel run's outputs must pass
   ``err(kernels) <= 3 * err(plain bf16) + 2e-3`` (relative L2 error against
   the f32 run; ``tools/check_kernels_hw.py``'s comparison) on the logits,
   the boxes, the contact logits and the last block's grid output, and
   every kernel's launch count over that one forward must equal what the
   architecture implies;
4. kernels: every distinct call the kernel forward made to a kernel wrapper
   is replayed on the same tensors: the kernel against its plain version in
   bf16 and in f32 (same gate), and timed (device time, queued behind a
   sleep kernel: ``device_time_ms``) beside the plain version, one PyTorch
   library yardstick and the card's bound; the per-forward totals are
   printed per kernel and
   per JAX function served.  Each K3 call is held bit for bit against its
   plain twin and a rerun, on the recorded call, a three-level grid and
   an all-negative one.  4b: ``fused_ffn`` (off the model path) is
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
   K6, K7, K3's ``pool_max_bwd``), K2's bare mode, K1's masked mode and
   K4 is replayed against
   its plain version, timed beside its bound and a library yardstick, and
   so is every K2 call of the step's three forwards (the ``pool_ln (train
   step)`` row) and every call of K3's instance that writes the argmax
   (``pool_max (train step)``).  Each ``pool_max_bwd`` call logs its
   route (the tuned tile or the general gather: every main-path call must
   take the tuned one) and is held bit for bit against its plain twin and
   the general instance, on the recorded call and on a three-level grid,
   and against a rerun; each ``pool_max (train step)`` call as phase 4
   holds the serving instance's, the argmax bytes too.  Then
   five timed steps of the kernel model: median step time, clips/s, peak
   memory, a profiled step's device time by kernel and idle share (with its
   GEMM rows by operand type, and the operand types of every product of
   the LN-linear backward; no event of ``F.max_pool3d``'s backward), a
   finite loss and parameters that move.

8. test: a synthetic SSv2 tree in a temp dir (4 videos of 24 JPEG frames
   at 427 x 240, written through PIL from seed 0), then at
   ``configs/ssv2.yaml``'s full size: one timed and one profiled batch-64
   forward; ``engine.test.test(cfg)`` (10 views x 3 crops, 120 clips) for
   kernels in bf16 at the config's batch of 64, and the plain versions in
   bf16 and f32 at batch 16, the video-level scores gated as above, each
   run's top-1 and top-5, the kernel run's test step (a CUDA graph): its
   capture's launches against the forward's and one replay per batch, its
   test loop's clips/s; ``make_eval_step`` with the loss
   (consistency l1: a 128-frame frames forward) on a val batch of 8 from
   the tree and ``make_image_eval_step`` on phase 7's image batch, the
   losses gated, the top-k verdicts of kernels and plain f32 compared
   (a row may differ only within bf16's resolution), the launches
   counted; and a two-block model whose first block has no k|v pool at 16
   x 224 (key grid 8 x 56 x 56, kT + kH + kW = 120) forward and backward
   through K4 and K5's wide instance, gated, and the same at 16 x 256
   (kT + kH + kW = 136, their chunked instance), gated and timed;
9. trainer: ``engine.train.train(cfg)`` on a synthetic tree of 56 videos
   of 24 frames with hand and object boxes, ``configs/ssv2.yaml`` at full
   size with its augmentation, the image rank on ``ssv2_frames``, video
   batch 7 and image batch 8, two epochs of 8 steps with a checkpoint and
   an eval epoch after each.  Every step's metrics finite and its launches
   equal to the step's own; the first step gated against
   ``make_train_step`` as phase 7 gates, and that step run twice from one
   state (loss, metrics, gradients and parameters bit for bit) and once
   under ``use_deterministic_algorithms``, which must name no op: printed
   as ``deterministic: true``; no f32 GEMM row of a product of f32
   operands in a profiled step; the per-step wall (median and quartiles of
   the steady steps), data wait, device time, idle share and peak memory.
   Then a rerun to 3 epochs resumes at epoch 2 with the state equal bit for
   bit, and a SIGTERM after step 2 saves a mid-epoch checkpoint from which
   the rerun starts at iter 2.  The Trainer's step is the captured one
   (phase 10): its first call warms up and captures, every later call
   replays (no host launches), and the graph holds the step's launch
   counts; its profiled step is a replay.  Then one epoch with
   ``TPU.DEVICE_AUG`` (uint8 frames at ``TPU.RAW_SIZE``, augmented inside
   the captured step): finite metrics, wall and data time per step;
10. compiled: the CUDA graphs of ``engine/graphs.py`` at the full size.
   The serving forward (``BatchedPredictor``) at batch 8 and 1, bit-equal
   to the eager forward; the train step on phase 7's batch and seed, its
   loss bit-equal to phase 7's eager kernel step and its gradient under
   the gate against phase 7's plain runs, replayed twice from one state
   bit for bit (``deterministic: true``), the capture's launch counts;
   the eval (with the consistency loss), image-eval and batch-64 test
   steps against their eager outputs.  Each path's replays and eager
   calls are timed in turns in the same call (median wall, a profiled
   call's device time, idle share); each graph's hand-written kernel
   nodes, read from its ``cudaGraph_t``, must be one for each launch its
   capture counted, and a profiled replay must show each of those
   kernels (the profiler loses a record now and then, so not its exact
   count); the train step's peak memory and model FLOP/s against the
   bf16 peak; the step's ``StepCache`` against the per-use form captured
   beside it (the loss bit for bit, device time and events of a replay
   of each);
11. Grad-CAM (``visualization/gradcam.py``) at full size at the target
   ``TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST = ["blocks_0_out"]``, so
   that its backward (no parameter gradient) crosses blocks 1 to 15: the
   three runs on the same batch-4 clips, the logits, the target layer's
   gradient and the pre-ReLU map gated as above; the kernel call's
   launches against ``expected_gradcam_launches`` (K7 none); the call's
   wall, device time, idle share at batch 4 and 64 and its peak memory;
   the default target's map all zero (with a cls token the head reads
   only the extras: the last block's grid gets no gradient);
12. demo: ``demo(cfg)`` at full size on 96 JPEG frames at 427 x 240 (a
   frame directory, PIL), its clip count and written frames against the
   buffer arithmetic, its loop's clips/s split into preprocessing, the
   forward (copy in, replay, copy out), drawing and writing; the
   ``Predictor``'s captured forward bit-equal to the eager one.  The
   card's machine has no libav, so no ``.mp4`` is written and the
   Kinetics test (libav decoding) is held on the CPU only;
13. NCCL: the captured train step (phase 7's batch and seed) under a
   process group of one rank, its gradient all-reduce and the losses' and
   metrics' all-reduces issued inside the capture, against the same step
   with no group: loss, metrics, gradients and parameters bit for bit, the
   same hand-written kernel nodes (NCCL adds no kernel at one rank),
   replays timed in turns (the multi-card run needs more cards);
14. learning proof: ``python -m svit_tpu_torch.tools.overfit_hw`` (the
   CLI on 4 solid-colour videos, bf16 kernels, captured step; SIGTERM
   after 6 steps, then the auto-resume from the checkpoint it wrote,
   mid-epoch or at an epoch's end; every step of the schedule logged once;
   the first ``loss_ce`` above 1.0, the last below 0.1);
15. tools: the measuring tools of ``svit_tpu_torch/tools`` at full size.
   ``check_kernels_hw.run_gate`` with the backward (batch 2: the four
   forward outputs, the video loss's gradient, the small train-mode
   gradient with drop-path) must pass, and its self-test (K4's output
   rolled, ``SVIT_PALLAS_FAULT=1``) must trip; ``trace_forward`` traces
   the batch-8 serving forward and the train step, each as a replayed
   graph and eager, and ``trace_attrib`` prints their device time by
   family, the 25 busiest owners (the eager call's module, forward or
   backward), the unowned share and each hand-written family's traced
   time beside phase 4's or 7's replays (logged, not gated: the profiler
   drops records); ``profile_model``'s variants at batch 16;
   ``engine_steady_state`` (``train_epoch`` on staged batches) against
   phase 10's train replay; ``benchmark`` (the train loader alone) on a
   tree like phase 9's at the config's loader workers and at none.  The
   phase prints its wall time;
16. remat: the captured train step with ``TPU.REMAT=True`` (each block
   under ``torch.utils.checkpoint``, recomputed through K1 to K4 in the
   backward) and without, from one seeded state, at video 8 + image 8
   and at 32 + 32: at each size the loss, metrics, gradients, parameters
   after AdamW and the generator's state bit for bit, the capture's
   launches (the remat step's forward kernels as five forwards,
   its backward kernels as the step's), replays timed in turns and
   ``torch.cuda.max_memory_allocated``;
17. head widths: the kernels at the shapes past the shipped config's
   (``HEAD_WIDTHS``): the JAX package's small schedules (EMBED_DIM 32,
   head_dim 32) at their own sizes, and ``configs/ssv2.yaml`` with
   NUM_HEADS 2 (head_dim 48) and with EMBED_DIM 144, NUM_HEADS 2 (head_dim
   72, C 144 to 1152, K1's prologue pass at K = 1152) at 16 x 224, full
   width, depth 4 with a stage transition at each of blocks 1, 2, 3.  Each
   runs the serving forward at batch 8 and one train step (video 8 +
   image 8 + the consistency forward) three ways, gated as phases 3 and
   7, its launches the architecture's (no call took a twin); every call
   of an instance new to these widths (K4 and K5 at HD = 32 or a padded
   head, the general K2, K6 and K7, K1's prologue pass) is replayed
   against its plain twin under the gate and timed beside its bound and
   its library call (K1's pass beside its GEMM alone); first, K1's
   prologue pass forced at K = 768 is held bit for bit to the panel (the
   qkv, fc1 and its masked form); the new instances' ``ptxas`` registers
   and spills are printed after the build.

It prints the ``{"kernels": [...]}`` line (``launches`` of the forward
kernels count the serving forward, those of the train step's new kernels
and modes, and of K2's and K4's train-step rows, the train step;
``train_launches`` counts the train step for all, ``test_launches`` one
batch-64 test forward, ``trainer_launches`` phase 9's first run (its
warm-ups and captures, and its eager eval steps' none: they replay too),
``train_replay_launches`` and ``serving_replay_launches`` a replay of phase
10's train-step and batch-8 serving graphs, ``gradcam_launches`` phase
11's batch-4 Grad-CAM call, ``remat_train_launches`` a replay of phase
16's remat step at video 8 + image 8; K1, K4
and K5 carry their uses; phase 17's rows, one per kernel and schedule,
count the calls of its new instances in that schedule's forward or train
step), the card's name
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
import re
import signal
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
TRAIN_K3 = "pool_max (train step)"
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
    "pool_max_bwd": ("svit_tpu_torch/csrc/pool.cu",
                     "svit_tpu/ops/pallas_pool.py:880 _pool_max_bwd (the VJP "
                     "of reduce_window: no pallas_call; the backward of "
                     ":695 _kernel_strided_max)"),
    TRAIN_K3: ("svit_tpu_torch/csrc/pool.cu",
               "svit_tpu/ops/pallas_pool.py:695 _kernel_strided_max (the "
               "instance that also writes the argmax, in the train step's "
               "video and image forwards)"),
}
# a kernel table row -> the launch counter it reads
COUNTER = {TRAIN_K4: "pooled_attention", TRAIN_K2: "pool_ln"}
# the rows whose launches are their recorded calls: the train step's K3
# instance with the argmax counts under "pool_max" with the serving
# instance that its no-grad consistency forward runs
RECORDED = (TRAIN_K3,)
# a recorded call's name -> the kernel whose cost and yardstick it takes
KIND = {"ln_linear_masked": "ln_linear", TRAIN_K4: "pooled_attention",
        TRAIN_K2: "pool_ln", TRAIN_K3: "pool_max"}


# K3's instances (``csrc/pool.cu``) and how many the build holds: the
# forward's gathers (serving and argmax), the backward's tuned tile and its
# gather
K3_INSTANCES = {"pool_max_kernel": 2, "pool_max_bwd_tile_kernel": 1,
                "pool_max_bwd_kernel": 1}


def log(*a):
    """A line to standard output and to ``chiprun_out/chip_smoke.log`` (the
    whole run's lines, where the output is cut to its end)."""
    print(*a, flush=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.log"), "a") as f:
        print(*a, file=f)


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


def bits_equal(a, b):
    """Two kernel outputs (tensors, or tuples of them) equal bit for bit:
    bf16 by its int16 bits (NaN payloads included), other types by
    value."""
    import torch

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    fa, fb = flat_outputs(a), flat_outputs(b)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and torch.equal(bits(x), bits(y))
        for x, y in zip(fa, fb))


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


def _with_arg(args, kwargs):
    return TRAIN_K3 if kwargs.get("with_arg") else None


def pool_max_with_arg_reference(x, kernel, stride, with_arg=False):
    """The plain twins of K3 and of the argmax it writes for the
    backward."""
    from svit_tpu_torch.ops import pool

    out = pool.pool_max_reference(x, kernel, stride)
    return ((out, pool.pool_max_argmax_reference(x, kernel, stride))
            if with_arg else out)


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
        "pool_max_bwd": (pool, "pool_max_bwd",
                         pool.pool_max_backward_reference, "pool_max_bwd"),
        TRAIN_K3: (pool, "_pool_max", pool_max_with_arg_reference,
                   _with_arg),
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
    if name == "pool_max_bwd":
        # g and its argmax taps read once, dx written once; one f32 add
        # per routed element of g
        g, arg, kernel, stride, in_shape = args
        return nb(g) + nb(arg) + 2 * math.prod(in_shape), 0.0, float(
            g.numel())
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
        # x read once, the output written once, and with the argmax one
        # byte more an output element
        x, kernel, stride = args
        B, T, H, W, C = x.shape
        out = B * C * math.prod(
            (d + 2 * (k // 2) - k) // s + 1
            for d, k, s in zip((T, H, W), kernel, stride))
        per_out = 3 if kwargs.get("with_arg") else 2
        return nb(x) + per_out * out, 0.0, float(out * math.prod(kernel))
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
    if name == "pool_max_bwd":
        # F.max_pool3d's backward (its CUDA kernel scatters with atomic
        # adds) on the same cotangent and argmax, as flat input indices
        g, arg, kernel, stride, in_shape = args
        B, T, H, W, C = in_shape
        To, Ho, Wo = g.shape[1:4]
        tap = arg.long()
        kT, kH, kW = kernel
        pos = [torch.arange(n, device=g.device) * s - k // 2
               for n, s, k in zip((To, Ho, Wo), stride, kernel)]
        t = pos[0].view(1, -1, 1, 1, 1) + tap // (kH * kW)
        h = pos[1].view(1, 1, -1, 1, 1) + tap // kW % kH
        w = pos[2].view(1, 1, 1, -1, 1) + tap % kW
        idx = ((t * H + h) * W + w).permute(0, 4, 1, 2, 3).contiguous()
        x = torch.zeros((B, C, T, H, W), dtype=g.dtype, device=g.device)
        gcf = g.permute(0, 4, 1, 2, 3).contiguous()
        pad = tuple(k // 2 for k in kernel)
        return lambda: torch.ops.aten.max_pool3d_with_indices_backward(
            gcf, x, list(kernel), list(stride), list(pad), [1, 1, 1], False,
            idx)
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
                                    pad,
                                    return_indices=kwargs.get("with_arg",
                                                              False))
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
    if name == "pool_max_bwd":
        return f"_pool_max_bwd {tuple(args[4])}"
    if name == TRAIN_K3:
        return f"fused_pool_max with argmax {tuple(args[0].shape)}"
    return "fused_pool_max"


def prologue_passes(s):
    """K1's prologue passes in one forward of block ``s``: its LN
    prologues past the resident panel (the qkv and dense at K = dim, fc1 at
    K = dim_out), each before its K1 launch (the shipped config has
    none)."""
    from svit_tpu_torch.ops.ln_linear import PANEL_K_MAX

    return ((s.dim > PANEL_K_MAX) * (1 + (s.dim != s.dim_out))
            + (s.dim_out > PANEL_K_MAX))


def expected_launches(arch):
    n = collections.Counter()
    for s in arch.blocks:
        n["ln_linear"] += 5 + (s.dim != s.dim_out)
        n["pool_ln"] += 2
        n["pooled_attention"] += 2
        n["pool_max"] += int(np.prod(s.stride_q)) > 1
        if prologue_passes(s):
            n["ln_linear_prologue"] += prologue_passes(s)
    return n


def run_model_phase(model, arch, torch):
    """Phase 3: the three forwards, the gate (``check_kernels_hw``'s
    comparison on its four outputs) and the launch counts.  Returns the
    recorded kernel calls."""
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.tools import check_kernels_hw as gate_tool

    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((BATCH, arch.num_frames, arch.crop_size, arch.crop_size, 3),
                    generator=gen).cuda()
    rec = Recorder()
    originals = rec.patch((mod, attr, name)
                          for name, (mod, attr, _) in wrappers().items())
    try:
        _lib.reset_launch_counts()
        with gate_tool.variant(model, torch.bfloat16, True):
            ek = gate_tool.forward_outputs(model, x)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
    finally:
        Recorder.restore(originals)
    with gate_tool.variant(model, torch.bfloat16, False):
        e16 = gate_tool.forward_outputs(model, x)
    with gate_tool.variant(model, torch.float32, False):
        e32 = gate_tool.forward_outputs(model, x)
    torch.cuda.synchronize()

    result, report = {"launches": launches}, {}
    for key in ek:   # the logits, boxes, contact logits, last grid
        if not bool(torch.isfinite(ek[key].float()).all()):
            raise SystemExit(f"model gate: non-finite {key}")
        ok = gate_tool._gate_one(key, ek[key], e16[key], e32[key], report)
        r = report[key]
        log(f"model gate {key}: err(kernels)={r['err_kernels_vs_f32']:.3e} "
            f"err(plain bf16)={r['err_plain_bf16_vs_f32']:.3e} limit "
            f"{r['limit']:.3e} shape={tuple(ek[key].shape)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"model gate failed on {key}")
        result[key] = {"err_kernels": r["err_kernels_vs_f32"],
                       "err_plain_bf16": r["err_plain_bf16_vs_f32"],
                       "limit": r["limit"]}
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
    last block's grid output feeds nothing: its grid attention, its q pool
    and its skip pool take no backward.  Under ``TPU.REMAT`` the
    recompute runs the video's and the image's forward kernels again:
    ``forwards`` 5."""
    n = collections.Counter()
    for i, s in enumerate(arch.blocks):
        masked = 2 * (s.drop_path > 0)
        strided = int(np.prod(s.stride_q)) > 1
        dead = int(arch.cls_embed_on and i == len(arch.blocks) - 1)
        n["ln_linear"] += forwards * (5 + (s.dim != s.dim_out) - masked)
        n["ln_linear_masked"] += forwards * masked
        n["pool_ln"] += forwards * 2
        n["pooled_attention"] += forwards * 2
        n["pool_max"] += forwards * strided
        n["pool_max_bwd"] += backwards * strided * (1 - dead)
        for k in ("pool_conv", "pool_conv_dx", "pool_conv_dk",
                  "pooled_attention_bwd"):
            n[k] += backwards * (2 - dead)
        if prologue_passes(s):
            n["ln_linear_prologue"] += forwards * prologue_passes(s)
    return n


def expected_gradcam_launches(arch, target):
    """Launches of one Grad-CAM call (``visualization/gradcam.py``) at the
    output of block ``target``: one eval forward, then a backward through
    the later blocks that wants no parameter gradient.  There each
    fused_pool_ln backward runs K2 bare and K6 but no K7 (the filters want
    no gradient), each attention backward K5; with a cls token the last
    block's grid attention, q pool and skip pool take none (as in the
    train step)."""
    n = collections.Counter(expected_launches(arch))
    for i in range(target + 1, len(arch.blocks)):
        dead = int(arch.cls_embed_on and i == len(arch.blocks) - 1)
        n["pool_max_bwd"] += (int(np.prod(arch.blocks[i].stride_q)) > 1
                              and not dead)
        for k in ("pool_conv", "pool_conv_dx", "pooled_attention_bwd"):
            n[k] += 2 - dead
    return n


def train_batch(cfg, torch, videos=TRAIN_VIDEO, images=TRAIN_IMAGE):
    """The train batch of bench.py:171-192, from seed 0, on the card."""
    S, T = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES
    rs = np.random.RandomState(SEED)
    video = {
        "clips": rs.randn(videos, T, S, S, 3).astype(np.float32),
        "labels": rs.randint(0, cfg.MODEL.NUM_CLASSES, videos),
        "weight": np.ones((videos,), np.float32),
    }
    image = {
        "frames": rs.randn(images, 1, S, S, 3).astype(np.float32),
        "haog_bboxes": (rs.rand(images, 1, cfg.SVIT.O, 4) * 0.5
                        + 0.1).astype(np.float32),
        "contact_state": rs.randint(-1, 5, (images, 2)),
        "weight": np.ones((images,), np.float32),
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
    # phase 10 holds the captured step to the same references
    reference = {"losses": losses, "names": names,
                 "flat": {k: flat[k] for k in ("plain_bf16", "plain_f32")}}
    del grads, flat

    want = dict(expected_train_launches(arch))
    log(f"launches in one train step: {result['launches']} (expected {want})")
    if result["launches"] != want:
        raise SystemExit("train step launch counts differ from the step's")

    fns = {n: (getattr(mod, attr), plain)
           for n, (mod, attr, plain, _) in train_wrappers().items()}
    # the masked K1 launches go through the ln_linear wrapper
    table, uses, details = run_kernel_phase(rec, torch, fns, unit="train step")
    result["max_bwd_routes"] = max_bwd_gates(rec, torch)
    max_fwd_gates(rec, torch, TRAIN_K3, "phase 7")
    del rec
    # the argmax instance: one launch in each differentiated forward's skip
    # pools, as many as the backward's
    if table[TRAIN_K3]["launches"] != want["pool_max_bwd"]:
        raise SystemExit(f"train step: {table[TRAIN_K3]['launches']} K3 "
                         f"launches with the argmax, expected "
                         f"{want['pool_max_bwd']}")

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
    return result, table, uses, details, reference


def gemm_rows(rows):
    """The GEMM rows (cuBLAS and CUTLASS kernels) among a summary's
    [kernel name, device ms, launches] rows, each with the
    operand type its kernel name gives.  cuBLAS's Hopper kernels are named
    ``nvjet_<operands><accumulator><output>_...`` (t bf16, s f32, h f16):
    ``torch.mm`` of bf16 operands with an f32 output runs
    ``nvjet_tss_...`` (measured on an H100, torch 2.11)."""
    out = []
    for name, ms, count in rows:
        low = name.lower()
        if low.startswith("nvjet_"):
            kind = {"t": "bf16", "s": "f32", "h": "f16"}.get(low[6], "other")
        elif any(k in low for k in ("gemm", "xmma", "cutlass")):
            kind = ("bf16" if "bf16" in low else "tf32" if "tf32" in low
                    else "f32" if any(k in low for k in ("sgemm", "f32f32"))
                    else "other")
        else:
            continue
        out.append({"name": name, "count": int(count), "ms": ms,
                    "dtype": kind})
    return out


def chrome_trace(prof):
    """A finished profile as ``trace_attrib`` reads it: exported to a
    temporary Chrome trace, which goes once read."""
    import tempfile

    from svit_tpu_torch.tools import trace_attrib as ta

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        return ta.from_profiler(prof, path)
    finally:
        os.remove(path)


def summary_of(trace, top=None):
    """``trace_attrib``'s summary of one profiled call (every owner, or the
    ``top`` busiest), with the hand-written kernels' device ms
    (``kernels_ms``) and their launches by family (``hand_written``)."""
    from svit_tpu_torch.tools import trace_attrib as ta

    s = ta.summarize(trace, 1, top)
    ours = ta.hand_written(s)
    return dict(s, kernels_ms=sum(ms for ms, _ in ours.values()),
                hand_written={f: int(n) for f, (_, n) in ours.items()})


def top_rows(summary, n):
    """A summary's ``n`` busiest kernels as {name, count, ms} rows."""
    return [{"name": k, "count": int(c), "ms": ms}
            for k, ms, c in summary["ops"][:n]]


def tagged_rows(trace, tags):
    """[kernel name, device ms, launches] of the kernels launched inside
    the profiler ranges named ``tags`` (``record_function`` on the host:
    every op below such a range, with the kernels each launched), busiest
    first: ``trace_attrib``'s walk from each kernel's launching op."""
    from svit_tpu_torch.tools import trace_attrib as ta

    acc = collections.defaultdict(lambda: [0.0, 0])
    for k in trace.kernels:
        if ta.within(k.op, tags):
            acc[k.name][0] += k.dur / 1e3
            acc[k.name][1] += 1
    return sorted(([n, ms, c] for n, (ms, c) in acc.items()),
                  key=lambda r: -r[1])


def bias_rows(trace):
    """The rel-pos bias builder's kernels in a profile (forward and the
    backward of its products), with their GEMM rows by operand type."""
    from svit_tpu_torch.ops import attention as ta

    rows = tagged_rows(trace, (ta.BIAS_TAG, ta.BIAS_BWD_TAG))
    by_type = collections.Counter()
    for g in gemm_rows(rows):
        by_type[g["dtype"]] += g["ms"]
    return {"ms": sum(r[1] for r in rows),
            "launches": sum(r[2] for r in rows),
            "gemm_ms_by_type": dict(by_type),
            "top": [{"name": n, "count": c, "ms": m} for n, m, c in rows[:8]]}


def gemm_owners(trace):
    """The ops that launched the profile's f32 GEMM kernels: (the launching
    op, its nearest autograd node or outermost op, its input shapes) ->
    [launches, device ms, whether the op is a product of f32 operands],
    busiest first (``trace_attrib``'s launching op and ``anchor``; a graph
    replay's kernels have no launching op).  ``_mm``'s products take bf16
    operands and an f32 output (``out_dtype``, a third input); cuBLAS may
    still run a tiny one (N = 5, the contact head) on a kernel named as
    f32."""
    from svit_tpu_torch.tools import trace_attrib as ta

    acc = collections.defaultdict(lambda: [0, 0.0, False])
    for k in trace.kernels:
        e = k.op
        if e is None:
            continue
        for g in gemm_rows([(k.name, k.dur / 1e3, 1)]):
            if g["dtype"] != "f32":
                continue
            shapes = e.args.get("Input Dims", [])
            key = f"{e.name} < {ta.anchor(e).name} {shapes}"
            acc[key][0] += 1
            acc[key][1] += g["ms"]
            dtypes = e.args.get("Input type")
            acc[key][2] = e.name in MATMUL_OPS and (
                all(d == "float" for d in dtypes[:2]) if dtypes
                else len(shapes) == 2)
    return sorted(([k, c, ms, f32] for k, (c, ms, f32) in acc.items()),
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
    trace = chrome_trace(prof)
    summary = summary_of(trace)
    device_ms, ours_ms = summary["device_ms"], summary["kernels_ms"]
    idle = max(0.0, 1 - device_ms / step_ms)
    library_pool = sorted({e.key for e in prof.key_averages()
                           if "max_pool3d_with_indices_backward" in e.key})
    log(f"profile train step: events of max_pool3d_with_indices_backward "
        f"(F.max_pool3d's backward): {library_pool or 'none'}")
    if library_pool:
        raise SystemExit("train: K3's backward ran through F.max_pool3d")
    log(f"profile train step: wall {wall_ms:.1f} ms (profiled), device "
        f"{device_ms:.1f} ms, hand-written kernels {ours_ms:.1f} ms, idle "
        f"share {idle:.3f} against the unprofiled {step_ms:.1f} ms")
    for r in top_rows(summary, 16):
        log(f"  {r['ms']:9.3f} ms x{r['count']:<5d} {r['name'][:90]}")
    gemms = gemm_rows(summary["ops"])
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
    bias = bias_rows(trace)
    log(f"rel-pos bias builder (forward and its products' backward): "
        f"{bias['ms']:.3f} ms over {bias['launches']} launches, GEMM rows by "
        f"operand type (ms) "
        f"{ {k: round(v, 3) for k, v in bias['gemm_ms_by_type'].items()} }")
    owners = gemm_owners(trace)
    del trace
    log("f32 GEMM rows of the step by launching op:")
    for key, count, ms, f32 in owners[:8]:
        log(f"  {ms:9.3f} ms x{count:<5d} {'f32 operands ' if f32 else ''}"
            f"{key[:150]}")
    if extras_gemm_rows(owners):   # the extras take bf16 products now
        raise SystemExit(f"train: f32 GEMM rows from plain products: "
                         f"{extras_gemm_rows(owners)[:4]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "kernels_ms": ours_ms,
            "idle_share": idle, "bias_builder": bias, "f32_gemm_owners": owners,
            "ln_linear_bwd_products": dict(products),
            "ln_linear_bwd_tflop": flop[0] / 1e12,
            "gemm_ms_by_type": dict(by_type), "gemms": gemms,
            "top": top_rows(summary, 30)}


def run_kernel_phase(rec, torch, fns, unit="forward"):
    """Phases 4 and 7: replay each recorded call: gate, times, bound.
    ``fns`` maps a counter name to (kernel, plain twin).  Returns the
    totals per kernel and per JAX function, and the per-call rows."""
    table = {n: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                     library_ms=0.0, bytes_ms=0.0, ops_ms=0.0, launches=0)
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
        row["launches"] += count
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


def max_fwd_gates(rec, torch, name, phase):
    """Phases 4 and 7: each recorded K3 forward call (``name``: "pool_max",
    the serving instance, or ``TRAIN_K3``, the instance that writes the
    argmax), held bit for bit against the plain twins and against a rerun
    (the output's bf16 bits and the argmax bytes), on the recorded call, on
    a grid of three levels (ties in most windows) and on an all-negative
    grid (the -inf padding, never a zero, must lose every window)."""
    from svit_tpu_torch.ops import pool

    with_arg = name == TRAIN_K3
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for call in rec.calls.values():
        if call["name"] != name:
            continue
        x, kernel, stride = call["args"][:3]
        kernel, stride = tuple(kernel), tuple(stride)
        shape = tuple(x.shape)
        with torch.inference_mode():
            x3 = torch.randint(0, 3, shape, device="cuda",
                               generator=gen).to(torch.bfloat16)
            neg = (-0.5 - torch.rand(shape, device="cuda", generator=gen)
                   ).to(torch.bfloat16)
            for what, g in (("recorded", x), ("three-level grid", x3),
                            ("all-negative grid", neg)):
                got = pool._pool_max(g, kernel, stride, with_arg=with_arg)
                same = [bits_equal(got, o) for o in (
                    pool_max_with_arg_reference(g, kernel, stride, with_arg),
                    pool._pool_max(g, kernel, stride, with_arg=with_arg))]
                log(f"{name} {shape} ({what}): bit-equal to the plain twin "
                    f"{same[0]}, to a rerun {same[1]}")
                if not all(same):
                    raise SystemExit(f"{phase}: {name} {shape} ({what}) is "
                                     f"not bit-equal")
            del x3, neg


def max_bwd_gates(rec, torch):
    """Phase 7: each recorded ``pool_max_bwd`` call of the train step, its
    route (``ops/pool.py:max_bwd_plan``: the tuned tile or the general
    gather), held bit for bit against the plain twin and against the
    general instance, on the recorded call and on the argmax of a grid of
    three levels (ties in most windows), and a rerun bit-identical.  Every
    call of the main path must take the tuned instance.  Returns {route:
    launches}."""
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.ops import pool

    def bits(t):
        return t.view(torch.int16)

    routes = collections.Counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for call in rec.calls.values():
        if call["name"] != "pool_max_bwd":
            continue
        g, arg, kernel, stride, in_shape = call["args"]
        kernel, stride, in_shape = tuple(kernel), tuple(stride), tuple(in_shape)
        route = pool.max_bwd_plan(in_shape, kernel, stride,
                                  sms=_lib.sm_count(g.device)).route
        with torch.inference_mode():
            x3 = torch.randint(0, 3, in_shape, device="cuda",
                               generator=gen).to(torch.bfloat16)
            arg3 = pool._pool_max(x3, kernel, stride, with_arg=True)[1]
            for what, a in (("recorded", arg), ("three-level grid", arg3)):
                dx = pool.pool_max_bwd(g, a, kernel, stride, in_shape)
                others = (
                    pool.pool_max_backward_reference(g, a, kernel, stride,
                                                     in_shape),
                    pool.pool_max_bwd(g, a, kernel, stride, in_shape,
                                      general=True),
                    pool.pool_max_bwd(g, a, kernel, stride, in_shape))
                same = [torch.equal(bits(dx), bits(o)) for o in others]
                log(f"pool_max_bwd {in_shape} route {route} ({what}): "
                    f"bit-equal to the plain twin {same[0]}, to the general "
                    f"instance {same[1]}, rerun {same[2]}")
                if not all(same):
                    raise SystemExit(f"phase 7: pool_max_bwd {in_shape} "
                                     f"({what}) is not bit-equal")
        routes[route] += call["count"]
    if set(routes) != {"tile"}:
        raise SystemExit(f"phase 7: the step's pool_max_bwd calls took "
                         f"{dict(routes)}, not the tuned instance alone")
    return dict(routes)


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
    summary = summary_of(chrome_trace(prof))
    device_ms, ours_ms = summary["device_ms"], summary["kernels_ms"]
    idle = max(0.0, 1 - device_ms / wall_ms)
    idle_unprofiled = max(0.0, 1 - device_ms / fwd_ms)
    log(f"profile batch {batch}: wall {wall_ms:.2f} ms (profiled), device "
        f"{device_ms:.2f} ms, hand-written kernels {ours_ms:.2f} ms, "
        f"idle share {idle:.3f} (profiled), {idle_unprofiled:.3f} against "
        f"the unprofiled {fwd_ms:.2f} ms")
    top = top_rows(summary, 25)
    for r in top[:12]:
        log(f"  {r['ms']:9.3f} ms x{r['count']:<5d} {r['name'][:90]}")
    return {"batch": batch, "wall_ms": wall_ms, "device_ms": device_ms,
            "kernels_ms": ours_ms, "idle_share": idle,
            "idle_share_unprofiled": idle_unprofiled, "top": top}


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


def make_ssv2_tree(root, num_classes, videos=TEST_VIDEOS, frames=TEST_FRAMES,
                   haog=False):
    """A standard-split SSv2 tree in the layout ``data/ssv2.py`` reads:
    ``videos`` videos of ``frames`` JPEG frames at 427 x 240 (random
    pixels through PIL, from seed 0), labels under ``num_classes``, the
    label and split JSONs and a box-tracking JSON per video: one hand box a
    frame, or with ``haog`` two hands and an object (drawn from seed 1, as
    ``tests/fixtures.py`` draws them), the boxes ``ssv2_frames`` reads.
    Video ids are kept out of the repo's ``empty_bbox_*.json`` skip lists.
    Returns (ids, labels)."""
    from PIL import Image

    rng = np.random.RandomState(SEED)
    box_rng = np.random.RandomState(SEED + 1)
    skip = set()
    for split in ("train", "val"):
        with open(os.path.join(REPO, "data", "ssv2",
                               f"empty_bbox_{split}.json")) as f:
            skip |= set(json.load(f))
    vids = [str(9000000 + i) for i in range(videos)]
    assert not skip & set(vids)
    labels = rng.randint(0, num_classes, videos)
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
        tracked = []
        for t in range(frames):
            name = "%04d.jpg" % (t + 1)
            Image.fromarray(rng.randint(0, 255, (H, W, 3), np.uint8)).save(
                os.path.join(root, "frames", v, name))
            x1, y1 = float(rng.uniform(0, W / 2)), float(rng.uniform(0, H / 2))
            boxes = [{"standard_category": "hand",
                      "box2d": {"x1": x1, "y1": y1, "x2": x1 + 40.0,
                                "y2": y1 + 40.0}}]
            if haog:
                boxes = []
                for cat in ("hand", "hand", "object"):
                    x1 = float(box_rng.uniform(0, W * 0.5))
                    y1 = float(box_rng.uniform(0, H * 0.5))
                    boxes.append({"standard_category": cat, "box2d": {
                        "x1": x1, "y1": y1,
                        "x2": x1 + float(box_rng.uniform(8, W * 0.4)),
                        "y2": y1 + float(box_rng.uniform(8, H * 0.4))}})
            tracked.append({"name": f"frames/{v}/{name}", "labels": boxes})
        with open(os.path.join(root, "bbox_jsons", f"{int(v)}.json"),
                  "w") as f:
            json.dump(tracked, f)
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

    from svit_tpu_torch.engine import graphs
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
        loop["step"] = args[0]
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
                # the test step is a graph (engine/graphs.py): its warm-up
                # and capture launch from the host, its replays do not
                per = dict(expected_launches(arch))
                want = {k: v * (graphs.WARMUP + 1) for k, v in per.items()}
                (entry,) = loop["step"].entries.values()
                log(f"test launches: {launches} from the host (expected "
                    f"{want}: warm-up and capture); the graph captured "
                    f"{entry.launches} and replayed {entry.replays} times "
                    f"for {loop['batches']} batch-64 forwards")
                if launches != want or entry.launches != per or \
                        entry.replays != loop["batches"]:
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


def run_wide_bias(torch, size=224):
    """K4 and K5 past R = 48 at full width: a block without k|v pooling at
    16 x ``size`` (its key grid 8 x (size / 4)^2: R = 120 at 224, the wide
    instance; R = 136 at 256, the chunked one) in a two-block SViT-B/16 at
    batch 1, forward and backward through K4 and K5, the logits and the
    global gradient vector gated against the plain twins.  The kernel run's
    grid-query calls of K4 and K5 are replayed: gated, timed beside the
    plain versions, SDPA (forward and backward) and the bound."""
    from svit_tpu_torch.config import get_cfg
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.ops import attention as ta

    cfg = get_cfg()
    cfg.merge_from_file(CFG)
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = size
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
    rec = Recorder()
    for name, m in zip(RUNS, models):
        originals = []
        if name == "kernels":
            originals = rec.patch(
                (ta, attr, lambda a, k, n=n: n if a[2] is not None else None)
                for attr, n in (("pooled_attention_fwd", "pooled_attention"),
                                ("pooled_attention_bwd",
                                 "pooled_attention_bwd")))
        try:
            torch.cuda.synchronize()
            _lib.reset_launch_counts()
            logits, _ = m(x, train=False)
            (logits.float() * cot).sum().backward()
            torch.cuda.synchronize()
            launches[name] = dict(_lib.LAUNCHES)
        finally:
            Recorder.restore(originals)
        values[name] = logits.detach().float().flatten().cpu()
        grads[name] = torch.cat([p.grad.float().flatten() for p in
                                 m.parameters() if p.grad is not None]).cpu()
    del models
    torch.cuda.empty_cache()
    want_rk = ta.RK_CHUNKED if R > 16 * ta.RK_WIDE else ta.RK_WIDE
    what = "chunked" if want_rk == ta.RK_CHUNKED else "wide"
    log(f"{what} bias: first block's key grid {grid} (R = {R}, the plan's "
        f"rk {plan.rk}); kernel launches {launches['kernels']}")
    if plan.rk != want_rk or R <= 48:
        raise SystemExit(f"{what} bias: R = {R} takes rk {plan.rk}, not "
                         f"the {what} instance")
    if not (launches["kernels"].get("pooled_attention", 0) >= 4 and
            launches["kernels"].get("pooled_attention_bwd", 0) >= 2):
        raise SystemExit(f"{what} bias: K4 or K5 did not launch")
    result = {"R": R, "rk": plan.rk, "size": size,
              "launches": launches["kernels"]}
    gate(f"{what}_bias_logits", values, result)
    gate(f"{what}_bias_grads", grads, result)
    result["replay"] = replay_bias_calls(rec, torch, R, what)
    del rec
    torch.cuda.empty_cache()
    return result


def replay_bias_calls(rec, torch, R, what):
    """Phase 4's replay of the recorded K4 and K5 calls whose bias has R
    columns: gated, timed beside the plain versions, SDPA and the
    bound."""
    from svit_tpu_torch.ops import attention as ta

    fns = {n: (getattr(ta, attr), plain) for n, attr, plain in (
        ("pooled_attention", "pooled_attention_fwd",
         ta.pooled_attention_reference),
        ("pooled_attention_bwd", "pooled_attention_bwd",
         ta.pooled_attention_bwd_reference))}
    rec.calls = collections.OrderedDict(
        (k, c) for k, c in rec.calls.items() if c["args"][2].shape[-1] == R)
    table, uses, details = run_kernel_phase(rec, torch, fns,
                                            unit=f"{what} bias call")
    return {"table": table, "uses": uses, "calls": details}


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
    result["wide_bias"] = run_wide_bias(torch, 224)
    result["chunked_bias"] = run_wide_bias(torch, 256)
    return result, result["multiview"]["kernels"]["launches_per_forward"]


# ---------------------------------------------------------------------------
# Phase 9: the training entry point, engine.train.train(cfg)
# ---------------------------------------------------------------------------

# 8 steps an epoch at video batch 7: 6 within each epoch that are neither
# its first (warm-up, loader start) nor its last (checkpoint, eval epoch)
TRAIN_TREE_VIDEOS = 56
# configs/ssv2.yaml's 7 video ranks + 1 image rank give the loss weights 7/8
# and 1/8; assert_and_infer_cfg wants the video batch divisible by the 7
TRAINER_VIDEO, TRAINER_IMAGE = 7, 8
# the main path's kernel counters, every one of which a train run launches
PATH_COUNTERS = ("ln_linear", "ln_linear_masked", "pool_ln", "pool_max",
                 "pooled_attention", "pooled_attention_bwd", "pool_conv",
                 "pool_conv_dx", "pool_conv_dk")
# ops whose f32 GEMM rows would be a plain product on upcast operands (the
# extras' old plain twins); cuDNN's f32 convolution of the object-token
# multiplier is f32 in JAX too
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
              "aten::linear")


def trainer_cfg(root, out, max_epoch):
    """configs/ssv2.yaml at full size on the tree at ``root`` (its
    augmentation, bf16, the kernels), with the consistency term, two
    checkpoints' worth of epochs and a log, eval and checkpoint every
    epoch."""
    from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(CFG)
    cfg.SSV2.DATA_ROOT = root
    cfg.OUTPUT_DIR = out
    cfg.TRAIN.MIXED_PRECISION = True
    cfg.TPU.USE_PALLAS_ATTENTION = True
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    cfg.TRAIN.BATCH_SIZE = TRAINER_VIDEO
    cfg.IMAGE_TRAIN.BATCH_SIZE = TRAINER_IMAGE
    cfg.SOLVER.MAX_EPOCH = max_epoch
    cfg.TRAIN.EVAL_PERIOD = 1
    cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.LOG_PERIOD = 1
    return assert_and_infer_cfg(cfg)


class TrainerSpy:
    """Patches ``engine.train`` for one run of ``train(cfg)``: every Trainer
    made, and around every call of its captured step
    (``engine/graphs.py:CapturedTrainStep``) its start time, its host
    launches (the counter's difference over the call: the warm-up and the
    capture at a graph's first call, none at a replay), a copy of its
    metric vector (the graph's output is overwritten by the next replay),
    and at ``profile_at`` a profile of the step; the first step's inputs
    with ``capture``; a SIGTERM to this process after step
    ``sigterm_after``; the epochs' (cur_epoch, start_iter), the eval stats
    and the resumed state."""

    def __init__(self, torch, profile_at=None, capture=False,
                 sigterm_after=None, on_resume=None):
        self.torch = torch
        self.profile_at, self.capture = profile_at, capture
        self.sigterm_after, self.on_resume = sigterm_after, on_resume
        self.trainers, self.steps, self.epochs, self.evals = [], [], [], []
        self.first, self.profile = None, None

    def __enter__(self):
        from svit_tpu_torch.engine import train as ttrain
        from svit_tpu_torch.ops import _lib

        spy, torch = self, self.torch
        self._saved = [(ttrain, "Trainer", ttrain.Trainer),
                       (ttrain.graphs, "CapturedTrainStep",
                        ttrain.graphs.CapturedTrainStep),
                       (ttrain, "train_epoch", ttrain.train_epoch),
                       (ttrain, "eval_epoch", ttrain.eval_epoch),
                       (ttrain.cu, "load_train_state",
                        ttrain.cu.load_train_state)]
        base_trainer, base_step, epoch_fn, eval_fn, load_fn = (
            o for _, _, o in self._saved)

        class Trainer(base_trainer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                spy.trainers.append(self)

        class Captured(base_step):
            def __call__(self, state, video, image, gen):
                i = len(spy.steps)
                if spy.capture and i == 0:
                    spy.first = dict(
                        params={n: t.detach().cpu().clone() for n, t in
                                state.model.state_dict().items()},
                        video={n: t.clone() for n, t in video.items()},
                        image={n: t.clone() for n, t in image.items()},
                        seed=gen.initial_seed())
                call = super().__call__
                before = _lib.LAUNCHES.copy()
                t0 = time.perf_counter()
                if i == spy.profile_at:
                    spy.profile = profile_trainer_step(
                        torch, lambda: call(state, video, image, gen))
                    out = spy.profile.pop("out")
                else:
                    out = call(state, video, image, gen)
                spy.steps.append(dict(t0=t0, metrics=out[1].clone(),
                                      profiled=i == spy.profile_at,
                                      graphs=len(self.entries),
                                      launches=dict(_lib.LAUNCHES - before)))
                if spy.sigterm_after is not None and \
                        len(spy.steps) == spy.sigterm_after:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

        def epoch(cfg, trainer, state, meter, cur_epoch, start_iter=0,
                  guard=None):
            spy.epochs.append((cur_epoch, start_iter))
            return epoch_fn(cfg, trainer, state, meter, cur_epoch,
                            start_iter=start_iter, guard=guard)

        def evaluate(*a, **k):
            stats = eval_fn(*a, **k)
            spy.evals.append(stats)
            return stats

        def load(path, state, *mesh):
            out = load_fn(path, state, *mesh)
            if spy.on_resume is not None:
                spy.on_resume(path, state)
            return out

        for (mod, attr, _), new in zip(self._saved, (Trainer, Captured, epoch,
                                                     evaluate, load)):
            setattr(mod, attr, new)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        return False


def profile_trainer_step(torch, call):
    """One Trainer step under torch.profiler: its wall and device time by
    kernel, and the ops that launched its f32 GEMM rows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = chrome_trace(prof)
    summary = summary_of(trace)
    return {"out": out, "wall_ms": wall_ms,
            "device_ms": summary["device_ms"],
            "kernels_ms": summary["kernels_ms"],
            "families": summary["hand_written"],
            "f32_gemm_owners": gemm_owners(trace),
            "top": top_rows(summary, 16)}


def extras_gemm_rows(owners):
    """The f32 GEMM rows of a matrix product of f32 operands (the plain
    twins' upcast, which the extras took before)."""
    return [o for o in owners if o[3]]


def state_equal(torch, a, b):
    """(params equal, optimizer state equal, what differs first) of two
    train states, bit for bit."""
    for (n, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        if not torch.equal(x, y):
            return False, f"param {n}"
    sa, sb = (s.tx.optimizer.state_dict()["state"] for s in (a, b))
    if sa.keys() != sb.keys() or not sa:
        return False, "optimizer state keys"
    for i in sa:
        for k, v in sa[i].items():
            if not torch.equal(torch.as_tensor(v), torch.as_tensor(sb[i][k])):
                return False, f"optimizer state {i}.{k}"
    return True, None


def nondeterministic_op(message):
    """The op a warning of ``use_deterministic_algorithms(warn_only=True)``
    names."""
    if "does not have a deterministic implementation" in message:
        return message.split(" does not have")[0]
    if "CuBLAS" in message or "CUBLAS" in message:
        return "cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)"
    return message[:120]


def step_tensors(model):
    """Every gradient and parameter of a model after a step (copies)."""
    return {**{f"grad {n}": p.grad.detach().clone()
               for n, p in model.named_parameters()},
            **{f"param {n}": p.detach().clone()
               for n, p in model.named_parameters()}}


def runs_equal(torch, a, b, metrics_a=None, metrics_b=None):
    """Whether two steps' tensors (``step_tensors``) and metrics are equal
    bit for bit; and a line that says so, naming what differs."""
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if metrics_a is not None and metrics_a != metrics_b:
        differ.insert(0, "metrics")
    return not differ, (f"loss, metrics, {len(a) // 2} gradients and "
                        f"parameters bit-equal" if not differ else
                        f"{len(differ)} differ: {differ[:6]}")


def first_step_gate(torch, cfg, first, trainer_metrics, names):
    """The Trainer's first step against ``make_train_step`` from the same
    initial parameters, batch and generator seed: kernels in bf16 (twice,
    to show how far the step differs from itself, then once under
    ``torch.use_deterministic_algorithms(warn_only=True)``, which names the
    ops that have no deterministic implementation, and once with cuDNN held
    to deterministic algorithms, shown beside the default's bits), plain in
    bf16 and plain in f32; the loss and the gradient norm under phase 7's
    gate, and the Trainer's values beside the kernel steps'."""
    import warnings

    from svit_tpu_torch.engine import steps
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.models.optimizer import construct_optimizer

    got = dict(zip(names, trainer_metrics.float().cpu().tolist()))
    values, nondeterministic, runs = {}, set(), {}
    for name, dtype, kernels in (("kernels", torch.bfloat16, True),
                                 ("kernels_again", torch.bfloat16, True),
                                 ("kernels_deterministic", torch.bfloat16,
                                  True),
                                 ("kernels_cudnn_deterministic",
                                  torch.bfloat16, True),
                                 ("plain_bf16", torch.bfloat16, False),
                                 ("plain_f32", torch.float32, False)):
        model, _ = build_model(cfg, dtype=dtype, use_kernels=kernels,
                               train=True)
        model.load_state_dict(first["params"])
        state = steps.create_train_state(
            model, construct_optimizer(cfg, model, 1000)[0])
        step = steps.make_train_step(
            model, get_loss_func(cfg), state.tx, video_weight=7 / 8,
            image_weight=1 / 8, with_image=True, with_consistency=True)
        gen = torch.Generator(device="cuda").manual_seed(first["seed"])
        strict = name == "kernels_deterministic"
        cudnn_was = torch.backends.cudnn.deterministic
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(strict, warn_only=True)
            torch.backends.cudnn.deterministic = (
                name == "kernels_cudnn_deterministic")
            try:
                _, m = step(state, first["video"], first["image"], gen)
                values[name] = {k: float(v) for k, v in m.items()}
            finally:
                torch.use_deterministic_algorithms(False)
                torch.backends.cudnn.deterministic = cudnn_was
        if strict:
            nondeterministic = sorted({nondeterministic_op(str(w.message))
                                       for w in caught
                                       if "eterministic" in str(w.message)})
        if name.startswith("kernels"):
            runs[name] = step_tensors(model)
        del model, state, step
        torch.cuda.empty_cache()
    log(f"phase 9 first step: ops without a deterministic implementation: "
        f"{nondeterministic or 'none'}")
    same = {k: runs_equal(torch, runs["kernels"], runs[k], values["kernels"],
                          values[k])
            for k in ("kernels_again", "kernels_deterministic",
                      "kernels_cudnn_deterministic")}
    # the global flag may switch ops to other (deterministic) algorithms,
    # so the third run is shown beside the first, not held to it
    deterministic = same["kernels_again"][0] and not nondeterministic
    log(f"phase 9 first step: make_train_step twice from one state: "
        f"{same['kernels_again'][1]}; under use_deterministic_algorithms: "
        f"{same['kernels_deterministic'][1]}; with cuDNN's deterministic "
        f"algorithms: {same['kernels_cudnn_deterministic'][1]}")
    log(f"phase 9 first step deterministic: {str(deterministic).lower()}")
    if not deterministic:
        raise SystemExit("phase 9: the train step is not deterministic")
    result = {"trainer": got, "runs": values,
              "nondeterministic_ops": nondeterministic,
              "deterministic": deterministic,
              "cudnn_deterministic_same_bits":
                  same["kernels_cudnn_deterministic"][0]}
    for key in ("loss", "grad_norm"):
        v32 = values["plain_f32"][key]
        err_t = abs(got[key] - v32) / abs(v32)
        err_k = abs(values["kernels"][key] - v32) / abs(v32)
        err_p = abs(values["plain_bf16"][key] - v32) / abs(v32)
        ok = max(err_t, err_k) <= TOL_RATIO * err_p + TOL_ABS
        log(f"phase 9 first step {key}: trainer {got[key]:.6f} "
            f"make_train_step kernels {values['kernels'][key]:.6f} plain "
            f"bf16 {values['plain_bf16'][key]:.6f} plain f32 {v32:.6f}; "
            f"err(trainer)={err_t:.3e} err(kernels)={err_k:.3e} "
            f"err(plain bf16)={err_p:.3e} {'ok' if ok else 'FAIL'}")
        k1, k2 = values["kernels"][key], values["kernels_again"][key]
        self_diff = abs(k2 - k1) / abs(k1)
        trainer_diff = abs(got[key] - k1) / abs(k1)
        kd = values["kernels_deterministic"][key]
        log(f"phase 9 first step {key}: make_train_step again "
            f"{k2:.6f}, deterministic {kd:.6f}; relative difference kernels "
            f"to kernels again {self_diff:.3e}, trainer to kernels "
            f"{trainer_diff:.3e}")
        result[f"gate_{key}"] = {"err_trainer": err_t, "err_kernels": err_k,
                                 "err_plain_bf16": err_p,
                                 "kernels_self_diff": self_diff,
                                 "trainer_to_kernels_diff": trainer_diff}
        if not ok:
            raise SystemExit(f"phase 9: the Trainer's first step fails the "
                             f"gate on {key}")
    return result


def run_trainer_phase(torch):
    """Phase 9: ``engine.train.train(cfg)`` on a synthetic SSv2 tree with
    HAOG boxes, at configs/ssv2.yaml's full size.  Returns its results and
    the launches of the first run."""
    import tempfile

    from svit_tpu_torch.engine import graphs
    from svit_tpu_torch.engine import train as ttrain
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.utils import checkpoint as cu

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ssv2")
        cfg = trainer_cfg(root, os.path.join(tmp, "run"), 2)
        t0 = time.perf_counter()
        vids, _ = make_ssv2_tree(root, cfg.MODEL.NUM_CLASSES,
                                 TRAIN_TREE_VIDEOS, TEST_FRAMES, haog=True)
        log(f"phase 9 tree: {len(vids)} videos x {TEST_FRAMES} JPEG frames at "
            f"{SSV2_FRAME[0]} x {SSV2_FRAME[1]} with hand and object boxes, "
            f"written in {time.perf_counter() - t0:.1f} s; video batch "
            f"{TRAINER_VIDEO}, image batch {TRAINER_IMAGE} "
            f"({cfg.IMAGE_TRAIN.DATASETS}), AUG {cfg.AUG.AA_TYPE} "
            f"re_prob {cfg.AUG.RE_PROB}, {cfg.DATA_LOADER.NUM_WORKERS} "
            f"loader processes")

        # run A: two epochs from scratch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        with TrainerSpy(torch, profile_at=2, capture=True) as a:
            state_a = ttrain.train(cfg)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        trainer = a.trainers[0]
        names = list(trainer.metric_names)
        arch = trainer.arch
        spe = trainer.steps_per_epoch
        log(f"phase 9 run A: train() {wall_a:.1f} s, {len(a.steps)} steps "
            f"({spe} an epoch), epochs {a.epochs}, step {state_a.step}, "
            f"loss weights {trainer.video_weight:.4f} / "
            f"{trainer.image_weight:.4f}, launches {launches}")
        if len(a.steps) != 2 * spe or state_a.step != 2 * spe:
            raise SystemExit("phase 9: run A took the wrong number of steps")
        if (trainer.video_weight, trainer.image_weight) != (7 / 8, 1 / 8):
            raise SystemExit("phase 9: loss weights are not 7/8 and 1/8")
        missing = [c for c in PATH_COUNTERS if not launches.get(c)]
        if missing:
            raise SystemExit(f"phase 9: kernels not launched: {missing}")
        metrics = torch.stack([s["metrics"] for s in a.steps]).cpu()
        losses = metrics[:, names.index("loss")].tolist()
        log(f"phase 9 step losses {[round(v, 4) for v in losses]}")
        if not bool(torch.isfinite(metrics).all()):
            raise SystemExit("phase 9: a non-finite step metric")
        # the step is a graph: its first call warms up and captures (host
        # launches (WARMUP + 1) times the step's), every later call replays
        # (none from the host); the graph keeps the capture's counts
        want = dict(expected_train_launches(arch))
        (entry,) = trainer.step_fn.entries.values()
        first_call = {k: v * (graphs.WARMUP + 1) for k, v in want.items()}
        for i, st in enumerate(a.steps):
            if st["launches"] != (first_call if i == 0 else {}):
                raise SystemExit(f"phase 9: step {i} launched "
                                 f"{st['launches']} from the host")
        if entry.launches != want or entry.replays != len(a.steps):
            raise SystemExit(f"phase 9: the graph holds {entry.launches} "
                             f"over {entry.replays} replays, not {want}")
        log(f"phase 9 launches: the step's graph captured {want}; its first "
            f"call launched {graphs.WARMUP + 1} times that from the host "
            f"(warm-up and capture), its {entry.replays} replays none; the "
            f"profiled replay's hand-written kernel events "
            f"{a.profile['families']}")
        ckpts = sorted(os.listdir(cu.checkpoint_dir(cfg.OUTPUT_DIR)))
        log(f"phase 9 checkpoints: {ckpts}")
        if ckpts != ["checkpoint_epoch_00001", "checkpoint_epoch_00002"]:
            raise SystemExit("phase 9: a checkpoint per epoch is missing")
        if len(a.evals) != 2 or not all(
                np.isfinite(v) for st in a.evals for k, v in st.items()
                if "loss" in k):
            raise SystemExit(f"phase 9: eval epochs {a.evals}")
        log(f"phase 9 eval stats (epoch 2): "
            + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in a.evals[-1].items()))
        # a replay's kernels show no launching op: phases 7 and 10 hold the
        # eager step's f32 GEMM rows to their owners
        prof = a.profile
        log(f"phase 9 profiled step (a replay): wall {prof['wall_ms']:.1f} "
            f"ms, device {prof['device_ms']:.1f} ms, hand-written kernels "
            f"{prof['kernels_ms']:.1f} ms")
        for row in prof["top"][:8]:
            log(f"  {row['ms']:9.3f} ms x{row['count']:<5d} "
                f"{row['name'][:90]}")
        # per-step wall (start to start: the step, the metric flush, the
        # next batch's data wait); the steady steps are neither an epoch's
        # first (warm-up; its data wait holds the loader start) nor its last
        # (the checkpoint, the eval epoch and the next epoch's loader start)
        # nor the profiled one
        starts = [st["t0"] for st in a.steps]
        walls = [(starts[i + 1] - starts[i]) * 1e3
                 for i in range(len(starts) - 1)]
        steady = [w for i, w in enumerate(walls) if i % spe not in
                  (0, spe - 1) and not a.steps[i]["profiled"]]
        # the data wait before each step but an epoch's first
        data_ms = [d * 1e3 for d in trainer.data_seconds]
        steady_data = [d for i, d in enumerate(data_ms) if i % spe]
        wall_q = statistics.quantiles(steady, n=4)
        data_q = statistics.quantiles(steady_data, n=4)
        wall_ms = wall_q[1]
        idle = max(0.0, 1 - prof["device_ms"] / wall_ms)
        log(f"phase 9 per step: wall {wall_ms:.1f} ms (median of "
            f"{len(steady)} steady steps, quartiles {wall_q[0]:.1f} / "
            f"{wall_q[2]:.1f}; all {[round(w, 1) for w in walls]}), data "
            f"{data_q[1]:.1f} ms (median of {len(steady_data)}, quartiles "
            f"{data_q[0]:.1f} / {data_q[2]:.1f}; all "
            f"{[round(d, 1) for d in data_ms]}), device "
            f"{prof['device_ms']:.1f} ms (profiled step), idle share "
            f"{idle:.3f} against the steady wall, peak memory "
            f"{peak / 2 ** 30:.2f} GiB; {card_line()}")
        result["run_a"] = {"wall_s": wall_a, "steps": len(a.steps),
                           "epochs": a.epochs, "losses": losses,
                           "launches": launches, "per_step_launches": want,
                           "checkpoints": ckpts, "evals": a.evals,
                           "step_wall_ms": walls, "steady_wall_ms": steady,
                           "wall_ms": wall_ms, "wall_quartiles_ms": wall_q,
                           "data_ms": data_ms, "data_quartiles_ms": data_q,
                           "idle_share": idle, "peak_bytes": peak,
                           "profile": prof}
        result["first_step"] = first_step_gate(torch, cfg, a.first,
                                               a.steps[0]["metrics"], names)
        del a, trainer

        # run B: MAX_EPOCH 3 resumes at epoch 2 from the state run A saved
        seen = {}

        def on_resume(path, state):
            seen["path"] = path
            seen["equal"] = state_equal(torch, state, state_a)

        cfg3 = trainer_cfg(root, cfg.OUTPUT_DIR, 3)
        with TrainerSpy(torch, on_resume=on_resume) as b:
            state_b = ttrain.train(cfg3)
        log(f"phase 9 run B: resumed from {os.path.basename(seen['path'])}, "
            f"state equal bit for bit: {seen['equal']}, epochs {b.epochs}, "
            f"step {state_b.step}")
        if not seen["equal"][0] or b.epochs != [(2, 0)] or \
                state_b.step != 3 * spe:
            raise SystemExit("phase 9: the auto-resume at epoch 2 failed")
        result["resume"] = {"from": os.path.basename(seen["path"]),
                            "epochs": b.epochs, "step": state_b.step}
        del b, state_b, state_a
        torch.cuda.empty_cache()

        # runs C and D: SIGTERM after step 2, then the resume at iter 2
        cfg1 = trainer_cfg(root, os.path.join(tmp, "preempt"), 1)
        with TrainerSpy(torch, sigterm_after=2) as c:
            state_c = ttrain.train(cfg1)
        last = cu.get_last_checkpoint(cfg1.OUTPUT_DIR)
        with TrainerSpy(torch) as d:
            state_d = ttrain.train(cfg1)
        log(f"phase 9 SIGTERM after step 2: stopped at step {state_c.step}, "
            f"saved {os.path.basename(last)}; the rerun's epochs {d.epochs}, "
            f"step {state_d.step}")
        if not last.endswith("checkpoint_epoch_00000_step_00000002") or \
                state_c.step != 2 or d.epochs != [(0, 2)] or \
                state_d.step != spe:
            raise SystemExit("phase 9: the mid-epoch resume failed")
        result["preemption"] = {"saved": os.path.basename(last),
                                "resumed": d.epochs, "step": state_d.step}
        del c, d, state_c, state_d
        torch.cuda.empty_cache()

        # run E: one epoch with the on-device augmentation (uint8 frames at
        # TPU.RAW_SIZE, augmented inside the captured step)
        cfge = trainer_cfg(root, os.path.join(tmp, "device_aug"), 1)
        cfge.TPU.DEVICE_AUG = True
        t0 = time.perf_counter()
        with TrainerSpy(torch, profile_at=2) as e:
            state_e = ttrain.train(cfge)
        torch.cuda.synchronize()
        wall_e = time.perf_counter() - t0
        trainer_e = e.trainers[0]
        metrics = torch.stack([st["metrics"] for st in e.steps]).cpu()
        starts = [st["t0"] for st in e.steps]
        walls = [(starts[i + 1] - starts[i]) * 1e3
                 for i in range(len(starts) - 1)]
        data_ms = [d * 1e3 for d in trainer_e.data_seconds]
        log(f"phase 9 run E (TPU.DEVICE_AUG, raw {cfge.TPU.RAW_SIZE} px): "
            f"train() {wall_e:.1f} s, {len(e.steps)} steps, losses "
            f"{[round(v, 4) for v in metrics[:, names.index('loss')].tolist()]}"
            f", step wall ms {[round(w, 1) for w in walls]} (median of the "
            f"non-first {statistics.median(walls[1:]):.1f}), data ms "
            f"{[round(d, 1) for d in data_ms]} (median of the non-first "
            f"{statistics.median(data_ms[1:]):.1f}); the profiled replay's "
            f"device time {e.profile['device_ms']:.1f} ms (run A's "
            f"{prof['device_ms']:.1f}); {card_line()}")
        if len(e.steps) != spe or state_e.step != spe or \
                not bool(torch.isfinite(metrics).all()):
            raise SystemExit("phase 9: the TPU.DEVICE_AUG epoch failed")
        result["device_aug"] = {"wall_s": wall_e, "steps": len(e.steps),
                                "step_wall_ms": walls, "data_ms": data_ms,
                                "device_ms": e.profile["device_ms"],
                                "losses": metrics[:, names.index(
                                    "loss")].tolist()}
        del e, trainer_e, state_e
    torch.cuda.empty_cache()
    return result, launches


# ---------------------------------------------------------------------------
# Phase 10: the compiled steps (engine/graphs.py): CUDA graphs of the
# serving forward, the train step and the eval and test steps
# ---------------------------------------------------------------------------

TIMED = 5
TEST_BATCH = 64


def time_calls(fn, torch, n):
    """Wall ms of ``n`` calls, each ended by a synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def profile_call(fn, torch, model=None):
    """One call traced by ``trace_forward.profile_calls`` (no call before
    it; ``model``'s module scopes if given) and summarized by
    ``trace_attrib``: its device time, by kernel, family and owner, and
    the hand-written kernels' launch events by family."""
    import tempfile

    from svit_tpu_torch.tools import trace_forward as tf

    with tempfile.TemporaryDirectory() as tmp:
        s = summary_of(tf.profile_calls(
            fn, 1, torch.device("cuda"), os.path.join(tmp, "call.json"),
            model, warmup=0))
    return {"device_ms": s["device_ms"], "kernels_ms": s["kernels_ms"],
            "events": int(sum(n for _, _, n in s["ops"])),
            "families": s["hand_written"], "top": top_rows(s, 12),
            "summary": dict(s, ops=s["ops"][:40])}


# each launch of these wrappers adds one node of one of these kernels to a
# graph (K5 and K7 add a reduce kernel besides, on some launches only)
NODE_KERNELS = (
    (("ln_linear", "ln_linear_masked"), ("ln_linear_kernel",)),
    (("pool_ln", "pool_conv", "pool_conv_dx"),
     ("pool_ln_kernel", "halo_gen_kernel", "dx_kernel")),
    (("pool_max",), ("pool_max_kernel",)),
    # the main path's calls all take the tuned instance
    (("pool_max_bwd",), ("pool_max_bwd_tile_kernel",)),
    (("pooled_attention",), ("attn_fwd_kernel",)),
    (("pooled_attention_bwd",), ("attn_bwd_q_kernel",)),
    (("pool_conv_dk",), ("conv_dk_kernel", "dk_gen_kernel")),
)
def node_graph():
    """The port's ``graphs.CudaGraph``, keeping its ``cudaGraph_t`` after
    the capture so that ``kernel_nodes`` can list it; the replay
    instantiates it as usual."""
    import torch
    from svit_tpu_torch.engine import graphs

    g = graphs.CudaGraph.__new__(graphs.CudaGraph)
    g.graph = torch.cuda.CUDAGraph(keep_graph=True)
    g.graph.enable_debug_mode()
    return g


def kernel_nodes(graph):
    """The hand-written kernels among a ``node_graph``'s nodes, by kernel:
    ``cudaGraphDebugDotPrint`` writes one line per node, a kernel node's
    with its (mangled) name.  A replay runs every node."""
    from svit_tpu_torch.tools import trace_attrib as ta

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    path = os.path.join(REPO, "chiprun_out", f"graph_{os.getpid()}.dot")
    graph.graph.debug_dump(path)
    nodes = collections.Counter()
    try:
        with open(path) as f:
            for line in f:
                name = ta.kernel_name(line) if "topoId" in line else None
                if name is not None:
                    nodes[name] += 1
    finally:
        os.remove(path)
    return dict(nodes)


def check_nodes(what, nodes, launches):
    """The graph holds one node for each launch the capture counted: both
    counts are exact, where a profile of a replay loses a kernel's record
    now and then (the same one in every profile of a call)."""
    for counters, kernels in NODE_KERNELS:
        want = sum(launches.get(c, 0) for c in counters)
        have = sum(nodes.get(k, 0) for k in kernels)
        if have != want:
            raise SystemExit(f"phase 10 {what}: the graph holds {have} "
                             f"{'/'.join(kernels)} nodes, the capture "
                             f"launched {want} ({'+'.join(counters)})")


def eager_and_graph(what, eager_fn, graph_fn, torch, graph, launches,
                    model, n=TIMED):
    """Timed and profiled eager calls and replays of one path in turns
    (eager, graph, graph, eager); the medians, device times and idle
    shares, and each profile's ``trace_attrib`` summary (the eager call's
    by ``model``'s modules).  The graph's kernel nodes must match the
    capture's ``launches`` (``check_nodes``), and a profiled replay must
    show every hand-written family the graph holds, never more often."""
    from svit_tpu_torch.tools import trace_attrib as ta

    times = {"eager": [], "graph": []}
    for kind in ("eager", "graph", "graph", "eager"):
        fn = eager_fn if kind == "eager" else graph_fn
        times[kind] += time_calls(fn, torch, n)
    out = {}
    for kind, fn in (("eager", eager_fn), ("graph", graph_fn)):
        prof = profile_call(fn, torch, model if kind == "eager" else None)
        ms = statistics.median(times[kind])
        out[kind] = dict(prof, ms=times[kind], median_ms=ms,
                         idle_share=max(0.0, 1 - prof["device_ms"] / ms))
    e, g = out["eager"], out["graph"]
    if not (e["device_ms"] > 0 and g["device_ms"] > 0):
        raise SystemExit(f"phase 10 {what}: a profiled call shows no device "
                         f"time")
    log(f"phase 10 {what}: wall median eager {e['median_ms']:.2f} ms, graph "
        f"{g['median_ms']:.2f} ms ({2 * n} calls each, in turns); device "
        f"eager {e['device_ms']:.2f} ms, graph {g['device_ms']:.2f} ms; idle "
        f"share eager {e['idle_share']:.3f}, graph {g['idle_share']:.3f}; "
        f"graph wall / its device time "
        f"{g['median_ms'] / g['device_ms']:.3f}; device events eager "
        f"{e['events']}, graph {g['events']}")
    nodes = kernel_nodes(graph)
    held = collections.Counter()
    for k, c in nodes.items():
        held[ta.KERNELS[k]] += c
    held = dict(held)
    log(f"phase 10 {what}: the graph's hand-written kernel nodes {nodes}; "
        f"by family {held}, a profiled replay's events {g['families']}, "
        f"the eager call's {e['families']}")
    check_nodes(what, nodes, launches)
    if set(g["families"]) != set(held) or any(
            g["families"][k] > held[k] for k in held):
        raise SystemExit(f"phase 10 {what}: a profiled replay's hand-written "
                         f"kernel events {g['families']} do not match the "
                         f"graph's nodes {held}")
    return dict(out, kernel_nodes=nodes)


def run_compiled_serving(cfg, arch, torch):
    """The serving forward's graph at batch 8 and 1: outputs bit-equal to
    the eager forward, the capture's launches, times."""
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.serving.server import BatchedPredictor

    S, T = cfg.DATA.TEST_CROP_SIZE, cfg.DATA.NUM_FRAMES
    out = {}
    for batch in (BATCH, 1):
        pred = BatchedPredictor(cfg, max_batch=batch)
        pred.graph.graph_factory = node_graph
        try:
            clips = np.random.RandomState(SEED + batch).randn(
                batch, T, S, S, 3).astype(np.float32)
            x = torch.from_numpy(clips).cuda()

            def eager():
                with torch.inference_mode():
                    return pred._run(x)

            want = [t.cpu().numpy() for t in eager()]
            _lib.reset_launch_counts()
            got = pred.forward(clips)        # warm-up, capture, replay
            host = dict(_lib.LAUNCHES)
            (entry,) = pred.graph.entries.values()
            equal = all(np.array_equal(a, b) for a, b in zip(got, want))
            log(f"phase 10 serving batch {batch}: outputs bit-equal to the "
                f"eager forward: {equal}; the graph captured "
                f"{entry.launches}")
            if not equal:
                raise SystemExit(f"phase 10: the serving graph differs from "
                                 f"the eager forward at batch {batch}")
            if entry.launches != dict(expected_launches(arch)):
                raise SystemExit("phase 10: the serving graph's launches "
                                 "differ from the forward's")
            rows = eager_and_graph(f"serving forward batch {batch}", eager,
                                   lambda: pred.graph(x), torch,
                                   entry.graph, entry.launches, pred.model)
            full = statistics.median(time_calls(lambda: pred.forward(clips),
                                                torch, 10))
            log(f"phase 10 serving batch {batch}: forward() with the pinned "
                f"copy in and the copy out {full:.2f} ms (median of 10)")
            out[batch] = dict(rows, launches=entry.launches,
                              first_call_host_launches=host,
                              forward_ms=full)
        finally:
            pred.stop()
            del pred
            torch.cuda.empty_cache()
    return out


def run_compiled_train(cfg, torch, reference):
    """The captured train step against phase 7's eager step on the same
    batch and seed: the loss bit for bit, the gradient under the gate;
    the capture's launches; replays beside eager steps."""
    from svit_tpu_torch.engine import graphs
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.utils import flops

    video, image = train_batch(cfg, torch)
    state, step, arch = train_setup(cfg, torch, torch.bfloat16, True)
    want = dict(expected_train_launches(arch))
    cstep = graphs.CapturedTrainStep(step, graph_factory=node_graph)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    start = graphs._Restore(state, gen)   # the state the step starts from
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = cstep(state, video, image, gen)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    host = dict(_lib.LAUNCHES)
    (entry,) = cstep.entries.values()
    metrics = {k: float(v) for k, v in m.items()}
    # the replay again from the same state: bit for bit
    first = step_tensors(state.model)
    start.restore()
    state.step = 0
    _, m2 = cstep(state, video, image, gen)
    torch.cuda.synchronize()
    deterministic, said = runs_equal(
        torch, first, step_tensors(state.model), metrics,
        {k: float(v) for k, v in m2.items()})
    del first
    log(f"phase 10 train graph, replayed twice from one state: {said}")
    log(f"phase 10 train graph deterministic: {str(deterministic).lower()}")
    if not deterministic:
        raise SystemExit("phase 10: the captured train step is not "
                         "deterministic")
    loss_equal = metrics["loss"] == reference["losses"]["kernels"]["loss"]
    log(f"phase 10 train step: first call (warm-up, capture, replay) "
        f"{first_s:.2f} s; loss {metrics['loss']!r}, phase 7's eager "
        f"{reference['losses']['kernels']['loss']!r}: bit-equal {loss_equal}")
    if not loss_equal:
        raise SystemExit("phase 10: the captured step's loss differs from "
                         "the eager step's")
    grads = raw_grads(state, metrics)
    flat = torch.cat([grads[k].flatten() for k in reference["names"]])
    f32 = reference["flat"]["plain_f32"]
    err_g = rel_err(flat, f32)
    err_p = rel_err(reference["flat"]["plain_bf16"], f32)
    ok = err_g <= TOL_RATIO * err_p + TOL_ABS
    log(f"phase 10 train gate grads_global: err(graph)={err_g:.3e} "
        f"err(plain bf16)={err_p:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 10: the captured step fails the gradient gate")
    del grads, flat
    first_call = {k: v * (graphs.WARMUP + 1) for k, v in want.items()}
    log(f"phase 10 train launches: the graph captured {entry.launches}, the "
        f"first call launched {host} from the host")
    if entry.launches != want or host != first_call:
        raise SystemExit(f"phase 10: capture launches {entry.launches}, "
                         f"first call {host}, expected {want}")

    # replays beside eager steps of a second model, in turns
    state_e, step_e, _ = train_setup(cfg, torch, torch.bfloat16, True)
    gen_e = torch.Generator(device="cuda").manual_seed(SEED + 1)
    gen.manual_seed(SEED + 1)
    step_e(state_e, video, image, gen_e)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    replay_losses = []

    def replay():
        # the graph's output: the next replay overwrites it
        replay_losses.append(
            cstep(state, video, image, gen)[1]["loss"].clone())

    rows = eager_and_graph("train step", lambda: step_e(state_e, video,
                                                        image, gen_e),
                           replay, torch, entry.graph, entry.launches,
                           state_e.model)
    peak = torch.cuda.max_memory_allocated()
    eager_calls = 2 * TIMED + 1
    per_call = {k: v / eager_calls for k, v in _lib.LAUNCHES.items()}
    if per_call != {k: float(v) for k, v in want.items()}:
        raise SystemExit(f"phase 10: host launches {dict(_lib.LAUNCHES)} over "
                         f"{eager_calls} eager steps and the replays")
    losses = torch.stack(replay_losses).cpu().tolist()
    if not all(np.isfinite(losses)):
        raise SystemExit(f"phase 10: non-finite replay loss {losses}")
    step_flop = flops.train_step_flops(arch, TRAIN_VIDEO, TRAIN_IMAGE,
                                       with_consistency=True)
    g = rows["graph"]
    rate = step_flop / (g["median_ms"] / 1e3)
    log(f"phase 10 train step: {entry.replays} replays, losses "
        f"{[round(v, 4) for v in losses]}; peak memory with the eager model "
        f"beside it {peak / 2 ** 30:.2f} GiB; model FLOPs a step "
        f"{step_flop / 1e12:.3f} T: {rate / 1e12:.1f} TFLOP/s over the "
        f"replay's wall, {rate / TENSOR_FLOPS:.4f} of the 989 TFLOP/s bf16 "
        f"peak; {card_line()}")
    out = dict(rows, first_call_s=first_s, loss=metrics["loss"],
               deterministic=deterministic,
               gate_grads_global={"err_graph": err_g,
                                  "err_plain_bf16": err_p},
               launches=entry.launches, first_call_host_launches=host,
               replays=entry.replays, replay_losses=losses, peak_bytes=peak,
               model_tflop=step_flop / 1e12, tflops=rate / 1e12,
               peak_share=rate / TENSOR_FLOPS)
    del state, step, cstep, state_e, step_e
    torch.cuda.empty_cache()
    return out


class PerUse:
    """A ``StepCache`` stand-in that casts and derives at every use: the
    step's form before the cache, captured for the comparison below."""

    def cast(self, w, dtype):
        return w.to(dtype)

    def derived(self, key, fn):
        return fn()


def run_step_cache_ab(cfg, torch):
    """The captured train step with its ``StepCache`` against the same
    step captured in the per-use form, in one call on phase 7's batch and
    seed: the first step's loss bit for bit, then replays of both in turns
    (cached, per-use, per-use, cached) and one profiled replay of each."""
    from svit_tpu_torch.engine import graphs, steps

    video, image = train_batch(cfg, torch)
    runs = {}
    for name in ("cached", "per_use"):
        state, step, _ = train_setup(cfg, torch, torch.bfloat16, True)
        cstep = graphs.CapturedTrainStep(step)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        saved = steps.StepCache
        if name == "per_use":
            steps.StepCache = PerUse
        try:   # the capture bakes in whichever form ran
            state, m = cstep(state, video, image, gen)
        finally:
            steps.StepCache = saved
        runs[name] = (lambda s=state, c=cstep, g=gen:
                      c(s, video, image, g), float(m["loss"]))
    times = {n: [] for n in runs}
    for name in ("cached", "per_use", "per_use", "cached"):
        times[name] += time_calls(runs[name][0], torch, TIMED)
    out = {}
    for name, (fn, loss) in runs.items():
        prof = profile_call(fn, torch)
        out[name] = {"loss": loss, "median_ms": statistics.median(
            times[name]), "device_ms": prof["device_ms"],
            "events": prof["events"]}
    c, p = out["cached"], out["per_use"]
    equal = c["loss"] == p["loss"]
    log(f"phase 10 step cache: loss bit-equal to the per-use form: {equal} "
        f"({c['loss']!r}); a replay's device time {c['device_ms']:.2f} ms "
        f"against {p['device_ms']:.2f}, device events {c['events']} against "
        f"{p['events']}, wall median {c['median_ms']:.2f} against "
        f"{p['median_ms']:.2f} ms ({2 * TIMED} replays each, in turns)")
    if not equal:
        raise SystemExit("phase 10: the step cache changed the loss")
    del runs
    torch.cuda.empty_cache()
    return out


def run_compiled_eval(cfg, arch, torch):
    """The eval, image-eval and test steps' graphs against their eager
    outputs; the test step's batch-64 replays beside eager forwards."""
    from svit_tpu_torch.engine import graphs, steps
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func

    model, _ = build_model(cfg)
    loss_obj = get_loss_func(cfg)
    S, T = cfg.DATA.TEST_CROP_SIZE, cfg.DATA.NUM_FRAMES
    rs = np.random.RandomState(SEED + 10)

    def video_batch(n):
        return {"clips": torch.from_numpy(rs.randn(n, T, S, S, 3).astype(
                    np.float32)).cuda(),
                "labels": torch.from_numpy(rs.randint(
                    0, cfg.MODEL.NUM_CLASSES, n)).cuda(),
                "weight": torch.ones(n).cuda()}

    _, image = train_batch(cfg, torch)
    out = {}
    for name, fn, batches in (
            ("eval", steps.make_eval_step(model, arch.num_classes,
                                          loss_obj=loss_obj,
                                          with_consistency=True),
             [video_batch(BATCH), video_batch(BATCH)]),
            ("image_eval", steps.make_image_eval_step(model, loss_obj),
             [image]),
            ("test", steps.make_test_step(model),
             [video_batch(TEST_BATCH), video_batch(TEST_BATCH)])):
        captured = graphs.CapturedStep(fn, graph_factory=node_graph)
        worst, equal = 0.0, True
        for b in batches:
            want = graphs.tensors(fn(b))
            got = graphs.tensors(captured(b))
            for w, g in zip(want, got):
                equal &= torch.equal(w, g)
                worst = max(worst, rel_err(g.float(), w.float())
                            if w.numel() > 1 or float(w) != 0 else 0.0)
        log(f"phase 10 {name} step: {len(batches)} batches, the graph's "
            f"outputs bit-equal to the eager step's: {equal}, worst relative "
            f"error {worst:.3e}")
        if worst > 1e-6:
            raise SystemExit(f"phase 10: the {name} step's graph differs "
                             f"from the eager step")
        out[name] = {"bit_equal": bool(equal), "worst_rel_err": worst}
        if name == "test":
            b = batches[-1]
            (entry,) = captured.entries.values()
            out[name].update(eager_and_graph(
                f"test forward batch {TEST_BATCH}", lambda: fn(b),
                lambda: captured(b), torch, entry.graph, entry.launches,
                model))
        del captured
    del model
    torch.cuda.empty_cache()
    return out


def run_compiled_phase(cfg, arch, torch, reference):
    """Phase 10: the serving forward, the train step and the eval and test
    steps as CUDA graphs (``engine/graphs.py``), each against its eager
    form in the same call."""
    return {"serving": run_compiled_serving(cfg, arch, torch),
            "train": run_compiled_train(cfg, torch, reference),
            "step_cache": run_step_cache_ab(cfg, torch),
            "eval": run_compiled_eval(cfg, arch, torch)}


# ---------------------------------------------------------------------------
# Phase 11: Grad-CAM at full size (visualization/gradcam.py)
# ---------------------------------------------------------------------------

GRADCAM_BATCH = 4
GRADCAM_LAYER = "blocks_0_out"   # the backward crosses blocks 1 to 15


def gradcam_cfg(name):
    """configs/ssv2.yaml at full size for run ``name`` of ``RUNS``, with
    ``TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST`` naming the target."""
    from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(CFG)
    cfg.TRAIN.MIXED_PRECISION = name != "plain_f32"
    cfg.TPU.USE_PALLAS_ATTENTION = name == "kernels"
    cfg.TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST = [GRADCAM_LAYER]
    return assert_and_infer_cfg(cfg)


def gradcam_clips(cfg, batch, torch):
    return torch.randn(
        (batch, cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE,
         cfg.DATA.TEST_CROP_SIZE, 3),
        generator=torch.Generator().manual_seed(SEED + 11 + batch)).cuda()


def time_gradcam(cam, clips, torch, n):
    """Median wall of ``n`` calls, a profiled call's device time and the
    idle share of the median wall; peak memory of one call."""
    times = time_calls(lambda: cam.layer_cam(clips), torch, n)
    prof = profile_call(lambda: cam.layer_cam(clips), torch)
    torch.cuda.reset_peak_memory_stats()
    cam.layer_cam(clips)
    torch.cuda.synchronize()
    ms = statistics.median(times)
    out = {"batch": clips.shape[0], "ms": times, "median_ms": ms,
           "device_ms": prof["device_ms"], "kernels_ms": prof["kernels_ms"],
           "idle_share": max(0.0, 1 - prof["device_ms"] / ms),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "families": prof["families"], "top": prof["top"]}
    log(f"phase 11 Grad-CAM batch {out['batch']}: wall median {ms:.2f} ms "
        f"({n} calls), device {out['device_ms']:.2f} ms (hand-written "
        f"kernels {out['kernels_ms']:.2f}), idle share "
        f"{out['idle_share']:.3f}, peak memory {out['peak_gib']:.2f} GiB, "
        f"{out['batch'] / ms * 1e3:.2f} clips/s")
    return out


def run_gradcam_phase(torch):
    """Phase 11.  Grad-CAM at ``GRADCAM_LAYER`` for the three runs on the
    same clips and the same seeded labels (each run differentiates the
    same class's score: with random weights the runs' argmax may differ),
    gated on the logits, the target layer's gradient and the pre-ReLU map,
    each gate's limit under 1 (the error of an all-zero output); the
    kernel run's launches against
    ``expected_gradcam_launches`` (no K7); the call timed at batch 4 and
    at the test batch; the default target's all-zero map.  Returns its
    results and the kernel call's launches."""
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.visualization.gradcam import GradCAM

    result, values = {}, {k: {} for k in ("logits", "grad", "cam")}
    for name in RUNS:
        cfg = gradcam_cfg(name)
        model, arch = build_model(cfg)
        layer = cfg.TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST[0]
        cam = GradCAM(model, target_layer=layer, data_mean=cfg.DATA.MEAN,
                      data_std=cfg.DATA.STD)
        clips = gradcam_clips(cfg, GRADCAM_BATCH, torch)
        labels = torch.randint(
            cfg.MODEL.NUM_CLASSES, (GRADCAM_BATCH,),
            generator=torch.Generator().manual_seed(SEED + 11)).cuda()
        if name == "kernels":
            cam.layer_cam(clips, labels)  # plans, one-hot tiles
            torch.cuda.synchronize()
            _lib.reset_launch_counts()
        out = cam.layer_cam(clips, labels)
        torch.cuda.synchronize()
        for k in values:
            values[k][name] = out[k].float().cpu().numpy()
        if name == "kernels":
            launches = dict(_lib.LAUNCHES)
            want = dict(expected_gradcam_launches(
                arch, int(layer.split("_")[1])))
            log(f"phase 11 Grad-CAM launches at {layer}, batch "
                f"{GRADCAM_BATCH}: {launches} (expected {want})")
            if launches != want or launches.get("pool_conv_dk", 0):
                raise SystemExit("phase 11: Grad-CAM launch counts differ")
            result["launches"] = launches
            result["timing"] = {
                b: time_gradcam(cam, gradcam_clips(cfg, b, torch), torch, n)
                for b, n in ((GRADCAM_BATCH, 10), (TEST_BATCH, 5))}
            default = GradCAM(model).layer_cam(clips)
            zero = not (torch.any(default["grad"])
                        or torch.any(default["cam"]))
            log(f"phase 11 Grad-CAM at the default target "
                f"blocks_{arch.depth - 1}_out: gradient and map all zero: "
                f"{zero}")
            if not zero:
                raise SystemExit("phase 11: the default target's map is not "
                                 "zero")
            result["default_target_zero"] = zero
        del model, cam
        torch.cuda.empty_cache()
    for k in values:
        vk, v16, v32 = (torch.from_numpy(values[k][n]) for n in RUNS)
        err_k, err_p = rel_err(vk, v32), rel_err(v16, v32)
        limit = TOL_RATIO * err_p + TOL_ABS
        ok = bool(torch.isfinite(vk).all()) and err_k <= limit < 1
        log(f"phase 11 gate {k}: err(kernels)={err_k:.3e} err(plain bf16)="
            f"{err_p:.3e} limit {limit:.3e} (an all-zero output's error is "
            f"1) shape={tuple(vk.shape)} {'ok' if ok else 'FAIL'}")
        result[f"gate_{k}"] = {"err_kernels": err_k, "err_plain_bf16": err_p,
                               "limit": limit}
        if not ok:
            raise SystemExit(f"phase 11: Grad-CAM gate failed on {k}")
    return result, result["launches"]


# ---------------------------------------------------------------------------
# Phase 12: the demo (visualization/demo.py) on a frame directory
# ---------------------------------------------------------------------------

DEMO_FRAMES = 96


def run_demo_phase(torch):
    """Phase 12.  ``demo(cfg)`` at full size on ``DEMO_FRAMES`` JPEG frames
    at 427 x 240 (random pixels from seed 0, as ``make_ssv2_tree`` writes
    them): the clip count the buffer implies and one written frame per
    buffered frame of each clip (the JAX demo's output); the time split;
    the ``Predictor`` (its first call captures, later ones replay)
    bit-equal to the eager forward on the same clip."""
    import tempfile

    from PIL import Image

    from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg
    from svit_tpu_torch.visualization import demo as demo_mod

    result = {}
    with tempfile.TemporaryDirectory() as root:
        src = os.path.join(root, "frames")
        os.makedirs(src)
        rng = np.random.RandomState(SEED)
        W, H = SSV2_FRAME
        for t in range(DEMO_FRAMES):
            Image.fromarray(rng.randint(0, 255, (H, W, 3), np.uint8)).save(
                os.path.join(src, "%04d.jpg" % (t + 1)))
        cfg = get_cfg()
        cfg.merge_from_file(CFG)
        cfg.OUTPUT_DIR = root
        cfg.DEMO.ENABLE = True
        cfg.DEMO.INPUT_VIDEO = src
        cfg.DEMO.OUTPUT_FILE = os.path.join(root, "out")
        cfg = assert_and_infer_cfg(cfg)
        timings = {}
        n = demo_mod.demo(cfg, timings=timings)
        written = len(os.listdir(cfg.DEMO.OUTPUT_FILE))
        seq = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
        keep = seq // 2 if cfg.DEMO.BUFFER_SIZE == 0 else cfg.DEMO.BUFFER_SIZE
        want = 1 + (DEMO_FRAMES - seq) // (seq - keep)
        rate = n / timings["loop_s"]
        log(f"phase 12 demo: {DEMO_FRAMES} frames at {W} x {H}, buffer {seq} "
            f"keeping {keep}: {n} clips (expected {want}), {written} frames "
            f"written (expected {want * seq}); loop {timings['loop_s']:.2f} s"
            f" ({rate:.2f} clips/s, the first clip's capture included): "
            f"preprocessing {timings['preprocess_s']:.2f} s, forward (copy "
            f"in, replay, copy out) {timings['forward_s']:.2f} s, drawing "
            f"{timings['draw_s']:.2f} s, writing {timings['write_s']:.2f} s "
            f"(its own thread); demo() {timings['wall_s']:.2f} s")
        if n != want or written != want * seq:
            raise SystemExit("phase 12: the demo's clip or frame count "
                             "differs")
        result.update(timings, clips=n, frames_written=written,
                      clips_per_s=rate)

        pred = demo_mod.Predictor(cfg)
        frames = list(demo_mod.frame_source(cfg))[:seq]
        with torch.inference_mode():
            logits, extra = pred.model(torch.from_numpy(
                pred.preprocess(frames)).cuda())
        want_out = (logits.float().cpu().numpy()[0],
                    extra["pred_bboxes"].float().cpu().numpy()[0])
        equal = True
        for _ in range(3):   # capture, then replays
            got = pred(frames)
            equal &= all(np.array_equal(a, b) for a, b in zip(got, want_out))
        (entry,) = pred.graph.entries.values()
        steady = statistics.median(time_calls(lambda: pred(frames), torch, 5))
        log(f"phase 12 Predictor: outputs bit-equal to the eager forward "
            f"(capture and {entry.replays} replays): {equal}; a call "
            f"(preprocessing, copy in, replay, copy out) {steady:.2f} ms "
            f"median of 5")
        if not equal:
            raise SystemExit("phase 12: the Predictor differs from the eager "
                             "forward")
        result.update(predictor_bit_equal=equal, predictor_call_ms=steady)
        del pred
    torch.cuda.empty_cache()
    return result


def graph_census(graph):
    """All nodes of a ``node_graph`` and its NCCL kernel nodes (a
    collective captured in the graph)."""
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    path = os.path.join(REPO, "chiprun_out", f"graph_{os.getpid()}_all.dot")
    graph.graph.debug_dump(path)
    try:
        with open(path) as f:
            lines = [ln for ln in f if "topoId" in ln]
    finally:
        os.remove(path)
    return {"nodes": len(lines),
            "nccl": sum("nccl" in ln.lower() for ln in lines)}


def run_nccl_phase(cfg, torch):
    """Phase 13: the captured train step under a process group of one rank
    (NCCL), so that its collectives (the gradient all-reduce, the loss
    denominators', the metrics') are captured in the graph, against the
    same step with no group: both from one seeded state on phase 7's batch
    and seed; the loss, metrics, gradients and parameters after AdamW bit
    for bit; the two graphs' hand-written kernel nodes the same; the
    collectives issued while the group's step was captured (counted on
    the host: NCCL sums one rank in place and adds no kernel node, so the
    graph shows only the buckets' flatten and copy-back); replays of each
    timed in turns."""
    import tempfile

    import torch.distributed as dist

    from svit_tpu_torch.engine import graphs, steps
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.parallel import mesh as meshlib

    video, image = train_batch(cfg, torch)
    torch.cuda.set_device(0)
    issued = collections.Counter()   # collectives issued, by run
    all_reduce = dist.all_reduce

    def counted(*a, **k):
        issued[run_name] += 1
        return all_reduce(*a, **k)

    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                            world_size=1, rank=0)
    try:
        mesh = meshlib.build_mesh(data=1, model=1)
        runs, caps = {}, {}
        dist.all_reduce = counted
        for run_name, m in (("no group", None), ("1-rank NCCL", mesh)):
            name = run_name
            state, _, _ = train_setup(cfg, torch, torch.bfloat16, True)
            step = steps.make_train_step(
                state.model, get_loss_func(cfg), state.tx, video_weight=7 / 8,
                image_weight=1 / 8, with_image=True, with_consistency=True,
                mesh=m)
            cstep = graphs.CapturedTrainStep(step, graph_factory=node_graph)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            t0 = time.perf_counter()
            state, metrics = cstep(state, video, image, gen)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            (entry,) = cstep.entries.values()
            runs[name] = dict(
                # per call: the first call makes WARMUP calls and a capture
                collectives=issued[name] / (graphs.WARMUP + 1),
                tensors=step_tensors(state.model),
                metrics={k: float(v) for k, v in metrics.items()},
                nodes=kernel_nodes(entry.graph),
                census=graph_census(entry.graph), launches=entry.launches,
                first_s=first_s)
            caps[name] = (cstep, state, video, image, gen)
        dist.all_reduce = all_reduce
        a, b = runs["no group"], runs["1-rank NCCL"]
        equal, said = runs_equal(torch, a["tensors"], b["tensors"],
                                 a["metrics"], b["metrics"])
        log(f"phase 13 1-rank NCCL group against no group: {said}")
        log(f"phase 13 collectives a step, issued in the capture: no group "
            f"{a['collectives']:g}, 1-rank NCCL {b['collectives']:g} (the "
            f"gradient buckets, the loss denominators, the metrics)")
        log(f"phase 13 graph nodes: no group {a['census']}, hand-written "
            f"{a['nodes']}; 1-rank NCCL {b['census']}, hand-written "
            f"{b['nodes']} (at one rank NCCL sums in place with no kernel: "
            f"the extra nodes are the buckets' flatten and copy-back)")
        times = {k: [] for k in caps}
        for name in ("no group", "1-rank NCCL", "1-rank NCCL", "no group"):
            cstep, state, v, i, gen = caps[name]
            times[name] += time_calls(lambda: cstep(state, v, i, gen), torch,
                                      TIMED)
        for name, ts in times.items():
            runs[name]["replay_median_ms"] = statistics.median(ts)
            runs[name]["replay_ms"] = ts
        log(f"phase 13 replay wall median: no group "
            f"{runs['no group']['replay_median_ms']:.2f} ms, 1-rank NCCL "
            f"{runs['1-rank NCCL']['replay_median_ms']:.2f} ms ({2 * TIMED} "
            f"each, in turns); {card_line()}")
        if not equal:
            raise SystemExit("phase 13: the step under a 1-rank group "
                             "differs from the step with none")
        if a["nodes"] != b["nodes"] or a["launches"] != b["launches"]:
            raise SystemExit("phase 13: the group changed the graph's "
                             "hand-written kernel nodes")
        if a["collectives"] or not b["collectives"] or b["census"][
                "nodes"] <= a["census"]["nodes"]:
            raise SystemExit("phase 13: the group's step issued no "
                             "collective in its capture")
        for r in runs.values():
            del r["tensors"]
        del caps
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return runs


def run_overfit_phase():
    """Phase 14: the learning proof through the port's CLI
    (``svit_tpu_torch/tools/overfit_hw.py``: SIGTERM after 6 steps, the
    auto-resume from its checkpoint, every step logged once, the first
    loss_ce above 1.0 and the last below 0.1)."""
    out = os.path.join(REPO, "chiprun_out", "overfit_hw")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "svit_tpu_torch.tools.overfit_hw",
                        "--out", out], cwd=REPO, capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines else {}
    log(f"phase 14 learning proof ({wall:.1f} s): rc {r.returncode}, "
        f"{ {k: result.get(k) for k in ('steps_phase1', 'preempt_checkpoint', 'steps_total', 'loss_first', 'loss_last', 'resumed', 'steps_exact', 'converged', 'phase1_s', 'phase2_s')} }")
    if r.returncode != 0 or not result.get("ok"):
        log(r.stderr[-3000:])
        failed = [k for k in ("sigterm_sent", "resumed", "steps_exact",
                              "converged") if not result.get(k)]
        raise SystemExit(
            f"phase 14: the learning proof failed (rc {r.returncode}, "
            f"phase rcs {result.get('phase1_rc')} / "
            f"{result.get('phase2_rc')}, false: {failed}, preempt "
            f"checkpoint {result.get('preempt_checkpoint')}, steps "
            f"{result.get('steps_phase1')} + "
            f"{(result.get('steps_total') or 0) - (result.get('steps_phase1') or 0)})")
    return dict(result, wall_s=wall)


# trace_attrib's hand-written families -> the kernel-table rows of phases 4
# (the serving forward) and 7 (the train step) that replay their calls (K6
# at stride 1 runs K2's kernel: the two are one group)
FAMILY_ROWS = {
    ("K1 ln_linear",): ("ln_linear", "ln_linear_masked"),
    ("K2 pool_ln", "K6 conv_dx"): ("pool_ln", TRAIN_K2, "pool_conv",
                                   "pool_conv_dx"),
    ("K3 pool_max",): ("pool_max", TRAIN_K3),
    ("K3 pool_max_bwd",): ("pool_max_bwd",),
    ("K4 attention",): ("pooled_attention", TRAIN_K4),
    ("K5 attention_bwd",): ("pooled_attention_bwd",),
    ("K7 conv_dk",): ("pool_conv_dk",),
}
OWNERS_SHOWN = 25


def family_vs_replays(summary, table):
    """Each group of hand-written families: its device ms in a traced
    eager call against the sum of its rows in a kernel table (the replays
    of phase 4 or 7)."""
    from svit_tpu_torch.tools import trace_attrib as ta

    traced = ta.hand_written(summary)
    out = {}
    for fams, rows in FAMILY_ROWS.items():
        have = [r for r in rows if r in table]
        if any(f in traced for f in fams) or have:
            out[" + ".join(fams)] = {
                "traced_ms": sum(traced.get(f, (0.0, 0))[0] for f in fams),
                "replayed_ms": sum(table[r]["ms"] for r in have),
                "rows": have}
    return out


def owner_kinds(summary):
    """A summary's owners with the block index folded (``blocks.*``):
    [kind, ms, glue ms, launches, ms by family], busiest first."""
    from svit_tpu_torch.tools import trace_attrib as ta

    acc = collections.defaultdict(
        lambda: [0.0, 0.0, 0.0, collections.Counter()])
    for name, ms, n in summary["owners"]:
        row = acc[re.sub(r"blocks\.\d+", "blocks.*", name)]
        row[0] += ms
        row[1] += ta.glue_ms(summary, name)
        row[2] += n
        row[3].update(summary["owner_families"][name])
    return sorted(([k, *v] for k, v in acc.items()), key=lambda r: -r[1])


def log_trace(what, res, table):
    """Phase 15: one traced path's family table, owners, unowned share and
    the hand-written groups against the replays."""
    from svit_tpu_torch.tools import trace_attrib as ta

    for kind in ("graph", "eager"):
        s = res[kind]
        log(f"phase 15 {what}, {kind} ({s['iters']} traced): device "
            f"{s['device_ms']:.3f} ms a call, unowned {s['unowned_ms']:.3f} "
            f"ms (share {s['unowned_share']:.4f}), graph-replay share "
            f"{s['graph_replay_share']:.4f}; by family: "
            + "; ".join(f"{f} {ms:.3f} ms x{n:g}"
                        for f, ms, n in s["families"]))
    s = res["eager"]
    log(f"phase 15 {what}, eager: the {OWNERS_SHOWN} busiest owners "
        f"(ms a call, launches, the ms of their kernels outside K1-K7):")
    for name, ms, n in s["owners"][:OWNERS_SHOWN]:
        log(f"  {ms:9.3f} ms x{n:<7g} glue {ta.glue_ms(s, name):8.3f} "
            f"ms  {name[:110]}")
    kinds = owner_kinds(s)
    log(f"phase 15 {what}, eager, by kind of owner (every block as "
        f"blocks.*; ms, glue ms, launches; its busiest families):")
    for kind, ms, g, n, fams in kinds:
        if ms >= 0.1:
            log(f"  {ms:9.3f} ms glue {g:8.3f} ms x{n:<7g} {kind}: "
                + "; ".join(f"{f} {v:.3f}" for f, v in
                            fams.most_common(5)))
    groups = family_vs_replays(s, table)
    for group, g in groups.items():
        log(f"phase 15 {what}: {group} traced eager {g['traced_ms']:.3f} ms, "
            f"the replays' sum {g['replayed_ms']:.3f} ms ({g['rows']})")
    return groups


LOADER_REPEAT = 5   # the worker run lists each video of the tree 5 times
LOADER_PERIOD = 4   # batches a benchmark_iter window


def loader_rates(recs, batch):
    """One benchmark epoch: seconds to the end of its first window (the
    workers' start-up and first batches), clips/s over the windows after
    it, and over the whole epoch."""
    windows = [LOADER_PERIOD / r["iters_per_sec"] for r in recs
               if r["_type"] == "benchmark_iter"]
    if len(windows) < 2:
        raise SystemExit(f"phase 15: the loader ran {len(windows)} windows "
                         f"of {LOADER_PERIOD} batches, too few to see a "
                         f"rate past the first")
    steady = batch * LOADER_PERIOD * (len(windows) - 1) / sum(windows[1:])
    return {"first_window_s": windows[0], "steady_clips_per_sec": steady,
            "steady_batches": LOADER_PERIOD * (len(windows) - 1),
            "epoch_clips_per_sec": recs[-1]["clips_per_sec"],
            "epoch_s": recs[-1]["seconds"]}


def loader_benchmark():
    """``benchmark_data_loading`` on phase 9's JPEG tree at the config's
    workers, the tree listed ``LOADER_REPEAT`` times so that the workers
    run past their start-up, and with none."""
    import tempfile

    from svit_tpu_torch.tools import benchmark

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ssv2")
        make_ssv2_tree(root, 174, TRAIN_TREE_VIDEOS, TEST_FRAMES, haog=True)
        cfg = trainer_cfg(root, os.path.join(tmp, "run"), 1)
        cfg.BENCHMARK.NUM_EPOCHS, cfg.BENCHMARK.LOG_PERIOD = 1, LOADER_PERIOD
        listing = os.path.join(root, "json_files",
                               "something-something-v2-train.json")
        with open(listing) as f:
            entries = json.load(f)
        # the workers' run is long enough to show their rate once started:
        # the loader reads each listing of a video as a clip of its own
        for workers, times in ((cfg.DATA_LOADER.NUM_WORKERS, LOADER_REPEAT),
                               (0, 1)):
            with open(listing, "w") as f:
                json.dump(entries * times, f)
            cfg.DATA_LOADER.NUM_WORKERS = workers
            recs = benchmark.benchmark_data_loading(cfg)
            rates = loader_rates(recs, cfg.TRAIN.BATCH_SIZE)
            log(f"phase 15 benchmark, {workers} loader workers "
                f"({TRAIN_TREE_VIDEOS} videos listed {times}x, video batch "
                f"{cfg.TRAIN.BATCH_SIZE}): first window of {LOADER_PERIOD} "
                f"batches {rates['first_window_s']:.2f} s, then "
                f"{rates['steady_clips_per_sec']:.2f} clips/s over "
                f"{rates['steady_batches']} batches; the epoch "
                f"{rates['epoch_clips_per_sec']:.2f} clips/s over "
                f"{rates['epoch_s']:.2f} s; iters/s by window "
                f"{[round(r['iters_per_sec'], 3) for r in recs[:-1]]}")
            out[workers] = dict(rates, records=recs, listed=times)
    return out


def run_tools_phase(torch, table, train_table, compiled):
    """Phase 15: the measuring tools of ``svit_tpu_torch/tools`` at full
    size: the kernel gate's backward parts (phase 3 gates its forward
    outputs), then its self-test; phase 10's traces of the serving forward
    and the train step (``trace_forward.profile_calls``) by family and
    owner (``trace_attrib``); the ablation profiler; the engine's steady
    state; the data-loading benchmark."""
    from svit_tpu_torch.tools import check_kernels_hw as gate_tool
    from svit_tpu_torch.tools import engine_steady_state, profile_model

    t_start = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    report = gate_tool.run_gate(check_bwd=True, check_fwd=False)
    gate_tool.write(report, os.path.join(REPO, "chiprun_out",
                                         "kernel_gate.json"))
    for key, r in report.items():
        if isinstance(r, dict) and "ok" in r:
            log(f"phase 15 gate {key}: err(kernels)="
                f"{r['err_kernels_vs_f32']:.3e} err(plain bf16)="
                f"{r['err_plain_bf16_vs_f32']:.3e} limit {r['limit']:.3e} "
                f"{'ok' if r['ok'] else 'FAIL'}")
    log(f"phase 15 gate: worst leaf {report['bwd.worst_leaf']}, "
        f"{report['train.masks']} masks handed alike; ok {report['ok']} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not report["ok"]:
        raise SystemExit("phase 15: the kernel gate failed")
    t0 = time.perf_counter()
    fault = gate_tool.selftest()
    log(f"phase 15 self-test (SVIT_PALLAS_FAULT=1): "
        + "; ".join(f"{k} {fault[k]['err_kernels_vs_f32']:.3e} against "
                    f"{fault[k]['limit']:.3e}" for k in fault
                    if k.startswith("fwd."))
        + f"; tripped {fault['tripped']} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not fault["tripped"] or os.environ.get("SVIT_PALLAS_FAULT"):
        raise SystemExit("phase 15: the gate did not trip on the fault")
    out["gate"], out["selftest"] = report, fault

    out["trace"] = {}
    for what, rows, tab in (
            (f"serving forward batch {BATCH}", compiled["serving"][BATCH],
             table),
            (f"train step (video {TRAIN_VIDEO}, image {TRAIN_IMAGE})",
             compiled["train"], train_table)):
        res = {k: rows[k]["summary"] for k in ("graph", "eager")}
        out["trace"][what] = {"groups": log_trace(what, res, tab),
                              "owner_kinds": owner_kinds(res["eager"])}

    t0 = time.perf_counter()
    out["profile_model"] = profile_model.profile(batch=16, iters=10,
                                                 verbose=False)
    log(f"phase 15 profile_model ({time.perf_counter() - t0:.1f} s, batch "
        f"16, 10 chained replays each): "
        + "; ".join(f"{tag} {r['ms']:.2f} ms {r['clips_per_s']:.1f} clips/s"
                    for tag, r in out["profile_model"].items()))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ess = engine_steady_state.measure(
        steps=30, warmup=4,
        bench_ms=compiled["train"]["graph"]["median_ms"], verbose=False,
        opts=["SVIT.CONSISTENCY_LOSS", "l1"])
    log(f"phase 15 engine steady state ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(ess)}")
    out["engine_steady_state"] = ess
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out["benchmark"] = loader_benchmark()
    log(f"phase 15 benchmark ({time.perf_counter() - t0:.1f} s); engine "
        f"{ess['video_clips_per_sec_chip']:.2f} clips/s")
    out["wall_s"] = time.perf_counter() - t_start
    log(f"phase 15 tools: wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 16: TPU.REMAT, each block recomputed in the backward
# ---------------------------------------------------------------------------

# (video, image) batches: bench.py's, and four times it
REMAT_SIZES = ((TRAIN_VIDEO, TRAIN_IMAGE), (32, 32))
REMAT_TAG = f"video {TRAIN_VIDEO} + image {TRAIN_IMAGE}"


def remat_step(cfg, torch, remat, video, image):
    """The captured train step (kernels, bf16) with ``TPU.REMAT`` on or off,
    from the seeded state: its first call (warm-ups, capture, replay) and
    what it leaves: metrics, the generator's state, the capture's launches,
    the peak memory over the call and over what was held before it."""
    from svit_tpu_torch.engine import graphs

    cfg.TPU.REMAT = remat
    try:
        state, step, arch = train_setup(cfg, torch, torch.bfloat16, True)
    finally:
        cfg.TPU.REMAT = False
    if arch.remat != remat:
        raise SystemExit("phase 16: TPU.REMAT did not reach the arch")
    cstep = graphs.CapturedTrainStep(step)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, m = cstep(state, video, image, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    (entry,) = cstep.entries.values()
    return dict(arch=arch, state=state, metrics={k: float(v) for k, v in
                                                 m.items()},
                rng=gen.get_state(), launches=entry.launches, peak=peak,
                step_peak=peak - held,
                replay=lambda: cstep(state, video, image, gen))


def run_remat_phase(cfg, torch):
    """Phase 16: the captured train step with ``TPU.REMAT`` and without,
    from one state, at each of ``REMAT_SIZES``.  At each size the loss,
    metrics, gradients, parameters after AdamW and the generator's state
    are held bit for bit, and the capture's launches (the
    remat step's forward kernels count five forwards: the recompute runs
    the video's and the image's blocks again), replays timed in turns and
    the peak memory."""
    out = {}
    for videos, images in REMAT_SIZES:
        t0 = time.perf_counter()
        video, image = train_batch(cfg, torch, videos, images)
        runs = {remat: remat_step(cfg, torch, remat, video, image)
                for remat in (False, True)}
        off, on = runs[False], runs[True]
        tag = f"video {videos} + image {images}"
        want = {False: dict(expected_train_launches(off["arch"])),
                True: dict(expected_train_launches(on["arch"], forwards=5))}
        log(f"phase 16 {tag}: launches without remat {off['launches']}; "
            f"with remat {on['launches']}")
        for remat, r in runs.items():
            if r["launches"] != want[remat]:
                raise SystemExit(f"phase 16 {tag}: remat {remat} captured "
                                 f"{r['launches']}, expected {want[remat]}")
        equal, said = runs_equal(
            torch, step_tensors(off["state"].model),
            step_tensors(on["state"].model), off["metrics"], on["metrics"])
        rng_equal = torch.equal(off["rng"], on["rng"])
        log(f"phase 16 {tag}, remat against none from one state: {said}; "
            f"generator state equal {rng_equal}; loss "
            f"{on['metrics']['loss']!r}")
        if not (equal and rng_equal):
            raise SystemExit(f"phase 16 {tag}: the remat step differs from "
                             f"the step without remat")
        times = {False: [], True: []}
        for remat in (False, True, True, False):
            times[remat] += time_calls(runs[remat]["replay"], torch, TIMED)
        row = {}
        for remat, r in runs.items():
            row["remat" if remat else "none"] = {
                "median_ms": statistics.median(times[remat]),
                "ms": times[remat], "peak_bytes": r["peak"],
                "step_peak_bytes": r["step_peak"], "launches": r["launches"],
                "loss": r["metrics"]["loss"]}
        a, b = row["none"], row["remat"]
        log(f"phase 16 {tag}: replay median {a['median_ms']:.2f} ms without "
            f"remat, {b['median_ms']:.2f} with ({2 * TIMED} each, in turns: "
            f"{b['median_ms'] / a['median_ms']:.3f}x); max_memory_allocated "
            f"{a['peak_bytes'] / 2 ** 30:.2f} GiB without, "
            f"{b['peak_bytes'] / 2 ** 30:.2f} GiB with; over what each held "
            f"before its first call {a['step_peak_bytes'] / 2 ** 30:.2f} and "
            f"{b['step_peak_bytes'] / 2 ** 30:.2f} GiB "
            f"({time.perf_counter() - t0:.1f} s); {card_line()}")
        out[tag] = dict(row, bit_equal=bool(equal), rng_equal=bool(rng_equal))
        del runs, off, on
        torch.cuda.empty_cache()
    return out


# Phase 17: the head widths and channel counts past the shipped config's.
# (name, label, base config file or None for the defaults, keys): (b) the
# JAX package's small schedules (tests/test_pallas_attention.py:150-170,
# tests/test_w8_carry.py:283-297; EMBED_DIM 32: head_dim 32, C 32 to 128) at
# their own sizes; (c) configs/ssv2.yaml with NUM_HEADS 2 (head_dim 48) and
# (d) with EMBED_DIM 144, NUM_HEADS 2 (MViTv2-L's widths: head_dim 72, C 144
# to 1152, fc1 at K = 1152 past K1's panel), both at 16 x 224 and full
# width, cut to depth 4 with every DIM_MUL / HEAD_MUL / POOL_Q_STRIDE
# transition at blocks 1, 2, 3 (all four stages)
_EMBED32 = {"MODEL.MODEL_NAME": "SViT", "MODEL.NUM_CLASSES": 5,
            "MODEL.DROPOUT_RATE": 0.0, "DATA.NUM_FRAMES": 4,
            "MVIT.EMBED_DIM": 32, "MVIT.PATCH_PADDING": [1, 3, 3],
            "MVIT.POOL_KVQ_KERNEL": [3, 3, 3], "MVIT.REL_POS_SPATIAL": True,
            "MVIT.REL_POS_TEMPORAL": True, "MVIT.USE_ABS_POS": False,
            "MVIT.DROPPATH_RATE": 0.0, "MODEL.LOSS_FUNC": "video_image_loss"}
_DEPTH4 = {"MVIT.DEPTH": 4, "MVIT.DIM_MUL": [[1, 2.0], [2, 2.0], [3, 2.0]],
           "MVIT.HEAD_MUL": [[1, 2.0], [2, 2.0], [3, 2.0]],
           "MVIT.POOL_Q_STRIDE": [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 2, 2],
                                  [3, 1, 2, 2]]}
# the schedules whose new instances' calls are replayed and timed (the
# 32 px one runs the same instances as the 56 px one)
REPLAYED = ("b56", "c48", "d72")
HEAD_WIDTHS = (
    ("b32", "(b) EMBED_DIM 32, head_dim 32, 32 px", None, dict(_EMBED32, **{
        "DATA.TRAIN_CROP_SIZE": 32, "DATA.TEST_CROP_SIZE": 32,
        "MVIT.DEPTH": 2, "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 2, 2],
        "MVIT.POOL_Q_STRIDE": [[0, 1, 1, 1], [1, 1, 2, 2]],
        "MVIT.DIM_MUL": [[1, 2.0]], "MVIT.HEAD_MUL": [[1, 2.0]]})),
    ("b56", "(b) EMBED_DIM 32, head_dim 32, 56 px, depth 3", None,
     dict(_EMBED32, **{
         "DATA.TRAIN_CROP_SIZE": 56, "DATA.TEST_CROP_SIZE": 56,
         "MVIT.DEPTH": 3, "MVIT.POOL_KV_STRIDE_ADAPTIVE": [1, 4, 4],
         "MVIT.POOL_Q_STRIDE": [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 2, 2]],
         "MVIT.DIM_MUL": [[1, 2.0], [2, 2.0]],
         "MVIT.HEAD_MUL": [[1, 2.0], [2, 2.0]]})),
    ("c48", "(c) NUM_HEADS 2, head_dim 48", CFG,
     dict(_DEPTH4, **{"MVIT.NUM_HEADS": 2})),
    ("d72", "(d) EMBED_DIM 144, NUM_HEADS 2, head_dim 72", CFG,
     dict(_DEPTH4, **{"MVIT.EMBED_DIM": 144, "MVIT.NUM_HEADS": 2})),
)


def head_width_cfg(base, keys):
    from svit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    if base:
        cfg.merge_from_file(base)
    for key, value in keys.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = getattr(node, part)
        setattr(node, leaf, value)
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    return cfg


def new_instance(name, args, kwargs):
    """Whether a recorded call runs an instance this phase is for: K4 and
    K5 at a head width other than 64, 96 and 128; K2, K6 and K7 on the
    general route; K1 with its prologue pass (K past the panel)."""
    from svit_tpu_torch.ops import ln_linear as ll
    from svit_tpu_torch.ops import pool

    name = KIND.get(name, name)
    if name in ("pooled_attention", "pooled_attention_bwd"):
        C, heads = args[0].shape[-1], args[5 if name == "pooled_attention"
                                              else 6]
        return C // heads not in (64, 96, 128)
    if name == "ln_linear":
        K = args[0].shape[1]
        prologue = (kwargs.get("ln") is not None
                    or kwargs.get("x_add") is not None)
        return prologue and K > ll.PANEL_K_MAX
    if name in ("pool_ln", "pool_conv"):
        x, w, stride = args[0], args[1], args[4 if name == "pool_ln" else 2]
        hd = args[5] if name == "pool_ln" else None
        kind, shape = "pool", tuple(x.shape)
    elif name == "pool_conv_dx":
        g, w, stride, shape = args
        kind, hd, shape = "dx", None, tuple(shape)
    elif name == "pool_conv_dk":
        x, g, kernel, stride = args
        return pool.pool_plan(tuple(x.shape), kernel, stride, "dk").route \
            == "gen"
    else:
        return False
    return pool.pool_plan(shape, tuple(w.shape[2:]), stride, kind,
                          head_dim=hd).route == "gen"


def _new_calls(rec):
    """The recorder's calls of the new instances (a recorder of its own),
    but the train step's forward kernels (the serving forward's rows time
    those instances)."""
    kept = Recorder()
    kept.calls = collections.OrderedDict(
        (k, c) for k, c in rec.calls.items()
        if c["name"] not in (TRAIN_K4, TRAIN_K2)
        and new_instance(c["name"], c["args"], c["kwargs"]))
    return kept


def prologue_pass_share(kept, torch, label):
    """Each replayed K1 call with the prologue pass against its GEMM alone
    (the streaming launch on rows of the same shape): the pass's share of
    the call's device time."""
    from svit_tpu_torch.ops import ln_linear as ll

    out = []
    for c in kept.calls.values():
        if KIND.get(c["name"], c["name"]) != "ln_linear":
            continue
        args, kw = c["args"], c["kwargs"]
        x, w = args[:2]
        bias = args[2] if len(args) > 2 else kw.get("bias")
        with torch.inference_mode():
            whole = device_time_ms(lambda: ll.ln_linear(*args, **kw))
            gemm = device_time_ms(lambda: ll.ln_linear(
                x, w, bias, gelu=kw.get("gelu", False)))
        log(f"phase 17 {label} K1 {tuple(x.shape)} x {tuple(w.shape)}: "
            f"pass + GEMM {whole:.4f} ms, the GEMM alone {gemm:.4f} ms, the "
            f"pass {whole - gemm:.4f} ms ({1 - gemm / whole:.2f} of the call)")
        out.append({"shape": [tuple(x.shape), tuple(w.shape)],
                    "ms": whole, "gemm_ms": gemm})
    return out


def prologue_pass_bit_gate(torch):
    """K1's prologue pass forced where the resident panel takes the K (K =
    768, the shipped config's last stage at batch 8: the qkv with its
    split, fc1 with the sum and its drop-path form): every output and the
    sum s bit-equal to the panel's."""
    from svit_tpu_torch.ops import ln_linear as ll

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(shape, device="cuda",
                                    generator=gen)).to(dtype)

    M, K, rows = 3136, 768, 392
    x, a = rnd(M, K), rnd(M, K)
    ln = (1 + rnd(K, scale=0.1, dtype=torch.float32),
          rnd(K, scale=0.1, dtype=torch.float32))
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0],
                        device="cuda")
    cases = {"qkv": (3 * K, dict(ln=ln, split=K)),
             "fc1": (4 * K, dict(ln=ln, x_add=a, gelu=True)),
             "fc1 masked": (4 * K, dict(ln=ln, x_add=a, gelu=True,
                                        mask_add=mask, keep=0.6, rows=rows))}
    out = {}
    for use, (N, kw) in cases.items():
        w, b = rnd(N, K, scale=K ** -0.5), rnd(N, scale=0.1,
                                               dtype=torch.float32)
        with torch.inference_mode():
            panel = ll.ln_linear(x, w, b, **kw)
            passed = ll.ln_linear(x, w, b, force_pass=True, **kw)
        torch.cuda.synchronize()
        equal = bits_equal(panel, passed)
        log(f"phase 17 K1 prologue pass against the panel, {use} [{M}, {K}] "
            f"-> {N}: bit-equal {equal}")
        if not equal:
            raise SystemExit(f"phase 17: K1's prologue pass differs from the "
                             f"panel ({use})")
        out[use] = equal
    return out


def head_width_forward(cfg, torch, label):
    """The serving forward at batch 8 three ways (kernels bf16, plain bf16
    and f32), gated as phase 3; its launches against the architecture's;
    its kernel calls recorded."""
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.ops import _lib
    from svit_tpu_torch.tools import check_kernels_hw as gate_tool

    model, arch = build_model(cfg, dtype=torch.bfloat16, use_kernels=True)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((BATCH, arch.num_frames, arch.crop_size, arch.crop_size,
                     3), generator=gen).cuda()
    rec = Recorder()
    originals = rec.patch((mod, attr, name)
                          for name, (mod, attr, _) in wrappers().items())
    try:
        _lib.reset_launch_counts()
        with gate_tool.variant(model, torch.bfloat16, True):
            ek = gate_tool.forward_outputs(model, x)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
    finally:
        Recorder.restore(originals)
    with gate_tool.variant(model, torch.bfloat16, False):
        e16 = gate_tool.forward_outputs(model, x)
    with gate_tool.variant(model, torch.float32, False):
        e32 = gate_tool.forward_outputs(model, x)
    torch.cuda.synchronize()
    report = {}
    for key in ek:
        if not bool(torch.isfinite(ek[key].float()).all()):
            raise SystemExit(f"phase 17 {label}: non-finite {key}")
        ok = gate_tool._gate_one(key, ek[key], e16[key], e32[key], report)
        r = report[key]
        log(f"phase 17 {label} forward gate {key}: err(kernels)="
            f"{r['err_kernels_vs_f32']:.3e} err(plain bf16)="
            f"{r['err_plain_bf16_vs_f32']:.3e} shape={tuple(ek[key].shape)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 17 {label}: the forward gate failed on "
                             f"{key}")
    want = {k: v for k, v in expected_launches(arch).items() if v}
    log(f"phase 17 {label} forward (batch {BATCH}, {arch.num_frames} x "
        f"{arch.crop_size}, depth {arch.depth}): launches {launches} "
        f"(expected {want})")
    if launches != want:
        raise SystemExit(f"phase 17 {label}: forward launches differ")
    del model, ek, e16, e32
    return rec, launches, report


def head_width_step(cfg, torch, label):
    """One train step (video 8 + image 8 + the consistency forward,
    drop-path and dropout as configured) three ways from one seed, gated on
    the loss and the global gradient as phase 7; its launches against the
    architecture's; its kernel calls recorded."""
    from svit_tpu_torch.ops import _lib

    video, image = train_batch(cfg, torch)
    rec, losses, flat = Recorder(), {}, {}
    for name, dtype, kernels in (("kernels", torch.bfloat16, True),
                                 ("plain_bf16", torch.bfloat16, False),
                                 ("plain_f32", torch.float32, False)):
        state, step, arch = train_setup(cfg, torch, dtype, kernels)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        originals = (rec.patch((mod, attr, rname) for mod, attr, _, rname
                               in train_wrappers().values())
                     if kernels else [])
        try:
            torch.cuda.synchronize()
            _lib.reset_launch_counts()
            state, metrics = step(state, video, image, gen)
            torch.cuda.synchronize()
            if kernels:
                launches = dict(_lib.LAUNCHES)
        finally:
            Recorder.restore(originals)
        losses[name] = {k: float(v) for k, v in metrics.items()}
        grads = raw_grads(state, metrics)
        flat[name] = torch.cat([grads[k].flatten() for k in sorted(grads)])
        del state, step, grads
        torch.cuda.empty_cache()
    gates = {}
    for key, vals in (
            ("loss", {n: torch.tensor(losses[n]["loss"], dtype=torch.float64)
                      for n in losses}),
            ("grads_global", flat)):
        err_k = rel_err(vals["kernels"], vals["plain_f32"])
        err_p = rel_err(vals["plain_bf16"], vals["plain_f32"])
        ok = err_k <= TOL_RATIO * err_p + TOL_ABS
        gates[key] = {"err_kernels": err_k, "err_plain_bf16": err_p}
        log(f"phase 17 {label} train gate {key}: err(kernels)={err_k:.3e} "
            f"err(plain bf16)={err_p:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"phase 17 {label}: the train gate failed on "
                             f"{key}")
    # (the small schedules take no drop-path, and their strided last block
    # no backward: counts of 0)
    want = {k: v for k, v in expected_train_launches(arch).items() if v}
    log(f"phase 17 {label} train step: loss {losses['kernels']['loss']:.6f}, "
        f"launches {launches} (expected {want})")
    if launches != want:
        raise SystemExit(f"phase 17 {label}: train step launches differ")
    return rec, launches, gates


def run_head_widths_phase(torch):
    """Phase 17: each schedule of ``HEAD_WIDTHS`` drives the serving
    forward and one train step through the kernels, gated against the
    plain twins and counted (no call took a twin); then every call of an
    instance new to these widths (``new_instance``) is replayed against its
    plain twin under the gate and timed beside its bound and its library
    call.  Returns the phase's results and the kernel rows."""
    t0 = time.perf_counter()
    fwd_fns = {n: (getattr(mod, attr), plain)
               for n, (mod, attr, plain) in wrappers().items()}
    train_fns = {n: (getattr(mod, attr), plain)
                 for n, (mod, attr, plain, _) in train_wrappers().items()}
    out, rows = {"prologue_pass_bit_equal": prologue_pass_bit_gate(torch)}, []
    for key, label, base, keys in HEAD_WIDTHS:
        cfg = head_width_cfg(base, keys)
        frec, flaunch, fgate = head_width_forward(cfg, torch, label)
        torch.cuda.empty_cache()
        trec, tlaunch, tgate = head_width_step(cfg, torch, label)
        torch.cuda.empty_cache()
        result = {"label": label, "forward_launches": flaunch,
                  "forward_gate": fgate, "train_launches": tlaunch,
                  "train_gate": tgate}
        if key not in REPLAYED:
            out[key] = result
            continue
        for rec, fns, unit, launches in (
                (frec, fwd_fns, "forward", flaunch),
                (trec, train_fns, "train step", tlaunch)):
            kept = _new_calls(rec)
            log(f"phase 17 {label}: {len(kept.calls)} of {len(rec.calls)} "
                f"distinct {unit} calls run a new instance")
            table, uses, details = run_kernel_phase(kept, torch, fns, unit)
            result[unit] = {"uses": uses, "calls": details,
                            "prologue_pass": prologue_pass_share(kept, torch,
                                                                 label)}
            for name, row in table.items():
                if not row["launches"]:
                    continue
                base_name = KIND.get(name, name)
                source, replaces = (KERNELS.get(base_name)
                                    or TRAIN_KERNELS[base_name])
                pass_ = "ln_linear" in name
                rows.append({
                    "name": f"{name} [{label}]" + (
                        " (prologue pass, then the GEMM)" if pass_ else ""),
                    "route": "cuda", "source": source, "replaces": replaces,
                    "launches": row["launches"],
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"]
                    else "operations",
                    "library_ms": row["library_ms"],
                    "unit": f"per {unit}",
                    "prologue_launches": (launches.get("ln_linear_prologue",
                                                       0) if pass_ else None),
                })
            del kept
        out[key] = result
        del frec, trec
        torch.cuda.empty_cache()
    log(f"phase 17 head widths: wall {time.perf_counter() - t0:.1f} s")
    return out, rows


# the kernel instances new to phase 17's widths, by their mangled names in
# the build log: K4 and K5 at HD = 32, the general K2 / K6 / K7 and K1's
# prologue pass
NEW_INSTANCES = ("attn_fwd_kernelILi32E", "attn_bwd_q_kernelILi32E",
                 "attn_bwd_kv_kernelILi32E", "halo_gen_kernel",
                 "dk_gen_kernel", "ln_rows_kernel")


def new_instance_report(ptxas):
    """Phase 17's ``ptxas`` lines (registers and spills) of the new
    instances; each must be in the build."""
    found = {fn: lines for fn, lines in ptxas.items()
             if any(k in fn for k in NEW_INSTANCES)}
    for k in NEW_INSTANCES:
        if not any(k in fn for fn in found):
            raise SystemExit(f"phase 17: the build log has no {k}")
    for fn, lines in found.items():
        log(f"phase 17 ptxas {fn}: " + "; ".join(lines))
    return found


def head_widths_main():
    """Phase 17 alone (with the card line and the build): for iterating on
    the card.  ``python -c "import chip_smoke, sys;
    sys.exit(chip_smoke.head_widths_main())"``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from svit_tpu_torch.ops import _lib

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    open(os.path.join(REPO, "chiprun_out", "chip_smoke.log"), "w").close()
    log(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _lib.build()
    _lib.library()
    log(f"build in {time.perf_counter() - t0:.1f} s")
    new_instance_report(ptxas_report((_lib.BUILD / "build.log").read_text()))
    out, rows = run_head_widths_phase(torch)
    with open(os.path.join(REPO, "chiprun_out", "head_widths.json"),
              "w") as f:
        json.dump(dict(result=out, kernels=rows), f, indent=1)
    log(json.dumps({"kernels": rows}))
    return 0


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

    t_start = time.perf_counter()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    open(os.path.join(REPO, "chiprun_out", "chip_smoke.log"), "w").close()
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
    for kernel, instances in K3_INSTANCES.items():
        if sum(kernel in fn for fn in ptxas) != instances:
            raise SystemExit(f"the build log has not {instances} "
                             f"{kernel} instances")
        if any(kernel in fn for fn in spills):
            raise SystemExit(f"{kernel} spills")
    new_instance_report(ptxas)

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
    max_fwd_gates(rec, torch, "pool_max", "phase 4")
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
    (train, train_table, train_uses, train_details,
     train_reference) = run_train_phase(cfg, torch)
    k1 = k1_uses(uses, train_uses, ffn)
    torch.cuda.empty_cache()
    test, test_launches = run_test_phase(torch)
    torch.cuda.empty_cache()
    trainer, trainer_launches = run_trainer_phase(torch)
    torch.cuda.empty_cache()
    compiled = run_compiled_phase(cfg, arch, torch, train_reference)
    torch.cuda.empty_cache()
    gradcam, gradcam_launches = run_gradcam_phase(torch)
    demo = run_demo_phase(torch)
    torch.cuda.empty_cache()
    nccl = run_nccl_phase(cfg, torch)
    overfit = run_overfit_phase()
    torch.cuda.empty_cache()
    tools = run_tools_phase(torch, table, train_table, compiled)
    torch.cuda.empty_cache()
    remat = run_remat_phase(cfg, torch)
    remat_launches = remat[REMAT_TAG]["remat"]["launches"]
    torch.cuda.empty_cache()
    head_widths, head_width_rows = run_head_widths_phase(torch)
    log(f"phase 9's profiled replay (video batch {TRAINER_VIDEO}): "
        f"hand-written kernel events {trainer['run_a']['profile']['families']}"
        f"; phase 10's eager step (video batch {TRAIN_VIDEO}): "
        f"{compiled['train']['eager']['families']}")

    kernels = []
    for names, rows, launches in (
            (KERNELS, table, model_result["launches"]),
            (TRAIN_KERNELS, train_table, train["launches"])):
        for name, (source, replaces) in names.items():
            row = rows[name]
            counter = COUNTER.get(name, name)
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": (row["launches"] if name in RECORDED
                             else launches.get(counter, 0)),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"]
                else "operations",
                "library_ms": row["library_ms"],
                "train_launches": train["launches"].get(counter, 0),
                "test_launches": test_launches.get(counter, 0),
                "trainer_launches": trainer_launches.get(counter, 0),
                # per replay of phase 10's graphs (their capture's counts)
                "train_replay_launches":
                    compiled["train"]["launches"].get(counter, 0),
                "serving_replay_launches":
                    compiled["serving"][BATCH]["launches"].get(counter, 0),
                "gradcam_launches": gradcam_launches.get(counter, 0),
                # per replay of phase 16's remat step (bench.py's batch)
                "remat_train_launches": remat_launches.get(counter, 0),
            })
            if name in RECORDED:       # its counter holds both instances
                kernels[-1].update(dict.fromkeys(
                    ("test_launches", "trainer_launches",
                     "train_replay_launches", "serving_replay_launches",
                     "gradcam_launches", "remat_train_launches")),
                    train_launches=row["launches"])
            if name == "pool_max_bwd":
                kernels[-1]["instances"] = train["max_bwd_routes"]
            if name == "ln_linear":
                kernels[-1]["uses"] = k1
            elif "attention" in name:   # K4 and K5 by use and Nk
                kernels[-1]["uses"] = {
                    k.split(": ", 1)[1]: u for k, u in
                    (train_uses if names is TRAIN_KERNELS else uses).items()
                    if k.split(": ", 1)[0] == name}
    kernels += head_width_rows   # phase 17's new instances
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_detail.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, ptxas=ptxas, spills=spills,
                       model=model_result, forward=fwd, profile=prof,
                       serving=serving, uses=uses, calls=details, ffn=ffn,
                       train=train, train_uses=train_uses,
                       train_calls=train_details, test=test,
                       trainer=trainer, compiled=compiled, gradcam=gradcam,
                       demo=demo, nccl=nccl, overfit=overfit, tools=tools,
                       remat=remat, head_widths=head_widths,
                       kernels=kernels),
                  f, indent=1)
    log(f"all seventeen phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
