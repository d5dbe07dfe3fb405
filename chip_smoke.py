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
   bf16 and in f32 (same gate), and timed with CUDA events beside the plain
   version, one PyTorch library yardstick and the card's bound; the
   per-forward totals are printed per kernel and per JAX function served;
5. forward time and clips/s at batch 8 and batch 1, and one profiled
   forward at each: device time by kernel, the hand-written kernels' share
   and the device's idle share of the wall time;
6. serving: ``make_server`` (what ``serve()`` runs) on localhost, GET
   /healthz and three concurrent POST /predict of 16 JPEG frames.

It prints the ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Per-call details go to
``chiprun_out/chip_smoke_detail.json``.  Without a card it exits 2.
"""

import base64
import collections
import io
import json
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
SEED = 0
TOL_RATIO, TOL_ABS = 3.0, 2e-3
# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core flop/s,
# f32 flop/s outside the tensor cores
HBM_BPS, TENSOR_FLOPS, CORE_FLOPS = 3.35e12, 989e12, 67e12

KERNELS = {  # counter name -> (source, TPU kernels it replaces)
    "ln_linear": ("svit_tpu_torch/csrc/ln_linear.cu",
                  "svit_tpu/ops/pallas_ffn.py:205 _ln_qkv_kernel; "
                  "svit_tpu/ops/pallas_ffn.py:153 _ln_dense_kernel; "
                  "svit_tpu/ops/pallas_ffn.py:322 _ffn_res_kernel"),
    "pool_ln": ("svit_tpu_torch/csrc/pool.cu",
                "svit_tpu/ops/pallas_pool.py:175 _kernel_s1; "
                "svit_tpu/ops/pallas_pool.py:250 _kernel_strided"),
    "pool_max": ("svit_tpu_torch/csrc/pool.cu",
                 "svit_tpu/ops/pallas_pool.py:695 _kernel_strided_max"),
    "pooled_attention": ("svit_tpu_torch/csrc/attention.cu",
                         "svit_tpu/ops/pallas_attention.py:167 _attn_kernel"),
}


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
    return [t for o in out for t in flat_outputs(o)]


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


def cuda_ms(fn, reps):
    """Milliseconds per call of ``fn``: CUDA events around ``reps`` calls
    back to back, the median of three such windows."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


class Recorder:
    """Wraps the kernel wrappers for one forward: keeps the first call of
    each distinct signature (its tensors, by reference) and a count."""

    def __init__(self):
        self.calls = collections.OrderedDict()

    def wrap(self, name, fn):
        def recorded(*args, **kwargs):
            key = (name, signature(args), signature(kwargs))
            if key in self.calls:
                self.calls[key]["count"] += 1
            else:
                self.calls[key] = dict(name=name, args=args, kwargs=kwargs,
                                       count=1)
            return fn(*args, **kwargs)

        return recorded


def wrappers():
    """counter name -> (module, attribute, plain twin)."""
    from svit_tpu_torch.ops import attention as attn_ops
    from svit_tpu_torch.ops import ln_linear as ll
    from svit_tpu_torch.ops import pool

    return {
        "ln_linear": (ll, "ln_linear", ll.ln_linear_reference),
        "pool_ln": (pool, "fused_pool_ln", pool.pool_ln_reference),
        "pool_max": (pool, "fused_pool_max", pool.pool_max_reference),
        "pooled_attention": (attn_ops, "pooled_attention",
                             attn_ops.pooled_attention_reference),
    }


def cost(name, args, kwargs):
    """(bytes the call must move, tensor-core flops, CUDA-core flops)."""
    import math

    def nb(t):
        return 0 if t is None else t.numel() * t.element_size()

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
        return nb(x) + nb(w) + nb(ls) + nb(lb) + 2 * out, 0.0, \
            out * (2.0 * taps + 8)
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
    if name == "pool_ln":
        return ("fused_pool_ln (stride 1)" if tuple(args[4]) == (1, 1, 1)
                else "fused_pool_ln (strided)")
    if name == "pooled_attention":
        return ("fused_attention_proj (grid queries)" if args[2] is not None
                else "fused_attention_proj (extras queries)")
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
    originals = {}
    for name, (mod, attr, _) in wrappers().items():
        originals[name] = getattr(mod, attr)
        setattr(mod, attr, rec.wrap(name, originals[name]))
    try:
        model.dtype, model.use_kernels = torch.bfloat16, True
        _lib.reset_launch_counts()
        with torch.inference_mode():
            _, ek = model(x)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
    finally:
        for name, (mod, attr, _) in wrappers().items():
            setattr(mod, attr, originals[name])
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


def run_kernel_phase(rec, torch):
    """Phase 4: replay each recorded call: gate, times, bound.  Returns
    the totals per kernel and per JAX function, and the per-call rows."""
    table = {n: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                     library_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
             for n in KERNELS}
    uses = collections.defaultdict(collections.Counter)
    details = []
    for call in rec.calls.values():
        name, args, kwargs, count = (call["name"], call["args"],
                                     call["kwargs"], call["count"])
        mod, attr, plain = wrappers()[name]
        kernel = getattr(mod, attr)
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
            big = name == "pooled_attention" or args[0].numel() > 2 ** 24
            ms = cuda_ms(lambda: kernel(*args, **kwargs), 10)
            plain_ms = cuda_ms(lambda: plain(*args, **kwargs), 3 if big else 10)
            lib_ms = cuda_ms(library_call(name, args, kwargs), 10)
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
    log("per forward, by the JAX function each call stands for:")
    for key, u in uses.items():
        log(f"  {key}: launches {u['launches']} ms={u['ms']:.4f} "
            f"plain_ms={u['plain_ms']:.4f} library_ms={u['library_ms']:.4f} "
            f"bound_ms={u['bound_ms']:.4f}")
    return table, {k: dict(u) for k, u in uses.items()}, details


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
               "attn_kernel")


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
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, e.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
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
    for line in (_lib.BUILD / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    cfg = get_cfg()
    cfg.merge_from_file(CFG)
    model, arch = build_model(cfg)
    log(f"model: {cfg.MODEL.MODEL_NAME} {arch.num_frames}x{arch.crop_size} "
        f"depth {arch.depth}, {sum(p.numel() for p in model.parameters())} "
        f"params, batch {BATCH}")
    rec, model_result = run_model_phase(model, arch, torch)
    table, uses, details = run_kernel_phase(rec, torch)
    del rec
    fwd = [time_forward(model, arch, torch, b) for b in (BATCH, 1)]
    prof = [profile_forward(model, arch, torch, f["batch"], f["ms"])
            for f in fwd]
    del model
    torch.cuda.empty_cache()
    serving = run_serving_phase(cfg, torch)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = table[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": model_result["launches"].get(name, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"]
            else "operations",
            "library_ms": row["library_ms"],
        })
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_detail.json"), "w") as f:
        json.dump(dict(card=card, build_s=build_s, model=model_result,
                       forward=fwd, profile=prof, serving=serving, uses=uses,
                       calls=details, kernels=kernels), f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
