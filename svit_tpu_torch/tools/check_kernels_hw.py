"""The numerics gate of the hand-written kernels on the card (counterpart of
``tools/check_kernels_hw.py``).

    python -m svit_tpu_torch.tools.check_kernels_hw [--small] [--no-bwd]
        [--selftest] [--device cpu] [--cfg FILE] [--out FILE] [KEY VALUE ...]

The CPU tests hold every kernel's plain twin against the JAX package; this
gate holds the kernels themselves, at the full SViT-B/16 shape (16 x 224)
where the launch plans and tiles are exercised.  One model with one
fixed-seed parameter set (``fixed_params``: JAX ``_fixed_params``' normal(0,
0.02) draws from ``RandomState(7)``, carried across by the converter's
names) runs three ways:

  prod    : the kernels (``use_kernels=True``), bf16
  plain16 : the plain PyTorch versions, bf16
  f32     : the plain versions, f32, TF32 off (ground truth)

and each compared output must pass the self-calibrating bound

    err(prod vs f32) <= TOL_RATIO * err(plain16 vs f32) + TOL_ABS

(relative L2): bf16 rounding moves both bf16 runs alike, so a kernel
fault shows as err(prod) >> err(plain16).  Compared: the raw logits, the
boxes, the contact logits and the last block's grid output (a grid-side
fault is attenuated in the head, which reads only the cls and object
tokens); with the backward, the video loss's global gradient and the
small train-mode gradient with drop-path 0.4 (the masked residual tail),
its per-sample masks drawn once and handed alike to all three runs.  The
plain runs take the pool filters' gradient by autograd through
``F.conv3d``, independently of K7 and of its plain twin's tap form.

``--selftest`` reruns the forward gate with ``SVIT_PALLAS_FAULT=1`` (K4's
output rolled by a channel, ``ops/attention.py:fault_injected``, read at
call time; the gate runs eager) and exits 0 only if the gate trips.

The report goes to ``chiprun_out/kernel_gate.json`` (the self-test's to
``chiprun_out/kernel_gate_selftest.json``).  It runs on the card and
raises without one unless given ``--device cpu`` (``device="cpu"``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from svit_tpu_torch.tools.common import CFG, REPO, fixed_params, load_cfg

OUT = os.path.join(REPO, "chiprun_out", "kernel_gate.json")
FAULT = "SVIT_PALLAS_FAULT"

# gate batch: small, but the full model shape
BATCH = 2
TOL_RATIO = 3.0
TOL_ABS = 2e-3  # floor for outputs where plain bf16 happens to round luckily
# --small's schedule (and the train-mode gate's): depth 3 at 56 px, 4 frames
SMALL = {"DATA.TRAIN_CROP_SIZE": 56, "DATA.TEST_CROP_SIZE": 56,
         "DATA.NUM_FRAMES": 4, "MVIT.DEPTH": 3, "MVIT.DIM_MUL": [[1, 2.0]],
         "MVIT.HEAD_MUL": [[1, 2.0]],
         "MVIT.POOL_Q_STRIDE": [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1]]}
VARIANTS = (("prod", torch.bfloat16, True), ("plain16", torch.bfloat16, False),
            ("f32", torch.float32, False))


def _f64(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().double().flatten()
    return torch.from_numpy(np.asarray(a, np.float64).ravel())


def _rel_err(a, b) -> float:
    """Relative L2 error of ``a`` against ``b`` (tensors or arrays), in
    f64."""
    a, b = _f64(a), _f64(b).to(_f64(a).device)
    denom = max(float(torch.linalg.vector_norm(b)), 1e-12)
    return float(torch.linalg.vector_norm(a - b)) / denom


def _gate_one(name, prod_val, plain16_val, f32_val, report) -> bool:
    e_prod = _rel_err(prod_val, f32_val)
    e_plain = _rel_err(plain16_val, f32_val)
    limit = TOL_RATIO * e_plain + TOL_ABS
    ok = e_prod <= limit
    report[name] = {"err_kernels_vs_f32": e_prod,
                    "err_plain_bf16_vs_f32": e_plain, "limit": limit,
                    "ok": bool(ok)}
    return ok


def _small(cfg) -> None:
    for key, value in SMALL.items():
        node, leaf = cfg, key.split(".")
        for k in leaf[:-1]:
            node = node[k]
        node[leaf[-1]] = value


def gate_cfg(small=False, cfg_file=None, opts=()):
    """``load_cfg``, at ``SMALL``'s size with ``small``."""
    return load_cfg(cfg_file, opts, _small if small else None)


@contextlib.contextmanager
def variant(model, dtype, use_kernels):
    """The model run in ``dtype`` through the kernels or the plain
    versions, TF32 off, for the block."""
    saved = (model.dtype, model.use_kernels,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    model.dtype, model.use_kernels = dtype, use_kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield model
    finally:
        (model.dtype, model.use_kernels, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def forward_outputs(model, x) -> dict:
    """The eval forward's raw logits, boxes, contact logits and the last
    block's grid output (a forward hook on that block)."""
    grid = []
    hook = model.blocks[-1].register_forward_hook(
        lambda mod, args, out: grid.append(out[0]))
    try:
        with torch.inference_mode():
            _, extra = model(x, train=False)
    finally:
        hook.remove()
    return {"raw_logits": extra["raw_logits"],
            "pred_bboxes": extra["pred_bboxes"],
            "pred_contact": extra["pred_contact_state"],
            "grid_final": grid[-1]}


class SameMasks:
    """Hands every train-mode run the per-sample masks the first run drew
    (stochastic depth and dropout, ``models/common.py:keep_mask``): the
    first run records them, each later run replays them in order and
    must ask for the same shapes."""

    def __init__(self):
        from svit_tpu_torch.models import attention, common

        self.modules = (attention, common)
        self.draw = common.keep_mask
        self.masks, self.at = [], None

    def __enter__(self):
        for mod in self.modules:
            mod.keep_mask = self._mask
        return self

    def __exit__(self, *exc):
        for mod in self.modules:
            mod.keep_mask = self.draw
        return False

    def replay(self) -> None:
        """Start the next run; the run before must have used every mask."""
        if self.at is not None and self.at != len(self.masks):
            raise RuntimeError(f"a run drew {self.at} of "
                               f"{len(self.masks)} masks")
        self.at = 0

    def _mask(self, shape, keep, generator, device):
        if self.at is None:
            m = self.draw(shape, keep, generator, device)
            self.masks.append((shape, keep, m))
            return m
        want, k, m = self.masks[self.at]
        if _dims(want) != _dims(shape) or k != keep:
            raise RuntimeError(f"mask {self.at}: {shape} at keep {keep}, "
                               f"the first run drew {want} at {k}")
        self.at += 1
        return m.to(device)


def _dims(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _grads(model, loss_obj, video, train=False, generator=None):
    """The video loss's gradient (raw logits, cross-entropy) with respect to
    every parameter, as one f64 vector (zeros where no gradient flows)."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    _, extra = model(video["clips"], train=train, generator=generator)
    loss = loss_obj.weighted_sum(loss_obj.video_losses(
        extra["raw_logits"], video["labels"], extra, None, video["weight"]))
    loss.backward()
    flat = [(p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().double().flatten() for p in params]
    for p in params:
        p.grad = None
    return flat


def _video(rs, cfg, batch, device):
    T, S = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    x = torch.from_numpy(rs.randn(batch, T, S, S, 3).astype(np.float32))
    return x.to(device)


def _train_mode_gate(report, device, verbose=False) -> bool:
    """The small train-mode gradient gate: drop-path 0.4 and the config's
    head dropout on, every run on the same masks."""
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func

    cfg = gate_cfg(small=True, opts=["MVIT.DROPPATH_RATE", 0.4])
    model, _ = build_model(cfg, dtype=torch.float32, use_kernels=False,
                           device=device, train=True)
    rs = np.random.RandomState(3)
    video = {"clips": _video(rs, cfg, 4, device),
             "labels": torch.from_numpy(rs.randint(0, 174, 4)).to(device),
             "weight": torch.ones(4, device=device)}
    fixed_params(model)
    loss_obj = get_loss_func(cfg)
    flat = {}
    with SameMasks() as masks:
        for i, (name, dtype, kernels) in enumerate(VARIANTS):
            if i:
                masks.replay()
            gen = torch.Generator(device=device).manual_seed(11)
            with variant(model, dtype, kernels):
                flat[name] = torch.cat(_grads(model, loss_obj, video,
                                              train=True, generator=gen))
            if verbose:
                print(f"train grads[{name}] done", file=sys.stderr)
        masks.replay()
    report["train.masks"] = len(masks.masks)
    return _gate_one("train.grads_global", flat["prod"], flat["plain16"],
                     flat["f32"], report)


def run_gate(check_bwd: bool = True, verbose: bool = False,
             small: bool = False, device=None, cfg_file=None,
             opts=(), check_fwd: bool = True) -> dict:
    """Run the gate on ``device`` (the card unless given); without
    ``check_fwd`` only its backward parts.  Returns the report with an
    overall ``ok`` (it does not raise on a mismatch)."""
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.build import resolve_device
    from svit_tpu_torch.models.losses import get_loss_func

    device = resolve_device(device)
    cfg = gate_cfg(small, cfg_file, opts)
    model, arch = build_model(cfg, dtype=torch.float32, use_kernels=False,
                              device=device)
    rs = np.random.RandomState(0)
    x = _video(rs, cfg, BATCH, device)
    fixed_params(model)
    report = {"backend": device.type, "batch": BATCH,
              "shape": [arch.num_frames, arch.crop_size, arch.depth],
              "fault_injected": os.environ.get(FAULT, "0") == "1"}
    ok = True

    outs = {}
    for name, dtype, kernels in VARIANTS if check_fwd else ():
        with variant(model, dtype, kernels):
            outs[name] = forward_outputs(model, x)
        if verbose:
            print(f"forward[{name}] done", file=sys.stderr)
    for key in outs.get("f32", ()):
        ok &= _gate_one(f"fwd.{key}", outs["prod"][key],
                        outs["plain16"][key], outs["f32"][key], report)
    del outs

    if check_bwd:
        loss_obj = get_loss_func(cfg)
        video = {"clips": x,
                 "labels": torch.from_numpy(rs.randint(0, 174, BATCH)).to(
                     device),
                 "weight": torch.ones(BATCH, device=device)}
        model.requires_grad_(True)
        leaves = {}
        for name, dtype, kernels in VARIANTS:
            with variant(model, dtype, kernels):
                leaves[name] = _grads(model, loss_obj, video)
            if verbose:
                print(f"grads[{name}] done", file=sys.stderr)
        model.requires_grad_(False)
        ok &= _gate_one("bwd.grads_global", torch.cat(leaves["prod"]),
                        torch.cat(leaves["plain16"]), torch.cat(leaves["f32"]),
                        report)
        # the worst single leaf by its excess over plain bf16's own error (a
        # tiny-norm leaf where both bf16 runs drift alike is noise)
        worst = (0.0, None, 0.0, 0.0, 0.0)
        for i, (path, _) in enumerate(model.named_parameters()):
            ref = leaves["f32"][i]
            e_p = _rel_err(leaves["prod"][i], ref)
            e_x = _rel_err(leaves["plain16"][i], ref)
            if e_p - e_x > worst[0]:
                worst = (e_p - e_x, path, e_p, e_x,
                         float(torch.linalg.vector_norm(ref)))
        report["bwd.worst_leaf"] = {
            "excess": worst[0], "path": worst[1], "err_kernels": worst[2],
            "err_plain_bf16": worst[3], "f32_grad_norm": worst[4]}
        del leaves
        ok &= _train_mode_gate(report, device, verbose=verbose)

    report["ok"] = bool(ok)
    return report


def selftest(small: bool = False, device=None, verbose: bool = False,
             cfg_file=None, opts=()) -> dict:
    """The forward gate with the fault injected; ``tripped`` says whether
    it failed, as it must."""
    prev = os.environ.get(FAULT)
    os.environ[FAULT] = "1"
    try:
        report = run_gate(check_bwd=False, verbose=verbose, small=small,
                          device=device, cfg_file=cfg_file, opts=opts)
    finally:
        if prev is None:
            os.environ.pop(FAULT, None)
        else:
            os.environ[FAULT] = prev
    report["tripped"] = not report["ok"]
    return report


def write(report, path) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def main(argv=None, device=None):
    from svit_tpu_torch.models.build import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-bwd", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--selftest", action="store_true",
                    help="rerun the forward gate with the fault injected; "
                         "exit 0 iff it trips")
    ap.add_argument("--device", default=None)
    ap.add_argument("--cfg", dest="cfg_file", default=CFG)
    ap.add_argument("--out", default=None)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    device = resolve_device(device or args.device)

    if args.selftest:
        report = selftest(args.small, device, True, args.cfg_file, args.opts)
        write(report, args.out or OUT.replace(".json", "_selftest.json"))
        print(json.dumps(report, indent=1))
        if not report["tripped"]:
            print("SELFTEST FAILED: the gate did not trip on the injected "
                  "fault", file=sys.stderr)
            return 1
        print("selftest ok: the gate trips on the injected fault",
              file=sys.stderr)
        return 0

    report = run_gate(check_bwd=not args.no_bwd, verbose=True,
                      small=args.small, device=device,
                      cfg_file=args.cfg_file, opts=args.opts)
    write(report, args.out or OUT)
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
