#!/usr/bin/env python3
"""Data and tensor parallelism across processes, one a card (NCCL), or on
the CPU (gloo):

    python3 parallel_probe.py            # every card of the host
    python3 parallel_probe.py --cpu --procs 4

A small SViT of ``configs/ssv2.yaml``'s widths (2 blocks at 56 px, 4
frames; on the card bf16 through the kernels, on the CPU f32 through the
plain twins), with the config's stochastic depth (0.4) and head dropout
(0.5), every rank keeping its rows of the global batch's masks, and one
global batch of ``procs`` videos and ``procs`` images from a seed:

1. data ``procs`` x model 1: each rank's train step on its share (on the
   card the captured step, its all-reduces inside the CUDA graph) against
   rank 0's one-process step on the whole batch; every rank's parameters
   after the step equal bit for bit; the step replayed again from the same
   state bit for bit;
2. data ``procs / 2`` x model 2: the MLPs sharded (K1's f32 partial,
   summed over the model group), against step 1's data-parallel result.

Each comparison is the relative L2 error of the loss, of the gathered
gradient vector and of the parameters after AdamW.  On the CPU, in f32,
both are gated at 1e-6 (loss), 1e-4 (gradients) and 1e-6 (parameters).
On the card, in bf16, data parallelism changes only the order of f32
sums: 1e-4, 2e-2 and 1e-3.  The model split also moves bf16 roundings
(fc2's output is rounded after a sum across ranks), as the kernels move
them against the plain ops; so at model 2 the loss and the gradients are
held to ``chip_smoke.py``'s gate against rank 0's one-process step in
f32 through the plain ops: err(model 2) <= 3 err(plain bf16) + 2e-3
(a first run on four NVIDIA H100 80GB HBM3 at 700.00 W held them to
1e-4 against data parallelism, and the loss missed it: 1.083e-4).  Prints one JSON line; exits non-zero on a
failed gate.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))


def small_cfg(cpu):
    from svit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MODEL.NUM_CLASSES = 10
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    cfg.TRAIN.MIXED_PRECISION = not cpu
    cfg.NUM_GPUS = 0
    return cfg


def global_batch(cfg, n):
    rs = np.random.RandomState(0)
    S, T, O = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES, cfg.SVIT.O
    video = {"clips": rs.randn(n, T, S, S, 3).astype(np.float32),
             "labels": rs.randint(0, 10, n), "weight": np.ones(n, np.float32)}
    image = {"frames": rs.randn(n, 1, S, S, 3).astype(np.float32),
             "haog_bboxes": (rs.rand(n, 1, O, 4) * 0.5 + 0.1).astype(
                 np.float32),
             "contact_state": rs.randint(-1, 5, (n, 2)),
             "weight": np.ones(n, np.float32)}
    return video, image


def on(batch, device, lo=None, hi=None):
    return {k: torch.as_tensor(v[lo:hi]).to(device) for k, v in batch.items()}


def step_once(cfg, mesh, video, image, device, twice=False, dtype=None,
              use_kernels=None):
    """One step from the seeded weights (captured on the card); returns
    (loss, full gradients, full parameters, replayed-again equal)."""
    from svit_tpu_torch.engine import graphs, steps
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.models.optimizer import construct_optimizer
    from svit_tpu_torch.parallel import mesh as meshlib

    model, _ = build_model(cfg, dtype=dtype, use_kernels=use_kernels,
                           device=device, train=True)
    meshlib.shard_model(model, mesh)
    tx, _ = construct_optimizer(cfg, model, steps_per_epoch=10)
    spec = meshlib.local_spec(mesh, model)
    if spec:
        tx.shard(mesh.model_group, [p for n, p in model.named_parameters()
                                    if n in spec])
    state = steps.create_train_state(model, tx)
    step = graphs.CapturedTrainStep(steps.make_train_step(
        model, get_loss_func(cfg), tx, video_weight=7 / 8, image_weight=1 / 8,
        with_image=True, with_consistency=True, mesh=mesh))
    gen = torch.Generator(device=device).manual_seed(0)
    start = graphs._Restore(state, gen)
    _, m = step(state, video, image, gen)
    loss = float(m["loss"])

    def full():
        grads = {n: (meshlib._gather(p.grad, spec[n], mesh) if n in spec
                     else p.grad).detach().float().clone()
                 for n, p in model.named_parameters()}
        params = {k: v.detach().float().clone() for k, v in
                  meshlib.full_state_dict(model, mesh).items()}
        return grads, params

    grads, params = full()
    again = None
    if twice:
        start.restore()
        state.step = 0
        _, m2 = step(state, video, image, gen)
        g2, p2 = full()
        again = (float(m2["loss"]) == loss
                 and all(torch.equal(grads[k], g2[k]) for k in grads)
                 and all(torch.equal(params[k], p2[k]) for k in params))
    return loss, grads, params, again


def rel(a, b):
    a = torch.cat([t.flatten().double() for t in a.values()]) if isinstance(
        a, dict) else torch.tensor(a, dtype=torch.float64)
    b = torch.cat([t.flatten().double() for t in b.values()]) if isinstance(
        b, dict) else torch.tensor(b, dtype=torch.float64)
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def rank_main(rank, procs, init, cpu, out_path):
    import torch.distributed as dist

    from svit_tpu_torch.parallel import mesh as meshlib

    torch.set_num_threads(1)
    device = torch.device("cpu" if cpu else f"cuda:{rank}")
    if not cpu:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = small_cfg(cpu)
    video, image = global_batch(cfg, procs)
    ref, plain = None, {}
    if rank == 0:   # the one-process step on the whole batch, no group
        one = meshlib.Mesh(1, 1)
        ref = step_once(cfg, one, on(video, device), on(image, device),
                        device)
        if not cpu:   # the plain ops in bf16 and in f32
            for name, dtype in (("bf16", torch.bfloat16),
                                ("f32", torch.float32)):
                plain[name] = step_once(cfg, one, on(video, device),
                                        on(image, device), device,
                                        dtype=dtype, use_kernels=False)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{init}", world_size=procs,
                            rank=rank)
    try:
        dp = meshlib.build_mesh(data=procs, model=1)
        lo, hi = rank, rank + 1
        d_loss, d_g, d_p, again = step_once(
            cfg, dp, on(video, device, lo, hi), on(image, device, lo, hi),
            device, twice=True)
        # every rank holds the same parameters after the step
        sums = torch.stack([p.double().sum() for p in d_p.values()]).to(
            device)
        every = [torch.empty_like(sums) for _ in range(procs)]
        dist.all_gather(every, sums)
        same = all(torch.equal(every[0], e) for e in every)
        tp = meshlib.build_mesh(data=procs // 2, model=2)
        per = procs // 2
        lo = tp.data_index * (procs // per)
        hi = lo + procs // per
        t_loss, t_g, t_p, _ = step_once(
            cfg, tp, on(video, device, lo, hi), on(image, device, lo, hi),
            device)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        r_loss, r_g, r_p, _ = ref
        out = {"procs": procs, "device": "cpu" if cpu else
               torch.cuda.get_device_name(0),
               "dp_vs_one": {"loss": rel(d_loss, r_loss), "grads": rel(d_g, r_g),
                             "params": rel(d_p, r_p)},
               "dp_replay_bit_equal": again, "dp_ranks_equal": same,
               "tp_vs_dp": {"loss": rel(t_loss, d_loss), "grads": rel(t_g, d_g),
                            "params": rel(t_p, d_p)}}
        if plain:
            (f_loss, f_g, _, _), (b_loss, b_g, _, _) = (plain["f32"],
                                                        plain["bf16"])
            out["bf16_gate"] = {
                k: {"err_model2": rel(t, f), "err_one_process": rel(o, f),
                    "err_plain_bf16": rel(b, f),
                    "limit": 3 * rel(b, f) + 2e-3}
                for k, (t, o, b, f) in {
                    "loss": (t_loss, r_loss, b_loss, f_loss),
                    "grads": (t_g, r_g, b_g, f_g)}.items()}
        with open(out_path, "w") as f:
            json.dump(out, f)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--procs", type=int, default=0)
    args = p.parse_args()
    sys.path.insert(0, REPO)
    if not args.cpu and not torch.cuda.is_available():
        print("parallel_probe: no CUDA device (pass --cpu)", file=sys.stderr)
        return 2
    procs = args.procs or (4 if args.cpu else torch.cuda.device_count())
    if procs < 2 or procs % 2:
        print(f"parallel_probe: needs an even number of processes, not "
              f"{procs}", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp()
    out_path = os.path.join(tmp, "result.json")
    torch.multiprocessing.spawn(rank_main, args=(
        procs, os.path.join(tmp, "init"), args.cpu, out_path), nprocs=procs)
    with open(out_path) as f:
        out = json.load(f)
    gates = ({"loss": 1e-6, "grads": 1e-4, "params": 1e-6} if args.cpu else
             {"loss": 1e-4, "grads": 2e-2, "params": 1e-3})
    held = ("dp_vs_one", "tp_vs_dp") if args.cpu else ("dp_vs_one",)
    ok = (out["dp_replay_bit_equal"] and out["dp_ranks_equal"]
          and all(out[c][k] <= v for c in held for k, v in gates.items())
          and all(g["err_model2"] <= g["limit"]
                  for g in out.get("bf16_gate", {}).values()))
    out["gates"], out["ok"] = gates, ok
    if not args.cpu:
        import subprocess

        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
