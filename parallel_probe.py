#!/usr/bin/env python3
"""Data and tensor parallelism across processes, one a card (NCCL), or on
the CPU (gloo):

    python3 parallel_probe.py            # every card of the host
    python3 parallel_probe.py --cpu --procs 4
    python3 parallel_probe.py --entry    # the entry points, every card
    python3 parallel_probe.py --entry --cpu --procs 4
    python3 parallel_probe.py --entry --timed   # run 5 below alone

``--entry`` drives ``svit_tpu_torch.tools.run_net`` (its ``launch_job``,
one process a card) at full size, below; the default mode the captured
step alone:

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

``--entry``: ``configs/ssv2.yaml`` at full size (SViT-B/16, 16 x 224, 16
blocks, bf16 on f32 masters, drop-path 0.4, head dropout 0.5, the
consistency term) on a synthetic SSv2 tree like ``chip_smoke.py`` phase
9's (56 videos of 24 JPEG frames with hand and object boxes, the train
listing 5 times over so that an epoch takes 10 steps; 8 validation
videos), each rank 7 videos and 8 images a step (the config's 8 ranks, 7
of them video ranks, want a video batch that 7 divides).  Runs 1 to 4 are
``python -m svit_tpu_torch.tools.run_net`` as a user runs it (its
``launch_job`` spawns a process a card); what they did is read from their
outputs: the master's ``json_stats`` lines (``LOG_PERIOD`` 1: each step's
loss, step time ``dt`` and data wait ``dt_data``) and its checkpoints.

1. data N x model 1: one Trainer epoch through the captured step, its
   checkpoint, its evaluation;
2. the same with ``TPU.REMAT=True``: its logged losses and its checkpoint
   (parameters and optimizer state) bit-equal to run 1's;
3. the resume at data N/2 x model 2: run 1's directory, one more epoch
   (the checkpoint cut to the new mesh); the log shows the resume and the
   second epoch, the checkpoint's step count goes on;
4. the multi-view test at data N on run 3's checkpoint, every rank's share
   gathered, and Grad-CAM through ``visualization/run.py`` (the master
   writes the TensorBoard events);
5. the timed pass, on N ranks and then on one card: the captured step at
   a rank's batch (7 + 8) from the seeded weights, without remat and
   with, its replays' wall time and peak memory; at N the step's gradient
   all-reduce alone (its buckets, captured as a graph of its own) timed on
   every rank at once.  All host wall times: the all-reduce's time over
   the step's is a stand-in, not its share of the step (alone it overlaps
   nothing and waits for no slower rank);
6. the test of run 3's checkpoint on one card with the kernels in bf16
   and the plain ops in bf16 and in f32: run 4's scores must pass
   ``chip_smoke.py``'s gate, err(data N) <= 3 err(plain bf16) + 2e-3
   against plain f32.

On the CPU (``--cpu``, gloo) the same runs at 56 px, depth 2, f32 through
the plain twins, on 8 videos of 8 frames, rehearse the plumbing (each
gloo rank runs ``run_net.main`` with its group up, so ``launch_job``
calls the entry point in that process).  The mode prints one JSON line
(details in ``chiprun_out/entry_probe.json``, each run's output in
``chiprun_out/entry_<run>.log``) and exits non-zero on a failed gate.

Every run (each of runs 1 to 5, the default mode's ranks) is a process
group of its own with a time limit (``LIMITS``, about 1.5 times its wall
on four cards).  A run past its limit has each rank's Python stack dumped
into its log, then its whole group (a process a card, their loader
workers) killed; a run past its limit or exiting non-zero prints its
name, its log's last lines, each rank's last stage and stack, and the
probe exits 1 with ``{"ok": false, "failed_run": ...}``.  The kernel
library is built before any rank starts.
"""

import argparse
import json
import os
import pickle
import re
import resource
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

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


def global_batch(cfg, n, images=None):
    """``n`` videos and ``images`` (``n`` by default) images from seed 0."""
    rs = np.random.RandomState(0)
    m = n if images is None else images
    S, T, O = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES, cfg.SVIT.O
    video = {"clips": rs.randn(n, T, S, S, 3).astype(np.float32),
             "labels": rs.randint(0, 10, n), "weight": np.ones(n, np.float32)}
    image = {"frames": rs.randn(m, 1, S, S, 3).astype(np.float32),
             "haog_bboxes": (rs.rand(m, 1, O, 4) * 0.5 + 0.1).astype(
                 np.float32),
             "contact_state": rs.randint(-1, 5, (m, 2)),
             "weight": np.ones(m, np.float32)}
    return video, image


def on(batch, device, lo=None, hi=None):
    return {k: torch.as_tensor(v[lo:hi]).to(device) for k, v in batch.items()}


def build_step(cfg, mesh, device, dtype=None, use_kernels=None):
    """The seeded model sharded over ``mesh``, its train state and its
    step (captured on the card); returns (model, state, step, the sharded
    parameters' specs)."""
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
    return model, state, step, spec


def step_once(cfg, mesh, video, image, device, twice=False, dtype=None,
              use_kernels=None):
    """One step from the seeded weights (captured on the card); returns
    (loss, full gradients, full parameters, replayed-again equal)."""
    from svit_tpu_torch.engine import graphs
    from svit_tpu_torch.parallel import mesh as meshlib

    model, state, step, spec = build_step(cfg, mesh, device, dtype,
                                          use_kernels)
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


# ---------------------------------------------------------------------------
# Bounded runs: every run of the probe is a process group of its own with a
# time limit, so that a stalled collective ends the run, not the call
# ---------------------------------------------------------------------------

# a run's limit in seconds, (card, CPU): about 1.5 times its wall on four
# NVIDIA H100 80GB HBM3 at 700 W on the slower of two hosts (runs 1 to 4:
# 140.0, 155.3, 132.7, 81.4 s; the faster host's 90.5, 102.1, 95.5, 57.7);
# the timed pass's four ranks took 44.1 s there and were still capturing
# at 75 s on the slower host (PERF.md); a wide margin on the CPU
LIMITS = {"1_data": (210, 240), "2_remat": (240, 240),
          "3_resume": (200, 240), "4_test_gradcam": (120, 240),
          "5_timed_data": (180, 180), "5_timed_one": (120, 120),
          "default": (90, 120)}
TAIL = 30               # lines of a failed run's log printed
STAGE = re.compile(r"rank (\d+) of \d+: (.*)$")


class RunFailed(Exception):
    """A bounded run that exited non-zero or passed its limit (its report
    is printed already)."""


def stager(label, rank, procs):
    """``say(what)``: where this rank is, on stderr, with its seconds since
    the call; a stalled run's report names each rank's last stage."""
    t_start = time.perf_counter()

    def say(what):   # one write, so that ranks' lines do not interleave
        sys.stderr.write(f"{label}, rank {rank} of {procs}: {what} "
                         f"({time.perf_counter() - t_start:.1f} s)\n")
        sys.stderr.flush()
    return say


def _stat(pid):
    """(state, parent, process group, start time) of ``pid``, or None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            st = f.read()
    except OSError:
        return None
    fields = st[st.rindex(")") + 2:].split()
    return fields[0], int(fields[1]), int(fields[2]), int(fields[19])


def group_processes(pgid):
    """The live (not zombie) processes of process group ``pgid``:
    {pid: (parent, start time)}."""
    out = {}
    for d in os.listdir("/proc"):
        st = _stat(d) if d.isdigit() else None
        if st and st[2] == pgid and st[0] not in "ZX":
            out[int(d)] = st[1], st[3]
    return out


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def main_stack(dump):
    """The innermost frames of the main thread in a ``faulthandler`` dump
    (the thread block that ends at ``<module>``), else of the first."""
    blocks, cur = [], None
    for line in dump.splitlines():
        if line.startswith(("Thread 0x", "Current thread 0x")):
            cur = []
            blocks.append(cur)
        elif cur is not None and line.strip().startswith("File "):
            cur.append(line.strip())
    main = [b for b in blocks if b and b[-1].endswith("in <module>")]
    return (main or blocks or [[]])[0][:8]


def dump_stacks(pgid, log_path):
    """Each rank's Python stack, for a stalled run: the group is stopped,
    then each rank (the leader's children that ``multiprocessing``
    spawned, in start order; else the leader) is sent SIGABRT and let run
    alone, so its ``faulthandler`` dump (``PYTHONFAULTHANDLER``) lands in
    the log by itself.  Returns [(label, innermost frames)]."""
    procs = group_processes(pgid)
    ranks = sorted((start, pid) for pid, (parent, start) in procs.items()
                   if parent == pgid and "spawn_main" in _cmdline(pid))
    labelled = [(f"rank {i}", pid) for i, (_, pid) in enumerate(ranks)]
    if not labelled and pgid in procs:
        labelled = [(f"process {pgid}", pgid)]
    try:
        os.killpg(pgid, signal.SIGSTOP)
    except ProcessLookupError:
        return []
    stacks = []
    for label, pid in labelled:
        start = os.path.getsize(log_path)
        try:
            os.kill(pid, signal.SIGABRT)
            os.kill(pid, signal.SIGCONT)
        except ProcessLookupError:
            continue
        deadline = time.monotonic() + 3
        while time.monotonic() < deadline and (_stat(pid) or "Z")[0] not in \
                "ZX":
            time.sleep(0.05)
        with open(log_path, errors="replace") as f:
            f.seek(start)
            stacks.append((label, main_stack(f.read())))
    return stacks


def kill_group(pgid, wait=10.0):
    """SIGKILL every process of group ``pgid`` and wait until none is
    left (or ``wait`` seconds)."""
    deadline = time.monotonic() + wait
    while True:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            return
        if not group_processes(pgid) or time.monotonic() > deadline:
            return
        time.sleep(0.05)


def report(name, limit, rc, log_path, lines, stacks):
    """Print what a failed or stalled run left: its name, its limit, its
    log's last lines, each rank's last stage and stack."""
    how = (f"stopped at its limit of {limit} s" if rc is None
           else f"exited {rc}")
    print(f"parallel_probe: run {name} {how}; the last {TAIL} lines of "
          f"{os.path.relpath(log_path, REPO)}:", flush=True)
    for line in lines[-TAIL:]:
        print(f"  | {line}")
    stages = {}
    for line in lines:
        m = STAGE.search(line)
        if m:
            stages[int(m.group(1))] = m.group(2)
    for rank in sorted(stages):
        print(f"  rank {rank}, last stage: {stages[rank]}")
    for label, frames in stacks:
        print(f"  {label}, stack (innermost first):")
        for frame in frames:
            print(f"    {frame}")
    sys.stdout.flush()


def bounded(name, cmd, limit, log_path):
    """Run ``cmd`` from the repo as a process group of its own, its output
    in ``log_path``, for at most ``limit`` seconds.  On expiry every rank's
    stack is dumped and the whole group (a process a card, their loader
    workers) killed; on expiry or a non-zero exit the report is printed
    and ``RunFailed`` raised.  Any process of the group left after a
    clean exit is killed too."""
    env = dict(os.environ, PYTHONFAULTHANDLER="1")
    soft, hard = resource.getrlimit(resource.RLIMIT_CORE)
    resource.setrlimit(resource.RLIMIT_CORE, (0, hard))   # no core files
    try:
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                    stderr=subprocess.STDOUT, env=env,
                                    start_new_session=True)
    finally:
        resource.setrlimit(resource.RLIMIT_CORE, (soft, hard))
    stacks = []
    try:
        rc = proc.wait(timeout=limit)
    except subprocess.TimeoutExpired:
        rc = None
        with open(log_path, errors="replace") as f:
            lines = f.read().splitlines()
        stacks = dump_stacks(proc.pid, log_path)
    finally:
        kill_group(proc.pid)
        proc.wait()
    if rc == 0:
        return
    if rc is not None:
        with open(log_path, errors="replace") as f:
            lines = f.read().splitlines()
    report(name, limit, rc, log_path, lines, stacks)
    raise RunFailed(name)


def limit_of(name, cpu):
    return LIMITS[name][1 if cpu else 0]


def spawn_cmd(kind, procs, *args):
    """The command that runs ``torch.multiprocessing.spawn`` of this
    file's ``RANK_FNS[kind]`` on ``procs`` ranks with ``args``."""
    return [sys.executable, os.path.abspath(__file__), "--ranks", kind,
            json.dumps({"procs": procs, "args": list(args)})]


def prebuild(cpu):
    """Build the kernel library before any rank starts (else the first rank
    to launch a kernel builds it while the others wait in their first
    step); returns its seconds (None on the CPU)."""
    if cpu:
        return None
    from svit_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.build()
    return time.perf_counter() - t0


def rank_main(rank, procs, init, cpu, out_path):
    import torch.distributed as dist

    from svit_tpu_torch.parallel import dist as du
    from svit_tpu_torch.parallel import mesh as meshlib

    say = stager("default mode", rank, procs)
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
        say("one-process steps done")
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{init}", world_size=procs,
                            rank=rank)
    say("group up")
    try:
        dp = meshlib.build_mesh(data=procs, model=1)
        lo, hi = rank, rank + 1
        d_loss, d_g, d_p, again = step_once(
            cfg, dp, on(video, device, lo, hi), on(image, device, lo, hi),
            device, twice=True)
        say(f"data {procs}: steps done")
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
        say(f"data {procs // 2} x model 2: step done")
    finally:
        say("leaving the group")
        du.destroy_process_group()
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


# ---------------------------------------------------------------------------
# --entry: the entry points through run_net on every card
# ---------------------------------------------------------------------------

VIDEO_PER_RANK, IMAGE_PER_RANK = 7, 8
# (videos, frames, train listings, validation videos)
TREE = {"card": (56, 24, 5, 8), "cpu": (8, 8, 7, 4)}
REPLAYS = 10            # timed replays of the step in the timed pass
OUT = os.path.join(REPO, "chiprun_out")


def entry_opts(cpu, root, out, procs, data, model, **kw):
    """``run_net``'s KEY VALUE list: the config at full size (on the CPU
    the reduced one) on the tree at ``root``, a data x model mesh, the
    global batch ``procs`` ranks' at data ``procs``."""
    opts = {"SSV2.DATA_ROOT": root, "OUTPUT_DIR": out,
            "TRAIN.BATCH_SIZE": VIDEO_PER_RANK * procs,
            "IMAGE_TRAIN.BATCH_SIZE": IMAGE_PER_RANK * procs,
            "TRAIN.CHECKPOINT_PERIOD": 1, "TRAIN.EVAL_PERIOD": 1,
            "LOG_PERIOD": 1, "SVIT.CONSISTENCY_LOSS": "l1",
            "TPU.MESH_DATA": data, "TPU.MESH_MODEL": model,
            "TEST.ENABLE": False, "INIT_METHOD":
            f"tcp://localhost:{free_port()}"}
    if cpu:
        opts.update({
            "DATA.TRAIN_CROP_SIZE": 56, "DATA.TEST_CROP_SIZE": 56,
            "DATA.NUM_FRAMES": 4, "MVIT.DEPTH": 2,
            "MVIT.POOL_Q_STRIDE": [[0, 1, 1, 1], [1, 1, 2, 2]],
            "MVIT.DIM_MUL": [[1, 2.0]], "MVIT.HEAD_MUL": [[1, 2.0]],
            "TRAIN.MIXED_PRECISION": False, "DATA_LOADER.NUM_WORKERS": 1})
    opts.update(kw)
    argv = ["--cfg", os.path.join(REPO, "configs", "ssv2.yaml")]
    for k, v in opts.items():
        argv += [k, str(v)]
    return argv


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_net(name, argv, cpu, procs):
    """``run_net`` as a user runs it, bounded: on the card a process of its
    own (its ``launch_job`` spawning a process a card); on the CPU
    ``procs`` gloo processes, each running ``run_net.main`` with its group
    up.  Its output goes to ``chiprun_out/entry_<name>.log``."""
    cmd = (spawn_cmd("run_net", procs, procs, argv) if cpu else
           [sys.executable, "-m", "svit_tpu_torch.tools.run_net", *argv])
    bounded(name, cmd, limit_of(name, cpu),
            os.path.join(OUT, f"entry_{name}.log"))


def cpu_rank(rank, procs, argv):
    from svit_tpu_torch.config import load_config, parse_args
    from svit_tpu_torch.parallel import dist as du
    from svit_tpu_torch.tools import run_net as rn

    torch.set_num_threads(1)
    du.init_distributed(load_config(parse_args(argv)), rank, procs,
                        backend="gloo")
    try:
        rn.main(argv, device="cpu")
    finally:
        du.destroy_process_group()


def logged(out):
    """The master's log of a run: its ``train_iter`` stats, each step's,
    and whether it resumed from a checkpoint."""
    with open(os.path.join(out, "stdout.log")) as f:
        lines = f.read().splitlines()
    stats = [json.loads(line.split("json_stats: ", 1)[1]) for line in lines
             if "json_stats: " in line]
    return ([s for s in stats if s["_type"] == "train_iter"],
            any("Auto-resumed from" in line for line in lines))


def load_state(ckpt):
    from svit_tpu_torch.utils import checkpoint as cu

    return torch.load(os.path.join(ckpt, cu.STATE_FILE), map_location="cpu",
                      weights_only=False)


def states_equal(a, b) -> bool:
    """Two checkpoints' step, parameters and optimizer moments bit for
    bit."""
    a, b = load_state(a), load_state(b)
    ma, mb = a["model_state"], b["model_state"]
    sa, sb = a["optimizer_state"]["state"], b["optimizer_state"]["state"]
    return (a["step"] == b["step"] and ma.keys() == mb.keys()
            and all(torch.equal(ma[k], mb[k]) for k in ma)
            and sa.keys() == sb.keys()
            and all(torch.equal(torch.as_tensor(sa[i][k]),
                                torch.as_tensor(sb[i][k]))
                    for i in sa for k in sa[i]))


def rank_timed(rank, procs, init, argv, cpu, out_dir):
    """One rank of the timed pass (``procs`` ranks at data ``procs``):
    the captured step from the seeded weights at a rank's batch without
    remat and with it, its replays' wall ms and peak memory; with several
    ranks the gradient all-reduce alone, at the step's buckets, captured
    as a graph of its own on the card, on every rank at once."""
    import torch.distributed as dist

    from svit_tpu_torch.config import assert_and_infer_cfg, load_config, \
        parse_args
    from svit_tpu_torch.engine import graphs
    from svit_tpu_torch.parallel import dist as du
    from svit_tpu_torch.parallel import mesh as meshlib

    say = stager("timed pass", rank, procs)
    torch.set_num_threads(1)
    device = torch.device("cpu" if cpu else f"cuda:{rank}")
    if not cpu:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{init}", world_size=procs,
                            rank=rank)
    say("group up")

    def timed(fn):
        times = []
        for _ in range(REPLAYS):
            t0 = time.perf_counter()
            fn()
            if not cpu:
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    out = {"rank": rank}
    try:
        for remat in (False, True):
            cfg = assert_and_infer_cfg(load_config(parse_args(argv + [
                "TPU.MESH_DATA", str(procs), "TPU.REMAT", str(remat)])))
            mesh = meshlib.build_mesh(cfg)
            model, state, step, _ = build_step(cfg, mesh, device)
            video, image = (on(b, device) for b in global_batch(
                cfg, VIDEO_PER_RANK, IMAGE_PER_RANK))
            gen = torch.Generator(device=device).manual_seed(0)
            if not cpu:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            say(f"remat {remat}: built")
            step(state, video, image, gen)    # on the card, the capture
            say(f"remat {remat}: first call")
            run = {"replay_ms": timed(lambda: step(state, video, image,
                                                   gen)),
                   "peak_gib": (None if cpu else
                                torch.cuda.max_memory_allocated(device)
                                / 2 ** 30)}
            if not remat and procs > 1:
                params = [p for p in model.parameters() if p.requires_grad]

                def all_reduce():
                    meshlib.all_reduce_gradients(params, mesh.data_group)

                if not cpu:
                    all_reduce()
                    graph = graphs.CudaGraph()
                    graph.capture(all_reduce)
                    all_reduce = graph.replay
                say("all-reduce captured alone")
                run["all_reduce_alone_ms"] = timed(all_reduce)
            out["remat" if remat else "no_remat"] = run
            del model, state, step
            if not cpu:
                torch.cuda.empty_cache()
    finally:
        say("leaving the group")
        du.destroy_process_group()
    with open(os.path.join(out_dir, f"timed_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def timed_pass(name, argv, cpu, procs, tmp):
    """``rank_timed`` on ``procs`` ranks, bounded as run ``name`` (its
    output in ``chiprun_out/entry_<name>.log``); returns every rank's
    figures."""
    out = tempfile.mkdtemp(dir=tmp)
    bounded(name, spawn_cmd("timed", procs, procs, os.path.join(out, "init"),
                            argv, cpu, out),
            limit_of(name, cpu), os.path.join(OUT, f"entry_{name}.log"))
    ranks = []
    for r in range(procs):
        with open(os.path.join(out, f"timed_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def timed_figures(cpu, procs, tmp):
    """Run 5: the timed pass at data ``procs`` and on one card; the
    replay's median against one card's, and the all-reduce's stand-in."""
    base = entry_opts(cpu, os.path.join(tmp, "ssv2"),
                      os.path.join(tmp, "timed"), procs, procs, 1)
    out, walls = {}, {}
    for key, name, n in (("data", "5_timed_data", procs),
                         ("one_card", "5_timed_one", 1)):
        t0 = time.perf_counter()
        out[key] = summarize_timed(timed_pass(name, base, cpu, n, tmp))
        walls[key] = time.perf_counter() - t0
        print(f"entry_probe: {name} {walls[key]:.1f} s", flush=True)
    out["walls_s"] = walls
    step_ms = statistics.median(out["data"]["no_remat"]["replay_ms"])
    reduce_ms = out["data"]["all_reduce_alone_ms"]
    out["replay_over_one_card"] = (
        step_ms / out["one_card"]["no_remat"]["replay_ms"][0])
    out["all_reduce_alone_over_replay"] = (statistics.median(reduce_ms)
                                           / step_ms)
    out["all_reduce_timed"] = all(ms > 0 for ms in reduce_ms)
    return out


def timed_main(cpu, procs):
    """``--entry --timed``: run 5 alone, one JSON line."""
    os.makedirs(OUT, exist_ok=True)
    build_s = prebuild(cpu)
    out = timed_figures(cpu, procs, tempfile.mkdtemp())
    out.update(procs=procs, cpu_count=os.cpu_count(), build_s=build_s,
               cards=None if cpu else card_lines())
    print(json.dumps(out), flush=True)
    return 0 if out["all_reduce_timed"] else 1


def write_tree(root, cpu):
    """``chip_smoke.make_ssv2_tree`` with boxes, the train listing repeated
    and the validation listing cut to its first videos."""
    import chip_smoke

    videos, frames, listed, val = TREE["cpu" if cpu else "card"]
    chip_smoke.make_ssv2_tree(root, 174, videos, frames, haog=True)
    listing = os.path.join(root, "json_files",
                           "something-something-v2-{}.json")
    for split, f in (("train", lambda e: e * listed),
                     ("validation", lambda e: e[:val])):
        with open(listing.format(split)) as fh:
            entries = json.load(fh)
        with open(listing.format(split), "w") as fh:
            json.dump(f(entries), fh)
    return videos, frames, listed, val


def quartiles(xs):
    q = (statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1
         else [xs[0]] * 3)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def summarize_log(stats):
    """A run's logged steps: losses, and the step time and data wait
    (steady steps: neither the first nor the last)."""
    steady = stats[1:-1] or stats
    return {"iters": [s["epoch"] + " " + s["iter"] for s in stats],
            "losses": [s["loss"] for s in stats],
            "dt_ms": quartiles([s["dt"] * 1e3 for s in steady]),
            "data_wait_ms": quartiles([s["dt_data"] * 1e3 for s in steady])}


def summarize_timed(ranks):
    out = {}
    for key in ("no_remat", "remat"):
        out[key] = {"replay_ms": [statistics.median(r[key]["replay_ms"])
                                  for r in ranks],
                    "peak_gib": [r[key]["peak_gib"] for r in ranks]}
    if "all_reduce_alone_ms" in ranks[0]["no_remat"]:
        out["all_reduce_alone_ms"] = [statistics.median(
            r["no_remat"]["all_reduce_alone_ms"]) for r in ranks]
    return out


def one_card_test(cpu, procs, root, ckpt, tmp):
    """The multi-view test of ``ckpt`` in this process, three ways;
    returns (seconds, video scores) by way."""
    from svit_tpu_torch.config import assert_and_infer_cfg, load_config, \
        parse_args
    from svit_tpu_torch.engine.test import test

    device = torch.device("cpu" if cpu else "cuda")
    base = entry_opts(cpu, root, os.path.join(tmp, "one"), procs, 1, 1)
    seconds, scores = {}, {}
    for name, batch, bf16, kernels in (("kernels", 64, True, True),
                                       ("plain_bf16", 16, True, False),
                                       ("plain_f32", 16, False, False)):
        path = os.path.join(tmp, f"one_{name}.pkl")
        cfg = assert_and_infer_cfg(load_config(parse_args(base + [
            "TEST.ENABLE", "True", "TEST.BATCH_SIZE", str(batch),
            "TEST.CHECKPOINT_FILE_PATH", ckpt,
            "TEST.SAVE_RESULTS_PATH", path,
            "TRAIN.MIXED_PRECISION", str(bf16),
            "TPU.USE_PALLAS_ATTENTION", str(kernels)])))
        t0 = time.perf_counter()
        test(cfg, device=device)
        seconds[name] = time.perf_counter() - t0
        with open(path, "rb") as f:
            scores[name] = pickle.load(f)
        if not cpu:
            torch.cuda.empty_cache()
    return seconds, scores


def event_files(out):
    return sorted(os.path.join(d, n) for d, _, ns in os.walk(out)
                  for n in ns if n.startswith("events.out.tfevents"))


def entry_main(cpu, procs):
    from svit_tpu_torch.utils import checkpoint as cu

    t_start = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    build_s = prebuild(cpu)
    tmp = tempfile.mkdtemp()
    root = os.path.join(tmp, "ssv2")
    t0 = time.perf_counter()
    tree = write_tree(root, cpu)
    steps = tree[0] * tree[2] // (VIDEO_PER_RANK * procs)
    res = {"procs": procs, "cpu_count": os.cpu_count(), "build_s": build_s,
           "device": "cpu" if cpu else torch.cuda.get_device_name(0),
           "cards": None if cpu else card_lines(),
           "tree": dict(zip(("videos", "frames", "listed", "val_videos"),
                            tree), seconds=time.perf_counter() - t0),
           "per_rank_batch": [VIDEO_PER_RANK, IMAGE_PER_RANK],
           "steps_per_epoch": steps}
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        print(f"entry_probe: {name} {walls[name]:.1f} s", flush=True)
        return out

    run1, remat = os.path.join(tmp, "run"), os.path.join(tmp, "remat")
    timed("1_data", run_net, "1_data", entry_opts(
        cpu, root, run1, procs, procs, 1, **{"SOLVER.MAX_EPOCH": 1}), cpu,
        procs)
    ckpt1 = cu.get_last_checkpoint(run1)
    log1, _ = logged(run1)
    timed("2_remat", run_net, "2_remat", entry_opts(
        cpu, root, remat, procs, procs, 1,
        **{"SOLVER.MAX_EPOCH": 1, "TPU.REMAT": True}), cpu, procs)
    log2, _ = logged(remat)
    timed("3_resume", run_net, "3_resume", entry_opts(
        cpu, root, run1, procs, procs // 2, 2, **{"SOLVER.MAX_EPOCH": 2}),
        cpu, procs)
    log3, resumed = logged(run1)
    log3 = log3[len(log1):]
    ckpt2 = cu.get_last_checkpoint(run1)
    out4 = os.path.join(tmp, "test")
    results = os.path.join(out4, "results.pkl")
    timed("4_test_gradcam", run_net, "4_test_gradcam", entry_opts(
        cpu, root, out4, procs, procs, 1, **{
            "TRAIN.ENABLE": False, "TEST.ENABLE": True,
            "TEST.CHECKPOINT_FILE_PATH": ckpt2,
            "TEST.SAVE_RESULTS_PATH": results,
            "TENSORBOARD.ENABLE": True, "TENSORBOARD.MODEL_VIS.ENABLE": True,
            "TENSORBOARD.MODEL_VIS.INPUT_VIDEO": True}), cpu, procs)
    with open(results, "rb") as f:
        gathered = pickle.load(f)
    events = event_files(out4)
    res["timed"] = timed("5_timed", timed_figures, cpu, procs, tmp)
    seconds, scores = timed("6_one_card_test", one_card_test, cpu, procs,
                            root, ckpt2, tmp)

    res["run1_data"], res["run2_remat"], res["run3_resume"] = (
        summarize_log(x) for x in (log1, log2, log3))
    res["checkpoints"] = [os.path.relpath(c, tmp) for c in (ckpt1, ckpt2)]
    steps2 = load_state(ckpt2)["step"]
    res["remat_bit_equal"] = (
        [s["loss"] for s in log1] == [s["loss"] for s in log2]
        and states_equal(ckpt1, cu.get_last_checkpoint(remat)))
    res["resume"] = {"logged": resumed,
                     "last_loss_before": log1[-1]["loss"] if log1 else None,
                     "first_loss_after": log3[0]["loss"] if log3 else None,
                     "first_iter_after": res["run3_resume"]["iters"][:1],
                     "steps_in_checkpoint": steps2}
    f32 = np.asarray(scores["plain_f32"]["video_preds"], np.float64)

    def err(preds):
        p = np.asarray(preds, np.float64)
        return float(np.linalg.norm(p - f32) / max(np.linalg.norm(f32),
                                                   1e-30))

    err_data, err_plain = err(gathered["video_preds"]), err(
        scores["plain_bf16"]["video_preds"])
    res["test"] = {
        "videos": len(gathered["video_labels"]), "one_card_s": seconds,
        "labels_equal": bool(np.array_equal(
            gathered["video_labels"], scores["kernels"]["video_labels"])),
        "err_data_vs_f32": err_data, "err_plain_bf16_vs_f32": err_plain,
        "err_one_card_kernels_vs_f32": err(scores["kernels"]["video_preds"]),
        "max_abs_vs_one_card_kernels": float(np.abs(
            np.asarray(gathered["video_preds"], np.float64)
            - np.asarray(scores["kernels"]["video_preds"])).max()),
        "limit": 3 * err_plain + 2e-3}
    res["gradcam"] = {"event_files": [os.path.relpath(e, out4)
                                      for e in events],
                      "bytes": [os.path.getsize(e) for e in events]}
    res["walls_s"] = dict(walls, total=time.perf_counter() - t_start)
    gates = {
        "epoch_steps": len(log1) == len(log2) == steps,
        "remat_bit_equal": res["remat_bit_equal"],
        "resume_logged": resumed,
        "resume_continues": len(log3) == steps and steps2 == 2 * steps
        and all(s["epoch"].startswith("2/") for s in log3),
        "finite": all(np.isfinite(s["loss"]) for s in log1 + log2 + log3),
        "test_labels": res["test"]["labels_equal"],
        "test_gate": err_data <= res["test"]["limit"],
        "gradcam_master_writes": len(events) == 1
        and os.path.getsize(events[0]) > 0,
        "all_reduce_timed": res["timed"]["all_reduce_timed"]}
    res["gates"], res["ok"] = gates, all(gates.values())
    with open(os.path.join(OUT, "entry_probe.json"), "w") as f:
        json.dump(res, f, indent=1)
    brief = {k: res[k] for k in ("procs", "device", "cards", "cpu_count",
                                 "gates", "ok", "resume", "timed",
                                 "walls_s")}
    brief["test"] = {k: res["test"][k] for k in (
        "err_data_vs_f32", "err_plain_bf16_vs_f32", "limit")}
    brief["data_wait_ms"] = res["run1_data"]["data_wait_ms"]
    brief["dt_ms"] = res["run1_data"]["dt_ms"]
    print(json.dumps(brief), flush=True)
    return 0 if res["ok"] else 1


def card_lines():
    """Each card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()


def default_main(cpu, procs):
    """The default mode, bounded: the captured step at data ``procs`` and
    at data ``procs / 2`` x model 2 against one process; one JSON line."""
    os.makedirs(OUT, exist_ok=True)
    build_s = prebuild(cpu)
    tmp = tempfile.mkdtemp()
    out_path = os.path.join(tmp, "result.json")
    t0 = time.perf_counter()
    bounded("default", spawn_cmd("default", procs, procs,
                                 os.path.join(tmp, "init"), cpu, out_path),
            limit_of("default", cpu), os.path.join(OUT, "default_probe.log"))
    wall_s = time.perf_counter() - t0
    with open(out_path) as f:
        out = json.load(f)
    gates = ({"loss": 1e-6, "grads": 1e-4, "params": 1e-6} if cpu else
             {"loss": 1e-4, "grads": 2e-2, "params": 1e-3})
    held = ("dp_vs_one", "tp_vs_dp") if cpu else ("dp_vs_one",)
    ok = (out["dp_replay_bit_equal"] and out["dp_ranks_equal"]
          and all(out[c][k] <= v for c in held for k, v in gates.items())
          and all(g["err_model2"] <= g["limit"]
                  for g in out.get("bf16_gate", {}).values()))
    out.update(gates=gates, ok=ok, build_s=build_s, wall_s=wall_s,
               cards=None if cpu else card_lines())
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


# what ``--ranks KIND`` spawns
RANK_FNS = {"run_net": cpu_rank, "timed": rank_timed, "default": rank_main}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--procs", type=int, default=0)
    p.add_argument("--entry", action="store_true",
                   help="the entry points through run_net")
    p.add_argument("--timed", action="store_true",
                   help="with --entry: its timed pass (run 5) alone")
    p.add_argument("--ranks", nargs=2, metavar=("KIND", "JSON"),
                   help="(a bounded run's own command) spawn the ranks of "
                   "KIND with the JSON's procs and args")
    args = p.parse_args()
    sys.path.insert(0, REPO)
    if args.ranks:
        kind, payload = args.ranks[0], json.loads(args.ranks[1])
        torch.multiprocessing.spawn(RANK_FNS[kind], args=tuple(
            payload["args"]), nprocs=payload["procs"])
        return 0
    if not args.cpu and not torch.cuda.is_available():
        print("parallel_probe: no CUDA device (pass --cpu)", file=sys.stderr)
        return 2
    procs = args.procs or (4 if args.cpu else torch.cuda.device_count())
    if procs < 2 or procs % 2:
        print(f"parallel_probe: needs an even number of processes, not "
              f"{procs}", file=sys.stderr)
        return 2
    run = (timed_main if args.timed else entry_main) if args.entry else \
        default_main
    try:
        return run(args.cpu, procs)
    except RunFailed as e:
        print(json.dumps({"ok": False, "failed_run": str(e)}), flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
