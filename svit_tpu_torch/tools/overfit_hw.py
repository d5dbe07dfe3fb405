"""The learning proof on the card (counterpart of ``tools/overfit_hw.py``):
the port's real CLI trains a trivially learnable task to convergence,
through a preemption and an auto-resume.

    python -m svit_tpu_torch.tools.overfit_hw [--out DIR]

1. builds the 4-colour fixture from a seed: 4 SSv2 videos of 12 JPEG
   frames at 80 x 64, each one solid colour, 4 classes;
2. phase 1: ``python -m svit_tpu_torch.tools.run_net --cfg <recipe>``,
   the captured train step with the hand-written kernels in bf16; after 6
   logged steps it is sent SIGTERM, and must write a mid-epoch checkpoint;
3. phase 2: the same command again auto-resumes from that checkpoint and
   trains to the end;
4. from the ``json_stats`` train log: the first ``loss_ce`` must be above
   1.0 and the last below 0.1 (``tools/overfit_hw.py``'s bar).

The recipe (``overfit_cfg``) is ``tests/test_overfit.py``'s at the main
path's head width (96, one head, so that every kernel takes it) and depth
2.  The result goes to ``DIR/overfit_hw.json`` (by default
``chiprun_out/``); nothing is written over the JAX tool's record.  Exits
non-zero unless the run resumed and converged.  ``tests/test_torch_overfit.py``
runs the recipe on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COLORS = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]
PREEMPT_AFTER = 6   # logged steps before the SIGTERM


def build_fixture(root, frames=12, size=(80, 64)):
    """A standard-split SSv2 tree in ``data/ssv2.py``'s layout: 4 videos,
    video i all colour i and class i, a hand box a frame.  Returns the
    ids."""
    from PIL import Image

    templates = [f"Doing thing {i}" for i in range(len(COLORS))]
    vids = [str(9100000 + i) for i in range(len(COLORS))]
    for d in ("sm/annotations", "json_files", "bbox_jsons"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "sm/annotations",
                           "something-something-v2-labels.json"), "w") as f:
        json.dump({t: str(i) for i, t in enumerate(templates)}, f)
    entries = [{"id": v, "template": t} for v, t in zip(vids, templates)]
    for split in ("train", "validation"):
        with open(os.path.join(root, "json_files",
                               f"something-something-v2-{split}.json"),
                  "w") as f:
            json.dump(entries, f)
    W, H = size
    for v, color in zip(vids, COLORS):
        os.makedirs(os.path.join(root, "frames", v), exist_ok=True)
        tracked = []
        for t in range(frames):
            name = "%04d.jpg" % (t + 1)
            Image.new("RGB", size, color).save(
                os.path.join(root, "frames", v, name))
            tracked.append({"name": f"frames/{v}/{name}", "labels": [
                {"standard_category": "hand", "box2d": {
                    "x1": 4.0, "y1": 4.0, "x2": W / 2, "y2": H / 2}}]})
        with open(os.path.join(root, "bbox_jsons", f"{int(v)}.json"),
                  "w") as f:
            json.dump(tracked, f)
    return vids


def overfit_cfg(root, out_dir, on_card=True):
    """The overfit recipe: 30 epochs of 2 steps (batch 2 of the 4 videos),
    AdamW at 1e-3, no augmentation, no image branch; on the card the
    hand-written kernels in bf16, else the plain twins in f32."""
    from svit_tpu_torch.config import assert_and_infer_cfg, get_cfg

    cfg = get_cfg()
    cfg.SSV2.DATA_ROOT = root
    cfg.SSV2.SPLIT = "standard"
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "ssv2"
    cfg.MODEL.MODEL_NAME = "SViT"
    cfg.MODEL.NUM_CLASSES = 5
    cfg.MODEL.LOSS_FUNC = "video_image_loss"
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.TRAIN_JITTER_SCALES = [32, 32]
    cfg.DATA.TRAIN_JITTER_SCALES_RELATIVE = []
    cfg.DATA.TRAIN_JITTER_ASPECT_RELATIVE = []
    cfg.DATA.RANDOM_FLIP = False
    cfg.AUG.ENABLE = False
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.EMBED_DIM = 96
    cfg.MVIT.NUM_HEADS = 1
    cfg.MVIT.PATCH_KERNEL = [3, 7, 7]
    cfg.MVIT.PATCH_STRIDE = [2, 4, 4]
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.REL_POS_SPATIAL = cfg.MVIT.REL_POS_TEMPORAL = True
    cfg.MVIT.RESIDUAL_POOLING = True
    cfg.MVIT.DIM_MUL_IN_ATT = True
    cfg.MVIT.USE_ABS_POS = False
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.TRAIN.EVAL_PERIOD = 29        # one val pass, at the end
    cfg.TRAIN.CHECKPOINT_PERIOD = 1000
    cfg.TRAIN.AUTO_RESUME = True
    cfg.TRAIN.FORWARD_VIDEO_FRAMES = False
    cfg.TRAIN.MIXED_PRECISION = on_card
    cfg.TPU.USE_PALLAS_ATTENTION = on_card
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL = 1, 1
    cfg.IMAGE_TRAIN.GPU_IDS = []
    cfg.NUM_GPUS = 1
    cfg.SOLVER.MAX_EPOCH = 30
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.COSINE_END_LR = 1e-4
    cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
    cfg.SOLVER.CLIP_GRAD_L2NORM = 1.0
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.LOG_PERIOD = 1
    cfg.TEST.ENABLE = False
    cfg.OUTPUT_DIR = out_dir
    return assert_and_infer_cfg(cfg)


def parse_losses(log_path):
    """The ``json_stats`` train_iter lines: [(epoch, iter, loss_ce)]."""
    out = []
    rx = re.compile(r"json_stats: (\{.*\})")
    with open(log_path, errors="replace") as f:
        for line in f:
            m = rx.search(line)
            if not m:
                continue
            try:
                d = json.loads(m.group(1))
            except json.JSONDecodeError:
                continue
            if d.get("_type") == "train_iter" and "loss_ce" in d:
                out.append((d.get("epoch"), d.get("iter"),
                            float(d["loss_ce"])))
    return out


def launch(cfg_path, log_path):
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "svit_tpu_torch.tools.run_net", "--cfg",
             cfg_path], stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=REPO)


def run(out):
    """Both phases; returns the result dict."""
    os.makedirs(out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="overfit_hw_", dir=out)
    root, out_dir = os.path.join(work, "data"), os.path.join(work, "out")
    build_fixture(root)
    cfg_path = os.path.join(work, "overfit.yaml")
    with open(cfg_path, "w") as f:
        f.write(overfit_cfg(root, out_dir).dump())
    log_path = os.path.join(work, "train.log")

    t0 = time.time()
    proc = launch(cfg_path, log_path)
    fired = False
    while proc.poll() is None and time.time() < t0 + 900:
        time.sleep(0.05)
        if not fired and len(parse_losses(log_path)) >= PREEMPT_AFTER:
            proc.send_signal(signal.SIGTERM)
            fired = True
    rc1 = proc.wait(timeout=300)
    phase1_s = time.time() - t0
    ckpts = sorted(glob.glob(os.path.join(out_dir, "checkpoints",
                                          "checkpoint_epoch_*")))
    n_phase1 = len(parse_losses(log_path))

    t1 = time.time()
    rc2 = launch(cfg_path, log_path).wait(timeout=900)
    losses = parse_losses(log_path)
    first, last = losses[0][2], losses[-1][2]
    result = {
        "on_card": True, "kernels": True, "mixed_precision": True,
        "phase1_rc": rc1, "phase2_rc": rc2, "sigterm_sent": fired,
        "steps_phase1": n_phase1,
        "preempt_checkpoint": os.path.basename(ckpts[-1]) if ckpts else None,
        "steps_total": len(losses), "loss_first": first, "loss_last": last,
        "resumed": bool(ckpts) and "_step_" in ckpts[-1]
        and len(losses) > n_phase1,
        "converged": first > 1.0 and last < 0.1,
        "phase1_s": phase1_s, "phase2_s": time.time() - t1, "log": log_path,
    }
    result["ok"] = (fired and rc1 == 0 and rc2 == 0 and result["resumed"]
                    and result["converged"])
    shutil.rmtree(os.path.join(out_dir, "checkpoints"), ignore_errors=True)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    args = p.parse_args(argv)
    result = run(args.out)
    with open(os.path.join(args.out, "overfit_hw.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
