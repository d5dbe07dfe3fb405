"""The ranks of ``tests/test_torch_parallel.py``: each process joins a gloo
group through a file, runs one scenario on the CPU and saves what it found
(``torch.save``) for the test to compare.  It imports neither JAX nor
``svit_tpu``, and runs torch on one thread.

Scenarios:
- ``dp``: data 2 x model 1; the train step on this rank's share of each
  batch of ``batches`` (a global batch of 2 videos + 2 images, and one of
  3 + 3 padded to 4 + 4, so that rank 1 alone holds a zero-weight pad),
  then on the first batch again with stochastic depth and dropout on
  (``stochastic_cfg``);
- ``tp``: data 1 x model 2; the same step on the first global batch, an
  eval forward of its clips, and a checkpoint written at model 2;
- ``test``: data 2; the multi-view test (``engine/test.py:test``) over a
  fixture tree, its video scores written by the master.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_cfg(get=None):
    """configs/ssv2.yaml at the suite's reduced size (56 px, 4 frames, f32)
    and depth 2 (the second block strided), stochastic depth and dropout
    off (the port's random streams cannot match JAX's); ``get`` is a
    package's ``get_cfg`` (the port's by default)."""
    if get is None:
        from svit_tpu_torch.config import get_cfg as get

    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.NUM_GPUS = 0
    return cfg


def stochastic_cfg():
    """``small_cfg`` with configs/ssv2.yaml's stochastic depth (0.4) and
    head dropout (0.5), and dropout after every block's attention and MLP
    (0.1): the masks of data parallelism must be one process's."""
    cfg = small_cfg()
    cfg.MVIT.DROPPATH_RATE = 0.4
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.MVIT.DROPOUT_RATE = 0.1
    return cfg


def batches(cfg):
    """Two global (video, image) batches of numpy arrays from a seed: 2 + 2
    rows, and 3 + 3 real rows padded to 4 + 4 with zero-weight rows."""
    rs = np.random.RandomState(0)
    S, T, O = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES, cfg.SVIT.O
    out = []
    for n, pad in ((2, 0), (3, 1)):
        video = {"clips": rs.randn(n + pad, T, S, S, 3).astype(np.float32),
                 "labels": rs.randint(0, cfg.MODEL.NUM_CLASSES, n + pad),
                 "weight": np.r_[np.ones(n), np.zeros(pad)].astype(np.float32)}
        image = {"frames": rs.randn(n + pad, 1, S, S, 3).astype(np.float32),
                 "haog_bboxes": (rs.rand(n + pad, 1, O, 4) * 0.5 + 0.1
                                 ).astype(np.float32),
                 "contact_state": rs.randint(-1, 5, (n + pad, 2)),
                 "weight": np.r_[np.ones(n), np.zeros(pad)].astype(np.float32)}
        image["haog_bboxes"][0, 0, 2] = 0.0      # an absent box
        out.append((video, image))
    return out


def share(batch, index, count):
    """Rows ``index`` of ``count`` equal runs of a numpy batch."""
    n = len(batch["weight"]) // count
    return {k: v[index * n:(index + 1) * n] for k, v in batch.items()}


def train_step(cfg, mesh, video, image):
    """One step from the seeded weights; returns (metrics, full gradients,
    full parameters after AdamW, the state)."""
    from svit_tpu_torch.engine import steps
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.models.optimizer import construct_optimizer
    from svit_tpu_torch.parallel import mesh as meshlib

    model, _ = build_model(cfg, device="cpu", train=True)
    meshlib.shard_model(model, mesh)
    tx, _ = construct_optimizer(cfg, model, steps_per_epoch=10)
    spec = meshlib.local_spec(mesh, model)
    if spec:
        tx.shard(mesh.model_group, [p for n, p in model.named_parameters()
                                    if n in spec])
    state = steps.create_train_state(model, tx)
    step = steps.make_train_step(
        model, get_loss_func(cfg), tx, video_weight=7 / 8, image_weight=1 / 8,
        with_image=True, with_consistency=True, mesh=mesh)
    state, metrics = step(
        state, {k: torch.as_tensor(v) for k, v in video.items()},
        {k: torch.as_tensor(v) for k, v in image.items()},
        torch.Generator().manual_seed(0))
    grads = {n: (meshlib._gather(p.grad, spec[n], mesh) if n in spec
                 else p.grad).clone()
             for n, p in model.named_parameters()}
    params = {k: v.clone() for k, v in
              meshlib.full_state_dict(model, mesh).items()}
    return ({k: float(v) for k, v in metrics.items()}, grads, params, state)


def main(rank, world, init_file, scenario, out_dir, extra=None):
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from svit_tpu_torch.parallel import dist as du
    from svit_tpu_torch.parallel import mesh as meshlib

    cfg = small_cfg() if scenario != "test" else extra
    cfg.NUM_SHARDS, cfg.SHARD_ID = 1, 0
    cfg.INIT_METHOD = "file://" + init_file
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_MODEL = ((1, 2) if scenario == "tp"
                                             else (2, 1))
    du.init_distributed(cfg, rank, world, backend="gloo")
    try:
        mesh = meshlib.build_mesh(cfg)
        out = {}
        if scenario == "dp":
            cases = [(cfg, b) for b in batches(cfg)]
            cases.append((stochastic_cfg(), batches(cfg)[0]))
            for i, (case_cfg, (video, image)) in enumerate(cases):
                m, g, p, _ = train_step(
                    case_cfg, mesh, share(video, mesh.data_index, mesh.data),
                    share(image, mesh.data_index, mesh.data))
                out[i] = (m, g, p)
        elif scenario == "tp":
            from svit_tpu_torch.utils import checkpoint as cu

            video, image = batches(cfg)[0]
            m, g, p, state = train_step(cfg, mesh, video, image)
            out[0] = (m, g, p)
            cu.save_checkpoint(out_dir, state, 0, cfg, mesh=mesh)
            from svit_tpu_torch.models import build_model

            model, _ = build_model(cfg, device="cpu")
            meshlib.shard_model(model, mesh)
            with torch.inference_mode():
                logits, extra_out = model(torch.as_tensor(video["clips"]))
            out["forward"] = (logits.clone(),
                              extra_out["pred_bboxes"].clone())
        else:
            from svit_tpu_torch.engine.test import test

            test(cfg, device="cpu")
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
