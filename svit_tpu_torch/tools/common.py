"""What the measuring tools share: their config, the JAX tools' random
weights, and the bench's train state and batches (``bench.py:171-192``)."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CFG = os.path.join(REPO, "configs", "ssv2.yaml")


def load_cfg(cfg_file=None, opts=(), edit=None):
    """The tools' config: ``cfg_file`` (configs/ssv2.yaml by default), the
    ``KEY VALUE`` pairs of ``opts``, then ``edit(cfg)``, checked."""
    from svit_tpu_torch.config import assert_and_infer_cfg, load_config

    cfg = load_config(argparse.Namespace(cfg_file=cfg_file or CFG,
                                         opts=list(opts)))
    if edit is not None:
        edit(cfg)
    return assert_and_infer_cfg(cfg)


def _leaves(tree, path=()):
    """(path, array) of a nested dict in ``jax.tree`` order (keys sorted
    at every level)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def fixed_params(model, seed: int = 7, fresh: bool = False) -> None:
    """Load the JAX tools' random parameters into ``model``: each leaf of
    the JAX package's parameter tree, in ``jax.tree`` order, is
    ``standard_normal(shape) * 0.02`` from ``RandomState(seed)`` (one
    stream, as ``tools/check_kernels_hw.py:_fixed_params`` draws; with
    ``fresh`` a new ``RandomState(seed)`` per leaf, as
    ``tools/trace_forward.py`` and ``tools/profile_model.py`` draw), cast
    to f32 and carried across by ``utils/converter.py``'s names."""
    from svit_tpu_torch.utils import converter

    tree = converter.params_to_jax(model.state_dict())
    rs = np.random.RandomState(seed)
    drawn: dict = {}
    for path, a in _leaves(tree):
        node = drawn
        for k in path[:-1]:
            node = node.setdefault(k, {})
        r = np.random.RandomState(seed) if fresh else rs
        node[path[-1]] = (r.standard_normal(a.shape) * 0.02).astype(
            np.float32)
    state = converter.params_from_jax(drawn)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            p.copy_(state[name])


def train_batches(cfg, video, image, device, rs=None, pixels=None):
    """``bench.py:171-192``'s train batches (video, image) on ``device``,
    drawn from ``rs`` (a new ``RandomState(0)`` by default); the clips and
    frames in ``pixels`` (their dtype, f32, by default)."""
    S, T = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES
    rs = np.random.RandomState(0) if rs is None else rs
    v = {"clips": rs.randn(video, T, S, S, 3).astype(np.float32),
         "labels": rs.randint(0, 174, video),
         "weight": np.ones((video,), np.float32)}
    i = {"frames": rs.randn(image, 1, S, S, 3).astype(np.float32),
         "haog_bboxes": (rs.rand(image, 1, cfg.SVIT.O, 4) * 0.5
                         + 0.1).astype(np.float32),
         "contact_state": rs.randint(-1, 5, (image, 2)),
         "weight": np.ones((image,), np.float32)}
    return tuple({k: torch.from_numpy(a).to(
        device, pixels if k in ("clips", "frames") else None)
        for k, a in b.items()} for b in (v, i))


def train_state(cfg, device, packed=False):
    """The model, its train state and the fused train step (video 7/8,
    image 1/8, the consistency forward), as ``bench.py`` builds them."""
    from svit_tpu_torch.engine import steps
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.models.optimizer import construct_optimizer

    model, arch = build_model(cfg, device=device, train=True)
    fixed_params(model, seed=1, fresh=True)
    tx, _ = construct_optimizer(cfg, model, steps_per_epoch=1000)
    state = steps.create_train_state(model, tx)
    make = steps.make_packed_train_step if packed else steps.make_train_step
    step = make(model, get_loss_func(cfg), tx, video_weight=7 / 8,
                image_weight=1 / 8, with_image=True, with_consistency=True)
    return model, arch, state, step
