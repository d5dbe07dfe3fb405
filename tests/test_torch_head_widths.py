"""The port against the JAX package at the head widths and channel counts
that the card's kernels took last: head_dim 32 (the JAX package's small
schedules, EMBED_DIM 32), 48 (``configs/ssv2.yaml`` with ``MVIT.NUM_HEADS
2``) and 72 (``MVIT.EMBED_DIM 144 MVIT.NUM_HEADS 2``, MViTv2-L's widths).

Each at 56 px and 4 frames, cut to two or three blocks with one stride-q
block (the channel and head doublings there: C 32 -> 64, 96 -> 192, 144 ->
288), in f32.  The same weights go to both sides (``torch_to_flax`` one
way, ``params_from_jax`` back) and the same numpy-seeded inputs.  JAX runs
its Pallas kernels (``use_pallas=True``: ``fused_pool_ln`` and
``pooled_attention`` at these widths) in interpret mode on the CPU, as its
own tests run them; the port's wrappers take their plain twins on CPU
tensors.

Tolerances: the forward's outputs to a relative L2 error of 1e-5 (f32 on
both sides, as ``tests/test_torch_options.py``); one train step
(``use_pallas=False`` on the JAX side, as ``tests/test_torch_train_step.py``)
its loss and metrics to 1e-5 relative and each gradient leaf to 1e-4 of its
largest magnitude, that test's tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.engine import steps as jsteps
from svit_tpu.models import build_model as jax_build
from svit_tpu.models.losses import get_loss_func as jax_loss
from svit_tpu.utils.converter import torch_to_flax
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.engine import steps
from svit_tpu_torch.models import build_model
from svit_tpu_torch.models.losses import get_loss_func
from svit_tpu_torch.models.optimizer import construct_optimizer
from svit_tpu_torch.utils.converter import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(get, widths):
    """(b) the JAX package's small schedule (``tests/test_pallas_attention.py
    :150-170``) at 56 px; (c) and (d) the cut of ``configs/ssv2.yaml`` that
    ``tests/test_torch_train_step.py`` steps, at their widths."""
    cfg = get()
    if widths == "embed32":
        cfg.MODEL.MODEL_NAME = "SViT"
        cfg.MODEL.NUM_CLASSES = 5
        cfg.MVIT.DEPTH = 2
        cfg.MVIT.EMBED_DIM = 32
        cfg.MVIT.PATCH_PADDING = [1, 3, 3]
        cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
        cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
        cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
        cfg.MVIT.REL_POS_SPATIAL = True
        cfg.MVIT.REL_POS_TEMPORAL = True
        cfg.MVIT.USE_ABS_POS = False
    else:
        cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
        cfg.MVIT.DEPTH = 3
        cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1]]
        cfg.MVIT.NUM_HEADS = 2
        if widths == "embed144":
            cfg.MVIT.EMBED_DIM = 144
        cfg.SVIT.CONSISTENCY_LOSS = "l1"
        cfg.NUM_GPUS = 0
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.TRAIN.MIXED_PRECISION = False
    return cfg


# widths -> the head widths its blocks take
WIDTHS = {"embed32": {32}, "heads2": {48}, "embed144": {72}}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _flat(out):
    logits, extra = out
    flat = {"logits": np.asarray(logits)}
    for k, v in extra.items():
        for sub, t in (v.items() if isinstance(v, dict) else [("", v)]):
            flat[f"{k}.{sub}"] = np.asarray(t)
    return flat


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_forward_matches_jax(widths):
    port, arch = build_model(_cfg(get_cfg, widths), device="cpu")
    assert {s.dim_out // s.num_heads for s in arch.blocks} == WIDTHS[widths]
    params = torch_to_flax({k: v.detach().numpy().copy()
                            for k, v in port.state_dict().items()})
    jm, _ = jax_build(_cfg(jax_get_cfg, widths), use_pallas=True)
    x = np.random.RandomState(4).randn(2, 4, 56, 56, 3).astype(np.float32)
    want = _flat(jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))(
        params, jnp.asarray(x)))
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        got = _flat(port(torch.from_numpy(x)))
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, (k, _rel(got[k], want[k]))


def _batches(cfg):
    rs = np.random.RandomState(0)
    S, T, O = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES, cfg.SVIT.O
    video = {"clips": rs.randn(2, T, S, S, 3).astype(np.float32),
             "labels": rs.randint(0, cfg.MODEL.NUM_CLASSES, 2),
             "weight": np.ones(2, np.float32)}
    image = {"frames": rs.randn(2, 1, S, S, 3).astype(np.float32),
             "haog_bboxes": (rs.rand(2, 1, O, 4) * 0.5 + 0.1).astype(
                 np.float32),
             "contact_state": np.array([[0, -1], [3, 1]]),
             "weight": np.ones(2, np.float32)}
    return video, image


def _keep_grads():
    """An optax transform whose state after a step is the step's gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("widths", ["heads2", "embed144"])
def test_train_step_matches_jax(widths):
    cfg = _cfg(get_cfg, widths)
    video, image = _batches(cfg)
    model, _ = build_model(cfg, device="cpu", train=True)
    params = torch_to_flax({k: v.detach().numpy().copy()
                            for k, v in model.state_dict().items()})["params"]
    jcfg = _cfg(jax_get_cfg, widths)
    jm, _ = jax_build(jcfg, use_pallas=False)
    jstep = jax.jit(jsteps.make_train_step(
        jm, jax_loss(jcfg), _keep_grads(), video_weight=7 / 8,
        image_weight=1 / 8, with_image=True, with_consistency=True))
    jstate = jsteps.create_train_state(jax.tree.map(jnp.asarray, params),
                                       _keep_grads())
    jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, video),
                             jax.tree.map(jnp.asarray, image),
                             jax.random.PRNGKey(0))
    jgrads = params_from_jax(jax.device_get(jstate.opt_state))

    tx, _ = construct_optimizer(cfg, model, steps_per_epoch=10)
    tx.clip_l2norm = None          # keep p.grad as the raw gradient
    state = steps.create_train_state(model, tx)
    step = steps.make_train_step(
        model, get_loss_func(cfg), tx, video_weight=7 / 8, image_weight=1 / 8,
        with_image=True, with_consistency=True)
    state, metrics = step(
        state, {k: torch.as_tensor(v) for k, v in video.items()},
        {k: torch.as_tensor(v) for k, v in image.items()},
        torch.Generator().manual_seed(0))
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    # a leaf whose true gradient is 0 (the k LN bias) holds rounding noise:
    # its scale floored at 1e-3 of the model's largest gradient
    floor = 1e-3 * max(float(g.abs().max()) for g in jgrads.values())
    for k, g in jgrads.items():
        got, want = named[k].grad.numpy(), g.numpy()
        scale = max(float(np.abs(want).max()), floor)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0,
                                   err_msg=k)
    # the global gradient vector
    flat_got = np.concatenate([named[k].grad.numpy().ravel()
                               for k in sorted(jgrads)])
    flat_want = np.concatenate([jgrads[k].numpy().ravel()
                                for k in sorted(jgrads)])
    assert _rel(flat_got, flat_want) <= 1e-5
