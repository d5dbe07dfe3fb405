"""One fused train step of the port against the JAX package's, and the
train-mode forward's unfused dropout tail.

The depth-3, 56 px, 4-frame cut of ``configs/ssv2.yaml`` that
``tools/check_kernels_hw.py`` gates, in f32, with the consistency term on
(``SVIT.CONSISTENCY_LOSS = "l1"``) and the drop-path and dropout rates at 0
(the two frameworks' random streams cannot match).  Batch: 2 videos + 2
images, with the consistency forward and the image branch, weighted 7/8 and
1/8 as the shipped 7 + 1 rank recipe.  The port runs its plain twins (CPU
tensors); JAX runs ``make_train_step`` with ``use_pallas=False``.  The same
weights go to both sides (``torch_to_flax`` one way, ``params_from_jax``
back); the gradients are compared by parameter name.

Tolerances: f32 on both sides through three blocks, forward and backward,
in different summation orders: the loss and each metric to 1e-5 relative,
each gradient leaf to 1e-4 of its largest magnitude (measured: 2.3e-6 at
worst).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
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


def _cfg(get):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 3
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1]]
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.NUM_GPUS = 0
    return cfg


def _batches(cfg):
    rs = np.random.RandomState(0)
    S, T, O = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES, cfg.SVIT.O
    video = {"clips": rs.randn(2, T, S, S, 3).astype(np.float32),
             "labels": rs.randint(0, cfg.MODEL.NUM_CLASSES, 2),
             "weight": np.ones(2, np.float32)}
    image = {"frames": rs.randn(2, 1, S, S, 3).astype(np.float32),
             "haog_bboxes": (rs.rand(2, 1, O, 4) * 0.5 + 0.1).astype(np.float32),
             "contact_state": np.array([[0, -1], [3, 1]]),
             "weight": np.ones(2, np.float32)}
    image["haog_bboxes"][1, 0, 2] = 0.0      # an absent box
    return video, image


def _keep_grads():
    """An optax transform whose state after a step is the step's gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_train_step_matches_jax():
    video, image = _batches(_cfg(get_cfg))
    model, _ = build_model(_cfg(get_cfg), device="cpu", train=True)
    params = torch_to_flax(
        {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    )["params"]

    jm, _ = jax_build(_cfg(jax_get_cfg), use_pallas=False)
    jstep = jax.jit(jsteps.make_train_step(
        jm, jax_loss(_cfg(jax_get_cfg)), _keep_grads(), video_weight=7 / 8,
        image_weight=1 / 8, with_image=True, with_consistency=True))
    jstate = jsteps.create_train_state(jax.tree.map(jnp.asarray, params),
                                       _keep_grads())
    jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, video),
                             jax.tree.map(jnp.asarray, image),
                             jax.random.PRNGKey(0))
    jgrads = params_from_jax(jax.device_get(jstate.opt_state))

    tx, _ = construct_optimizer(_cfg(get_cfg), model, steps_per_epoch=10)
    tx.clip_l2norm = None          # keep p.grad as the raw gradient
    state = steps.create_train_state(model, tx)
    step = steps.make_train_step(
        model, get_loss_func(_cfg(get_cfg)), tx, video_weight=7 / 8,
        image_weight=1 / 8, with_image=True, with_consistency=True)
    state, metrics = step(
        state, {k: torch.as_tensor(v) for k, v in video.items()},
        {k: torch.as_tensor(v) for k, v in image.items()},
        torch.Generator().manual_seed(0))

    assert state.step == 1
    assert set(metrics) == set(jmetrics)
    assert "video_image_desc_l1_loss" in metrics
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    # a leaf whose true gradient is 0 (the k LN bias: softmax ignores a
    # per-row constant) holds rounding noise: floor its scale at 1e-3 of
    # the largest gradient of the model
    floor = 1e-3 * max(float(g.abs().max()) for g in jgrads.values())
    for k, g in jgrads.items():
        got, want = named[k].grad.numpy(), g.numpy()
        scale = max(float(np.abs(want).max()), floor)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0,
                                   err_msg=k)


def test_unfused_dropout_tail_matches_jax(monkeypatch):
    """With ``MVIT.DROPOUT_RATE > 0`` the block's residual tail is unfused
    (dropout sits inside the MLP).  Dropout made the identity on the port's
    side, that train-mode forward equals JAX's deterministic forward, which
    takes the same unfused path (f32, tolerance 5e-5 as the model tests)."""
    from svit_tpu_torch.models import attention as tattn
    from svit_tpu_torch.models import svit as tsvit

    def cfg_of(get):
        cfg = _cfg(get)
        cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
        cfg.MVIT.DROPOUT_RATE = 0.3
        return cfg

    calls = []

    def identity(t, rate, generator):
        calls.append(rate)
        return t

    monkeypatch.setattr(tattn, "dropout", identity)
    monkeypatch.setattr(tsvit, "dropout", identity)
    model, _ = build_model(cfg_of(get_cfg), device="cpu", train=True)
    params = torch_to_flax(
        {k: v.detach().numpy().copy() for k, v in model.state_dict().items()})
    jm, _ = jax_build(cfg_of(jax_get_cfg), use_pallas=False)
    x = np.random.RandomState(3).randn(2, 4, 32, 32, 3).astype(np.float32)
    _, want = jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))(
        params, jnp.asarray(x))
    with torch.no_grad():
        _, got = model(torch.from_numpy(x))
    assert calls and set(calls) == {0.3}
    for k in ("raw_logits", "obj_desc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=5e-5, err_msg=k)
