"""The port's losses, box ops and optimizer against the JAX package.

Losses and box ops: values and gradients on fixed numpy inputs, including
zero-weight padding samples, absent (all-zero) target boxes and ``-1``
contact states.  Optimizer: three AdamW steps fed the same gradients, with
the weight-decay mask, the global-norm clip (triggered on two of the steps)
and the per-step learning-rate table, against ``construct_optimizer``'s
optax chain, compared by parameter name on the params and both moments.

Tolerances: f32 on both sides.  Losses and box ops 1e-6 relative (the same
formulas, summed in another order); optimizer 1e-6 absolute plus 1e-5
relative (three updates of size ~lr).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.models import losses as jl
from svit_tpu.models.optimizer import construct_optimizer as jax_optimizer
from svit_tpu.ops import box_ops as jb
from svit_tpu.utils.converter import torch_to_flax
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.engine import steps
from svit_tpu_torch.models import build_model
from svit_tpu_torch.models import losses as tl
from svit_tpu_torch.models.optimizer import construct_optimizer
from svit_tpu_torch.ops import box_ops as tb
from svit_tpu_torch.utils.converter import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=10 * tol)


def _both(jfn, tfn, float_args, other=()):
    """Value and gradient (w.r.t. the float args) of a scalar loss."""
    jv, jg = jax.value_and_grad(
        lambda *a: jfn(*a, *[jnp.asarray(o) for o in other]),
        argnums=tuple(range(len(float_args))))(*map(jnp.asarray, float_args))
    leaves = [torch.tensor(a, requires_grad=True) for a in float_args]
    tv = tfn(*leaves, *[torch.as_tensor(o) for o in other])
    tv.backward()
    _close(tv, jv)
    for t, g in zip(leaves, jg):
        _close(t.grad, g)


def _case(seed=0, B=4, T=2, O=4, nc=7):
    rs = np.random.RandomState(seed)
    weight = np.array([1.0, 1.0, 0.0, 1.0], np.float32)[:B]   # one padding
    boxes = (rs.rand(B, T, O, 4) * 0.5 + 0.1).astype(np.float32)
    boxes[0, 0, 1] = 0.0                                        # absent
    boxes[1, :, 3] = 0.0
    return dict(
        logits=rs.randn(B, nc).astype(np.float32),
        labels=rs.randint(0, nc, B),
        soft=rs.dirichlet(np.ones(nc), B).astype(np.float32),
        weight=weight,
        pred=rs.randn(B, T, O, 5).astype(np.float32),
        boxes=boxes,
        scored=np.concatenate([rs.rand(B, T, O, 1), boxes], -1).astype(
            np.float32),
        contact_pred=rs.randn(B, T, 2, 5).astype(np.float32),
        contact=np.array([[0, -1], [3, 4], [-1, -1], [1, 2]])[:B],
        desc=rs.randn(B, T, O, 8).astype(np.float32),
        fdesc=rs.randn(B, T, O, 8).astype(np.float32),
    )


@pytest.mark.parametrize("weighted", [False, True])
def test_classification_losses_match_jax(weighted):
    c = _case(1)
    w = (c["weight"],) if weighted else ()
    _both(jl.cross_entropy, tl.cross_entropy, (c["logits"],),
          (c["labels"], *w))
    _both(jl.soft_target_cross_entropy, tl.soft_target_cross_entropy,
          (c["logits"],), (c["soft"],))
    _both(lambda x, y: jl.bce_with_logits(x, y).sum(),
          lambda x, y: tl.bce_with_logits(x, y).sum(), (c["logits"],),
          (c["soft"],))


@pytest.mark.parametrize("target", ["cxcywh", "scored"])
@pytest.mark.parametrize("weighted", [False, True])
def test_box_and_contact_losses_match_jax(target, weighted):
    c = _case(2)
    tar = c["boxes"] if target == "cxcywh" else c["scored"]
    w = (c["weight"],) if weighted else ()
    for i in range(3):
        _both(lambda p, t, *w: jl.boxes_loss(p, t, *w)[i],
              lambda p, t, *w: tl.boxes_loss(p, t, *w)[i], (c["pred"],),
              (tar, *w))
    _both(jl.contact_state_loss, tl.contact_state_loss, (c["contact_pred"][:, :1],),
          (c["contact"], *w))


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_consistency_loss_matches_jax(kind):
    c = _case(3)
    _both(lambda v, f: jl.consistency_loss(v, f, kind),
          lambda v, f: tl.consistency_loss(v, f, kind), (c["desc"],),
          (c["fdesc"],))


def test_box_ops_match_jax():
    c = _case(4)
    b = c["pred"][..., 1:]
    _close(tb.box_cxcywh_to_xyxy(torch.from_numpy(b)), jb.box_cxcywh_to_xyxy(b))
    _close(tb.box_xyxy_to_cxcywh(torch.from_numpy(b)), jb.box_xyxy_to_cxcywh(b))
    _close(tb.box_area(torch.from_numpy(b)), jb.box_area(b))
    _both(lambda p, t: jb.paired_giou(jb.box_cxcywh_to_xyxy(p),
                                      jb.box_cxcywh_to_xyxy(t)).sum(),
          lambda p, t: tb.paired_giou(tb.box_cxcywh_to_xyxy(p),
                                      tb.box_cxcywh_to_xyxy(t)).sum(),
          (np.abs(b),), (c["boxes"],))


def _ssv2(get, consistency=""):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.SVIT.CONSISTENCY_LOSS = consistency
    return cfg


@pytest.mark.parametrize("consistency", ["", "l1"])
def test_video_image_loss_matches_jax(consistency):
    jobj = jl.get_loss_func(_ssv2(jax_get_cfg, consistency))
    tobj = tl.get_loss_func(_ssv2(get_cfg, consistency))
    assert tobj.lambdas == jobj.lambdas
    # the quirk: the key FORWARD_VIDEO_FRAMES adds is one no loss emits
    assert "video_image_boxes_l1_loss" in tobj.lambdas
    c = _case(5)

    def run(obj, mod):
        a = (lambda x: jnp.asarray(x)) if mod is jnp else torch.as_tensor
        v = obj.video_losses(a(c["logits"]), a(c["labels"]),
                             {"obj_desc": a(c["desc"])},
                             {"obj_desc": a(c["fdesc"])}, a(c["weight"]))
        i = obj.image_losses(
            {"pred_bboxes": a(c["pred"][:, :1]),
             "pred_contact_state": a(c["contact_pred"][:, :1])},
            {"haog_bboxes": a(c["boxes"][:, :1]),
             "contact_state": a(c["contact"])}, a(c["weight"]))
        return v, i, obj.weighted_sum(v) + obj.weighted_sum(i)

    (jv, ji, jt), (tv, ti, tt) = run(jobj, jnp), run(tobj, torch)
    assert set(tv) == set(jv) and set(ti) == set(ji)
    assert (f"video_image_desc_{consistency}_loss" in tv) == bool(consistency)
    for k in jv:
        _close(tv[k], jv[k])
    for k in ji:
        _close(ti[k], ji[k])
    _close(tt, jt)


def _tiny_cfg(get):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.ZERO_DECAY_POS_CLS = True      # root names skip the decay
    cfg.MODEL.NUM_CLASSES = 5
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.SOLVER.BASE_LR = 1e-2
    cfg.SOLVER.COSINE_END_LR = 1e-4
    cfg.SOLVER.WARMUP_EPOCHS = 1.0
    cfg.SOLVER.WARMUP_START_LR = 1e-3
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.SOLVER.WEIGHT_DECAY = 0.05
    return cfg


def test_adamw_steps_match_optax():
    model, _ = build_model(_tiny_cfg(get_cfg), device="cpu", train=True)
    params = jax.tree.map(jnp.asarray, torch_to_flax(
        {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    )["params"])
    tx, _ = jax_optimizer(_tiny_cfg(jax_get_cfg), steps_per_epoch=2)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s: (
        jax.tree.map(lambda a, b: a + b, p, u), s))(*tx.update(g, s, p)))
    state = steps.create_train_state(
        model, construct_optimizer(_tiny_cfg(get_cfg), model, 2)[0])
    named = dict(model.named_parameters())
    rs = np.random.RandomState(6)
    for i, scale in enumerate((1.0, 1e-3, 0.5)):     # clipped, not, clipped
        grads = jax.tree.map(
            lambda p: jnp.asarray(scale * rs.randn(*p.shape), jnp.float32),
            params)
        for k, g in params_from_jax(jax.device_get(grads)).items():
            named[k].grad = g.clone()
        norm = state.tx.apply(list(named.values()), state.step)
        state.step += 1
        params, opt_state = update(grads, opt_state, params)
        jnorm = float(jnp.sqrt(sum(jnp.sum(g * g)
                                   for g in jax.tree.leaves(grads))))
        assert (jnorm >= 1.0) == (scale > 0.1)
        np.testing.assert_allclose(float(norm), jnorm, rtol=1e-5)
        want = params_from_jax(jax.device_get(params))
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=k)
    adam = opt_state[1][0]
    mu, nu = (params_from_jax(jax.device_get(m)) for m in (adam.mu, adam.nu))
    opt = state.tx.optimizer
    for k, p in named.items():
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                                   mu[k].numpy(), atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(),
                                   nu[k].numpy(), atol=1e-9, rtol=1e-5)
    # the decay groups: 1-D params and biases none; root skip names none
    decayed = {id(p) for g in opt.param_groups if g["weight_decay"] > 0
               for p in g["params"]}
    assert id(named["blocks.0.attn.qkv.weight"]) in decayed
    assert id(named["blocks.0.attn.rel_pos_h"]) in decayed
    for k in ("blocks.0.attn.qkv.bias", "norm.weight", "cls_token",
              "object_queries", "pos_embed_temporal"):
        assert id(named[k]) not in decayed, k
