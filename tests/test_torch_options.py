"""The model and optimizer options of the shared defaults that the port
runs, each against the JAX package on CPU.

- Model options (``MVIT.MODE`` max and avg, ``MVIT.SEPARATE_QKV``, blocks
  without q or without k|v pooling, ``MVIT.DIM_MUL_IN_ATT=False``,
  ``MVIT.NORM_STEM``): a two-block model at the reduced size of
  ``tests/conftest.py`` (56 px, 4 frames, f32) initialised by JAX, carried
  into the port by ``params_from_jax`` + ``load_state_dict(strict=True)``,
  logits and every head output against JAX ``use_pallas=False`` at atol
  5e-5 (``tests/test_torch_model.py``).
- Optimizer options (``SOLVER.OPTIMIZING_METHOD`` sgd and adam,
  ``SOLVER.CLIP_GRAD_VAL``): the parameters after three steps fed the same
  gradients against the optax chain of ``construct_optimizer``, rtol 1e-5
  and atol 1e-6 (three updates of size ~lr, ``tests/test_torch_losses.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.models import build_model as jax_build
from svit_tpu.models.optimizer import construct_optimizer as jax_optimizer
from svit_tpu.utils.converter import torch_to_flax
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.engine import steps
from svit_tpu_torch.models import build_model
from svit_tpu_torch.models.optimizer import construct_optimizer
from svit_tpu_torch.utils.converter import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model_cfg(get, option):
    cfg = get()
    cfg.MODEL.MODEL_NAME = "SViT"
    cfg.MODEL.NUM_CLASSES = 5
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.EMBED_DIM = 32
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 2, 2]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.REL_POS_SPATIAL = True
    cfg.MVIT.REL_POS_TEMPORAL = True
    cfg.MVIT.USE_ABS_POS = False
    cfg.MVIT.DROPPATH_RATE = 0.0
    cfg.TRAIN.MIXED_PRECISION = False
    if option in ("max", "avg"):
        cfg.MVIT.MODE = option
    elif option == "separate_qkv":
        cfg.MVIT.SEPARATE_QKV = True
    elif option == "no_q_pool":
        cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2]]      # block 0: no q pool
    elif option == "no_kv_pool":
        cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = None      # block 0: no k|v pool
        cfg.MVIT.POOL_KV_STRIDE = [[1, 1, 2, 2]]
    elif option == "dim_mul_in_att_false":
        cfg.MVIT.DIM_MUL_IN_ATT = False
    elif option == "norm_stem":
        cfg.MVIT.NORM_STEM = True
    else:
        raise ValueError(option)
    return cfg


def _flat(out):
    logits, extra = out
    flat = {"logits": np.asarray(logits)}
    for k, v in extra.items():
        for sub, t in (v.items() if isinstance(v, dict) else [("", v)]):
            flat[f"{k}.{sub}"] = np.asarray(t)
    return flat


MODEL_OPTIONS = ["max", "avg", "separate_qkv", "no_q_pool", "no_kv_pool",
                 "dim_mul_in_att_false", "norm_stem"]


@pytest.mark.parametrize("option", MODEL_OPTIONS)
def test_model_option_matches_jax(option):
    jm, _ = jax_build(_model_cfg(jax_get_cfg, option), use_pallas=False)
    x = np.random.RandomState(2).randn(2, 4, 56, 56, 3).astype(np.float32)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(2)},
                                     jnp.asarray(x), deterministic=True))()
    port, arch = build_model(_model_cfg(get_cfg, option), device="cpu")
    port.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    with torch.inference_mode():
        got = _flat(port(torch.from_numpy(x)))
    want = _flat(jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))(
        params, jnp.asarray(x)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-5, err_msg=k)
    # the option really shaped the model
    blocks = port.blocks
    if option in ("max", "avg"):
        assert not hasattr(blocks[0].attn, "pool_q")
    elif option == "separate_qkv":
        assert hasattr(blocks[0].attn, "q") and not hasattr(blocks[0].attn,
                                                            "qkv")
    elif option == "no_q_pool":
        assert not blocks[0].attn.pool_q_on and blocks[1].attn.pool_q_on
    elif option == "no_kv_pool":
        assert not blocks[0].attn.pool_kv_on and blocks[1].attn.pool_kv_on
    elif option == "dim_mul_in_att_false":
        assert blocks[0].attn.dim_out == 32 and blocks[0].dim_out == 64
    else:
        assert hasattr(port, "norm_stem")


def _opt_cfg(get, option):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.ZERO_DECAY_POS_CLS = True
    cfg.MODEL.NUM_CLASSES = 5
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.SOLVER.BASE_LR = 1e-2
    cfg.SOLVER.COSINE_END_LR = 1e-4
    cfg.SOLVER.WARMUP_EPOCHS = 1.0
    cfg.SOLVER.WARMUP_START_LR = 1e-3
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.SOLVER.WEIGHT_DECAY = 0.05
    cfg.SOLVER.CLIP_GRAD_L2NORM = None
    if option in ("sgd", "adam"):
        cfg.SOLVER.OPTIMIZING_METHOD = option
        cfg.SOLVER.MOMENTUM = 0.9
        cfg.SOLVER.NESTEROV = True
    elif option == "clip_grad_val":
        cfg.SOLVER.OPTIMIZING_METHOD = "adamw"
        cfg.SOLVER.CLIP_GRAD_VAL = 0.5
    else:
        raise ValueError(option)
    return cfg


@pytest.mark.parametrize("option", ["sgd", "adam", "clip_grad_val"])
def test_optimizer_option_matches_optax(option):
    model, _ = build_model(_opt_cfg(get_cfg, option), device="cpu",
                           train=True)
    params = jax.tree.map(jnp.asarray, torch_to_flax(
        {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    )["params"])
    tx, _ = jax_optimizer(_opt_cfg(jax_get_cfg, option), steps_per_epoch=2)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s: (
        jax.tree.map(lambda a, b: a + b, p, u), s))(*tx.update(g, s, p)))
    state = steps.create_train_state(
        model, construct_optimizer(_opt_cfg(get_cfg, option), model, 2)[0])
    named = dict(model.named_parameters())
    rs = np.random.RandomState(7)
    for scale in (1.0, 1e-3, 0.5):      # clipped elements on two steps
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
        np.testing.assert_allclose(float(norm), jnorm, rtol=1e-5)
        want = params_from_jax(jax.device_get(params))
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=k)
