"""The port's whole model against the JAX package on the same weights.

- The full 16-block schedule at the reduced size of ``tests/conftest.py``
  (56 px, 4 frames, f32), video (T=4) and image (T=1), against JAX
  ``use_pallas=False``.  The weights are drawn by the port, turned into the
  JAX parameter tree by the JAX package's own ``torch_to_flax``, and carried
  back into a fresh port model by ``params_from_jax`` +
  ``load_state_dict(strict=True)``.  Tolerance 5e-5: f32 on both sides, the
  port's fused structure against XLA's unfused one, 16 blocks deep.
- The tiny model of ``tests/test_pallas_attention.py`` initialised by JAX,
  against JAX ``use_pallas=True`` (Pallas interpret mode) at atol 5e-4, the
  bound that test holds the JAX kernels to.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.models import build_model as jax_build
from svit_tpu.utils.converter import torch_to_flax
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models import build_model
from svit_tpu_torch.utils.converter import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("raw_logits", "obj_desc", "pred_bboxes", "pred_contact_state")


def _reduced(get):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.NUM_GPUS = 0
    cfg.TRAIN.MIXED_PRECISION = False
    return cfg


@pytest.fixture(scope="module")
def reduced_pair():
    source, _ = build_model(_reduced(get_cfg), device="cpu")
    params = torch_to_flax({k: v.numpy() for k, v in source.state_dict().items()})
    jm, _ = jax_build(_reduced(jax_get_cfg), use_pallas=False)
    cfg = _reduced(get_cfg)
    cfg.RNG_SEED = 123     # different random weights, replaced by the load
    port, _ = build_model(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    apply = jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))
    return port, params, apply


def _compare(port_out, jax_out, atol):
    (lt, et), (lj, ej) = port_out, jax_out
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=atol)
    for k in KEYS:
        assert tuple(et[k].shape) == tuple(ej[k].shape), k
        np.testing.assert_allclose(et[k].numpy(), np.asarray(ej[k]), atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("frames", [4, 1])
def test_reduced_model_matches_jax(reduced_pair, frames):
    port, params, apply = reduced_pair
    x = np.random.RandomState(frames).randn(2, frames, 56, 56, 3).astype(np.float32)
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    _compare(out, apply(params, jnp.asarray(x)), atol=5e-5)


def test_params_from_jax_round_trips_the_state_dict(reduced_pair):
    port, params, _ = reduced_pair
    state = params_from_jax(params)
    assert set(state) == set(port.state_dict())
    for k, v in port.state_dict().items():
        torch.testing.assert_close(state[k], v, atol=0, rtol=0)


def _tiny_cfg(get):
    cfg = get()
    cfg.MODEL.MODEL_NAME = "SViT"
    cfg.MODEL.NUM_CLASSES = 5
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
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
    return cfg


def _flat_outputs(out):
    logits, extra = out
    leaves = {"logits": logits, **extra}
    flat = {}
    for k, v in leaves.items():
        for sub, t in (v.items() if isinstance(v, dict) else [("", v)]):
            flat[f"{k}.{sub}"] = np.asarray(t)
    return flat


@pytest.mark.parametrize("variant", ["no_cls", "multitask"])
def test_tiny_model_variants_match_jax(variant):
    """The model paths ssv2.yaml does not take: no cls token (mean-pooled
    grid feeds the head) and the verb/noun multitask head, against JAX
    ``use_pallas=False`` in f32 (tolerance 5e-5, as the reduced model)."""
    def cfg_of(get):
        cfg = _tiny_cfg(get)
        if variant == "no_cls":
            cfg.MVIT.CLS_EMBED_ON = False
        else:
            cfg.TRAIN.DATASET = "epickitchens"
        return cfg

    jm, _ = jax_build(cfg_of(jax_get_cfg), use_pallas=False)
    x = np.random.RandomState(1).randn(2, 4, 32, 32, 3).astype(np.float32)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(1)},
                                     jnp.asarray(x), deterministic=True))()
    port, _ = build_model(cfg_of(get_cfg), device="cpu")
    port.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    with torch.inference_mode():
        got = _flat_outputs(port(torch.from_numpy(x)))
    want = _flat_outputs(jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))(
        params, jnp.asarray(x)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-5, err_msg=k)


def test_tiny_model_matches_jax_pallas_interpret():
    jm, _ = jax_build(_tiny_cfg(jax_get_cfg), use_pallas=True)
    x = np.random.RandomState(0).randn(1, 4, 32, 32, 3).astype(np.float32)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                     jnp.asarray(x), deterministic=True))()
    port, _ = build_model(_tiny_cfg(get_cfg), device="cpu")
    port.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    apply = jax.jit(lambda p, x: jm.apply(p, x, deterministic=True))
    _compare(out, apply(params, jnp.asarray(x)), atol=5e-4)
