"""The port's Grad-CAM against the JAX package's, and the backward it runs.

At the reduced size of ``tests/conftest.py`` (56 px, 4 frames, f32) the
port's model takes the JAX parameters through ``params_from_jax``.  The
reference is the JAX package's own formulation (``svit_tpu/visualization/
gradcam.py``): the gradient of the summed top score with respect to the
``capture_gradcam`` perturbations (``jax.value_and_grad``), the block
outputs found by ``_find_intermediate``, the weights-times-activations map
and ``_resize_cam``.  ``GradCAM.localization_map`` itself reshapes every
layer's map to the grid of its ``_final_thw``, which raises at 56 px, so
the test keeps the map on the layer's own grid, as the port does.

Tolerances: logits atol 5e-5 (as ``test_torch_model.py``); the target
layer's activations and gradients atol 1e-4 x their largest magnitude;
the pre-ReLU map atol 1e-4 x its largest magnitude; the normalized maps
atol 1e-3.  At the default layer (the last block's output) both gradients
are exactly zero and the port's map is all zero.

Without a card the kernel wrappers take their plain versions, so the
backward's kernel calls are counted at the wrappers: a Grad-CAM call makes
``chip_smoke.expected_gradcam_launches`` of them and no K7 call.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.models import SViT as JaxSViT
from svit_tpu.models import build_model as jax_build
from svit_tpu.utils.converter import torch_to_flax
from svit_tpu.visualization import gradcam as jax_gradcam
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models import build_model
from svit_tpu_torch.ops import attention as attn_ops
from svit_tpu_torch.ops import ln_linear as ll
from svit_tpu_torch.ops import pool
from svit_tpu_torch.utils.converter import params_from_jax
from svit_tpu_torch.visualization import gradcam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = ("blocks_0_out", "blocks_7_out")


def _reduced(get):
    cfg = get()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.NUM_GPUS = 0
    cfg.TRAIN.MIXED_PRECISION = False
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch on one thread here: beside JAX's thread pool in the same
    process and the suite's other workers, torch's eight spinning threads
    slow this file's small ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(port model, clips, the JAX logits, gradients by layer and block
    outputs by layer)."""
    source, _ = build_model(_reduced(get_cfg), device="cpu")
    params = torch_to_flax({k: v.numpy()
                            for k, v in source.state_dict().items()})
    cfg = _reduced(get_cfg)
    cfg.RNG_SEED = 123     # other random weights, replaced by the load
    port, _ = build_model(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)

    jm, arch = jax_build(_reduced(jax_get_cfg), use_pallas=False)
    cam_model = JaxSViT(arch=arch, dtype=jm.dtype, capture_gradcam=True)
    x = np.random.RandomState(0).randn(2, 4, 56, 56, 3).astype(np.float32)
    xj = jnp.asarray(x)
    shapes = jax.eval_shape(lambda: cam_model.init(
        {"params": jax.random.PRNGKey(0)}, xj, deterministic=True))
    zero = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        shapes["perturbations"])

    def score_fn(pert):
        """GradCAM.localization_map's score (labels None), with the block
        outputs captured in the same apply."""
        (logits, _), state = cam_model.apply(
            {"params": params["params"], "perturbations": pert}, xj,
            deterministic=True,
            capture_intermediates=lambda mdl, name: name == "__call__" and (
                mdl.name or "").startswith("blocks_"),
            mutable=["intermediates"])
        return logits.max(axis=-1).sum(), (logits, state["intermediates"])

    (_, (logits, inter)), grads = jax.jit(
        jax.value_and_grad(score_fn, has_aux=True))(zero)
    names = [f"blocks_{i}_out" for i in range(arch.depth)]
    acts = {n: np.asarray(jax_gradcam._find_intermediate(inter, n))
            for n in names}
    grads = {n: np.asarray(grads[n]) for n in names}
    return port, x, np.asarray(logits), grads, acts


def _jax_maps(act, grad, t, h, w):
    """JAX ``localization_map``'s arithmetic on the layer's own grid."""
    B = act.shape[0]
    weights = grad.reshape(B, -1, grad.shape[-1]).mean(axis=1, keepdims=True)
    cam = (weights * act.reshape(B, -1, act.shape[-1])).sum(axis=-1)
    cam = cam.reshape(B, *act.shape[1:4])
    maps = jax_gradcam._resize_cam(np.maximum(cam, 0), t, h, w)
    mn = maps.min(axis=(1, 2, 3), keepdims=True)
    mx = maps.max(axis=(1, 2, 3), keepdims=True)
    return cam, (maps - mn) / np.maximum(mx - mn, 1e-8)


def _close(got, want, scale, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=scale, err_msg=what)


@pytest.mark.parametrize("layer", LAYERS)
def test_gradcam_matches_jax(pair, layer):
    port, x, logits, grads, acts = pair
    cam = gradcam.GradCAM(port, target_layer=layer)
    out = cam.layer_cam(torch.from_numpy(x))
    _close(out["logits"].numpy(), logits, 5e-5, "logits")
    act, grad = acts[layer], grads[layer]
    assert tuple(out["act"].shape) == act.shape
    assert np.abs(grad).max() > 0
    _close(out["act"].numpy(), act, 1e-4 * np.abs(act).max(), "act")
    _close(out["grad"].numpy(), grad, 1e-4 * np.abs(grad).max(), "grad")
    cam_j, maps_j = _jax_maps(act, grad, 4, 56, 56)
    _close(out["cam"].numpy(), cam_j, 1e-4 * np.abs(cam_j).max(), "cam")
    maps, preds = cam.localization_map(torch.from_numpy(x))
    assert maps.shape == (2, 4, 56, 56)
    assert maps.min() >= 0 and maps.max() <= 1 and maps.max() == 1
    _close(maps, maps_j, 1e-3, "maps")


def test_default_layer_gives_a_zero_map(pair):
    """With a cls token the last block's grid feeds nothing: the JAX
    gradient there is exactly zero, and so is the port's map."""
    port, x, _, grads, acts = pair
    last = f"blocks_{port.arch.depth - 1}_out"
    assert port.arch.cls_embed_on
    assert not np.any(grads[last])
    cam = gradcam.GradCAM(port)
    assert cam.target_layer == last
    out = cam.layer_cam(torch.from_numpy(x))
    assert not torch.any(out["grad"]) and not torch.any(out["cam"])
    maps, _ = cam.localization_map(torch.from_numpy(x))
    assert not np.any(maps)
    _, maps_j = _jax_maps(acts[last], grads[last], 4, 56, 56)
    assert not np.any(maps_j)


def test_overlay_is_uint8_video(pair):
    pytest.importorskip("matplotlib")
    port, x, _, _, _ = pair
    videos, preds = gradcam.GradCAM(port, target_layer="blocks_7_out")(
        torch.from_numpy(x))
    assert videos.shape == (2, 4, 56, 56, 3) and videos.dtype == np.uint8
    assert tuple(preds.shape) == (2, port.arch.num_classes)


def test_forward_without_capture_is_unchanged(pair):
    port, x, logits, _, _ = pair
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain, extra = port(xt)
        again, _ = port(xt, capture_gradcam=False)
        cap, extra_cap = port(xt, capture_gradcam=True)
    assert "perturbations" not in extra and "intermediates" not in extra
    assert torch.equal(plain, again) and torch.equal(plain, cap)
    _close(plain.numpy(), logits, 5e-5, "logits")
    assert sorted(extra_cap["perturbations"]) == sorted(
        extra_cap["intermediates"])
    assert all(not torch.any(p) for p in extra_cap["perturbations"].values())


def test_pool_ln_backward_computes_only_what_is_asked(monkeypatch):
    """``_PoolLnFn`` returns None for dk and the LN parameters when they
    want no gradient, without a K7 call, and the same dx."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, 96, generator=g)
    w = torch.randn(96, 1, 3, 3, 3, generator=g) * 0.2
    ln_w, ln_b = 1 + 0.1 * torch.randn(96, generator=g), torch.randn(96) * .1
    cot = torch.randn(2, 4, 4, 4, 96, generator=g)
    calls = collections.Counter()
    for name in ("depthwise_conv_dk", "depthwise_conv_dk_reference"):
        fn = getattr(pool, name)
        monkeypatch.setattr(pool, name, lambda *a, _f=fn, _n=name: (
            calls.update([_n]), _f(*a))[1])

    def grads(want_params):
        leaves = [x.clone().requires_grad_()] + [
            t.clone().requires_grad_(want_params) for t in (w, ln_w, ln_b)]
        out = pool._PoolLnFn.apply(*leaves, (1, 2, 2), 96)
        out.backward(cot)
        return [t.grad for t in leaves]

    full = grads(True)
    assert calls and all(t is not None for t in full)
    calls.clear()
    dx_only = grads(False)
    assert not calls
    assert dx_only[1:] == [None, None, None]
    assert torch.equal(dx_only[0], full[0])


def test_attention_proj_backward_skips_unwanted_products():
    g = torch.Generator().manual_seed(1)
    B, Nq, Nk, C, heads = 2, 10, 12, 32, 2
    q, kv = torch.randn(B, Nq, C, generator=g), torch.randn(B, Nk, 2 * C,
                                                             generator=g)
    wp, bp = torch.randn(C, C, generator=g) * 0.1, torch.zeros(C)
    cot = torch.randn(B, Nq, C, generator=g)

    def grads(want_w):
        leaves = [q.clone().requires_grad_(), kv.clone().requires_grad_(),
                  wp.clone().requires_grad_(want_w),
                  bp.clone().requires_grad_(want_w)]
        out = attn_ops._AttentionProjFn.apply(
            leaves[0], leaves[1], None, leaves[2], leaves[3], (1, 3, 4),
            C ** -0.5, heads, False)
        out.backward(cot)
        return [t.grad for t in leaves]

    full, inputs_only = grads(True), grads(False)
    assert full[2] is not None and full[3] is not None
    assert inputs_only[2:] == [None, None]
    assert torch.equal(inputs_only[0], full[0])
    assert torch.equal(inputs_only[1], full[1])


@pytest.mark.parametrize("target", [0, 15])
def test_gradcam_kernel_calls(monkeypatch, target):
    """One Grad-CAM call's calls of each kernel wrapper (on the CPU their
    plain versions run) equal ``expected_gradcam_launches``: no K7."""
    cfg = _reduced(get_cfg)
    model, arch = build_model(cfg, use_kernels=True, device="cpu")
    calls = collections.Counter()
    table = [(ll, "ln_linear", "ln_linear"),
             (pool, "fused_pool_ln", "pool_ln"),
             (pool, "fused_pool_max", "pool_max"),
             (pool, "pool_max_bwd", "pool_max_bwd"),
             (attn_ops, "pooled_attention_fwd", "pooled_attention"),
             (pool, "depthwise_conv", "pool_conv"),
             (pool, "depthwise_conv_dx", "pool_conv_dx"),
             (pool, "depthwise_conv_dk", "pool_conv_dk"),
             (pool, "depthwise_conv_dk_reference", "pool_conv_dk"),
             (attn_ops, "pooled_attention_bwd", "pooled_attention_bwd")]
    for mod, attr, name in table:
        fn = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, _f=fn, _n=name, **k: (
            calls.update([_n]), _f(*a, **k))[1])
    x = torch.from_numpy(np.random.RandomState(2).randn(
        1, 4, 56, 56, 3).astype(np.float32))
    gradcam.GradCAM(model, target_layer=f"blocks_{target}_out").layer_cam(x)
    want = chip_smoke.expected_gradcam_launches(arch, target)
    assert dict(calls) == dict(want)
    assert "pool_conv_dk" not in calls
