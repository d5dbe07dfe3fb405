"""The train step's ``StepCache`` (``svit_tpu_torch/models/common.py``):
the weights cast to bf16 once a step and the pool filters, their LN
parameters and the object-token multipliers derived once, shared by the
step's forwards, against the per-use form (``cache=None``), on the CPU
through the plain versions at 56 px, 4 frames, 2 blocks, bf16.  A no-grad
forward first, as the step's consistency forward, then two with grad.

Held: the loss bit for bit; the gradient of every parameter that is only
cast bit for bit (each use's cotangent reaches the f32 master on its own,
as the per-use cast sends it); the pool filters' and LN parameters'
gradients within 1e-5 relative (their uses' cotangents are summed in f32
before the shared tiling and the multiplier's convolution, not after);
and the casts and convolutions the forwards run: once a step, not once a
forward.
"""

import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models import build_model
from svit_tpu_torch.models.common import StepCache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DERIVED = ("attn.pool_", "attn.norm_")   # tiled over heads, shared


class _Ops(TorchDispatchMode):
    """Counts the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.count = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.count[name] = self.count.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _model():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MODEL.NUM_CLASSES = 10
    model, _ = build_model(cfg, dtype=torch.bfloat16, train=True,
                           device="cpu")
    return model


def _run(model, cache, counter=None):
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn((2, 4, 56, 56, 3), generator=torch.Generator()
                      .manual_seed(i)) for i in range(3)]
    mode = counter if counter is not None else _Ops()
    with mode:
        with torch.no_grad():
            model(xs[0], train=True, generator=gen, cache=cache)
        outs = [model(x, train=True, generator=gen, cache=cache)
                for x in xs[1:]]
    loss = sum(o[0].float().square().mean() + o[1]["obj_desc"].float()
               .square().mean() for o in outs)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None}


def test_the_step_cache_equals_the_per_use_form():
    model = _model()
    per_use, cached = _Ops(), _Ops()
    la, ga = _run(model, None, per_use)
    lb, gb = _run(model, StepCache(), cached)
    assert torch.equal(la, lb)
    assert ga.keys() == gb.keys() and len(ga) > 50
    for n, g in ga.items():
        if any(k in n for k in DERIVED):
            err = float((gb[n] - g).norm() / g.norm().clamp_min(1e-30))
            assert err <= 1e-5, (n, err)
        else:
            assert torch.equal(gb[n], g), n
    # three forwards: the per-use form casts and tiles in each, the cache
    # once; the multiplier's convolution once per pool, not per forward
    for op in ("_to_copy", "convolution", "repeat", "cat"):
        assert cached.count[op] < per_use.count[op], op
    # two forwards fewer of the 4 pools' multipliers (q and k|v, 2 blocks)
    assert per_use.count["convolution"] - cached.count["convolution"] == \
        2 * 4
