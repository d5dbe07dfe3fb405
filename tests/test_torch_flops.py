"""The port's analytic FLOP model (``svit_tpu_torch/utils/flops.py``)
against the JAX package's (``svit_tpu/utils/flops.py``) on
``configs/ssv2.yaml``'s architecture and two of its options, exactly (the
same integer arithmetic in Python floats), and ``log_model_info``'s
FLOPs."""

import os

import pytest

from svit_tpu.config import get_cfg as jax_get_cfg
from svit_tpu.models.svit import SViTArch as JaxArch
from svit_tpu.utils import flops as jax_flops
from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.models.svit import SViTArch
from svit_tpu_torch.utils import flops, misc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _archs(**kw):
    out = []
    for get, arch in ((get_cfg, SViTArch), (jax_get_cfg, JaxArch)):
        cfg = get()
        cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
        for k, v in kw.items():
            node, leaf = cfg, k.split(".")
            for p in leaf[:-1]:
                node = node[p]
            node[leaf[-1]] = v
        out.append(arch.from_cfg(cfg))
    return out


@pytest.mark.parametrize("kw", [{}, {"MVIT.DIM_MUL_IN_ATT": False},
                                {"MVIT.CLS_EMBED_ON": False}])
def test_flops_match_jax(kw):
    ours, ref = _archs(**kw)
    for batch, t_in in ((1, 16), (8, 16), (8, 1)):
        assert flops.forward_flops(ours, batch, t_in) == \
            jax_flops.forward_flops(ref, batch, t_in)
    for image, cons in ((8, True), (0, False)):
        assert flops.train_step_flops(ours, 8, image,
                                      with_consistency=cons) == \
            jax_flops.train_step_flops(ref, 8, image, with_consistency=cons)
    assert flops.out_shape((8, 56, 56), (3, 3, 3), (1, 8, 8)) == (8, 7, 7)


def test_log_model_info_logs_the_forward_flops():
    """On a stand-in module holding the ssv2.yaml architecture: the
    parameter count and one 16-frame clip's forward FLOPs (137.0 G)."""
    import torch

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    model = torch.nn.Linear(3, 2)
    model.arch = SViTArch.from_cfg(cfg)
    n, f = misc.log_model_info(model, cfg)
    assert n == 8
    assert f == flops.forward_flops(model.arch, 1, 16)
    assert round(f / 1e9, 1) == 137.0
