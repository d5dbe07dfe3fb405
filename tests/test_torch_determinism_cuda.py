"""The train step is deterministic on the card: at full size
(``configs/ssv2.yaml``, ``chip_smoke.py`` phase 7's batch of 8 videos and 8
images with the consistency forward, drop-path 0.4, head dropout 0.5,
kernels in bf16), two steps from one state, one batch and one generator
state give the same loss, metrics, gradients and parameters after AdamW
bit for bit, eager and as a CUDA graph.  The hand-written backward kernels
add in fixed orders (K3's ``pool_max_bwd`` too); no flag is set, neither
by the port nor here.

These need an NVIDIA card and ``nvcc``; without a card they skip.  Run them
there with ``python -m pytest --noconftest tests/test_torch_determinism_cuda.py``.
"""

import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    sys.path.insert(0, REPO)
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return chip_smoke


def _cfg():
    from svit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    return cfg


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "graph"])
def test_full_size_step_is_bit_identical(smoke, captured):
    from svit_tpu_torch.engine import graphs

    assert not torch.are_deterministic_algorithms_enabled()
    cfg = _cfg()
    video, image = smoke.train_batch(cfg, torch)
    state, step, _ = smoke.train_setup(cfg, torch, torch.bfloat16, True)
    run = graphs.CapturedTrainStep(step) if captured else step
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    start = graphs._Restore(state, gen)
    out = []
    for _ in range(2):
        _, m = run(state, video, image, gen)
        torch.cuda.synchronize()
        out.append(({k: float(v) for k, v in m.items()},
                    smoke.step_tensors(state.model)))
        start.restore()
        state.step = 0
    (m1, t1), (m2, t2) = out
    assert m1 == m2
    for k in t1:
        assert torch.equal(t1[k], t2[k]), k
    assert not torch.are_deterministic_algorithms_enabled()
