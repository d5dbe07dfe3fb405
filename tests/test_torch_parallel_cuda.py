"""The captured train step under a process group of one rank (NCCL) on the
card: its collectives (the gradient all-reduce, the loss denominators' and
the metrics' all-reduces) are issued while the CUDA graph is captured,
and the step equals the one with no group bit for bit.  At one rank NCCL
sums in place and adds no kernel node: the group's graph holds the
hand-written kernels of the other and the buckets' flatten and copy-back
besides.  A small SViT of
``configs/ssv2.yaml``'s widths, 2 blocks at 56 px and 4 frames, bf16
through the kernels.

These need an NVIDIA card and ``nvcc``; without a card they skip.  Run them
there with ``python -m pytest --noconftest tests/test_torch_parallel_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def group(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    yield dist
    dist.destroy_process_group()


def _cfg():
    from svit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "ssv2.yaml"))
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 56
    cfg.DATA.NUM_FRAMES = 4
    cfg.MVIT.DEPTH = 2
    cfg.MVIT.POOL_Q_STRIDE = [[0, 1, 1, 1], [1, 1, 2, 2]]
    cfg.MVIT.DIM_MUL = [[1, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0]]
    cfg.MODEL.NUM_CLASSES = 10
    cfg.SVIT.CONSISTENCY_LOSS = "l1"
    return cfg


def _batches(cfg):
    rs = np.random.RandomState(0)
    S, T, O = cfg.DATA.TRAIN_CROP_SIZE, cfg.DATA.NUM_FRAMES, cfg.SVIT.O
    video = {"clips": rs.randn(4, T, S, S, 3).astype(np.float32),
             "labels": rs.randint(0, 10, 4),
             "weight": np.ones(4, np.float32)}
    image = {"frames": rs.randn(4, 1, S, S, 3).astype(np.float32),
             "haog_bboxes": (rs.rand(4, 1, O, 4) * 0.5 + 0.1).astype(
                 np.float32),
             "contact_state": rs.randint(-1, 5, (4, 2)),
             "weight": np.ones(4, np.float32)}
    return ({k: torch.as_tensor(v).cuda() for k, v in video.items()},
            {k: torch.as_tensor(v).cuda() for k, v in image.items()})


def test_one_rank_nccl_captured_step_equals_no_group(group):
    import chip_smoke
    from svit_tpu_torch.engine import graphs, steps
    from svit_tpu_torch.models import build_model
    from svit_tpu_torch.models.losses import get_loss_func
    from svit_tpu_torch.models.optimizer import construct_optimizer
    from svit_tpu_torch.parallel import mesh as meshlib

    cfg = _cfg()
    video, image = _batches(cfg)
    mesh = meshlib.build_mesh(data=1, model=1)
    assert mesh.data_group is group.group.WORLD
    out, issued = [], []
    all_reduce = group.all_reduce

    def counted(*a, **k):
        issued[-1] += 1
        return all_reduce(*a, **k)

    group.all_reduce = counted
    for m in (None, mesh):
        issued.append(0)
        model, _ = build_model(cfg, dtype=torch.bfloat16, use_kernels=True,
                               train=True)
        tx, _ = construct_optimizer(cfg, model, steps_per_epoch=10)
        state = steps.create_train_state(model, tx)
        step = steps.make_train_step(
            model, get_loss_func(cfg), tx, video_weight=7 / 8,
            image_weight=1 / 8, with_image=True, with_consistency=True,
            mesh=m)
        cstep = graphs.CapturedTrainStep(
            step, graph_factory=chip_smoke.node_graph)
        gen = torch.Generator(device="cuda").manual_seed(0)
        _, metrics = cstep(state, video, image, gen)
        torch.cuda.synchronize()
        (entry,) = cstep.entries.values()
        out.append(({k: float(v) for k, v in metrics.items()},
                    chip_smoke.step_tensors(model),
                    chip_smoke.kernel_nodes(entry.graph),
                    chip_smoke.graph_census(entry.graph)))
    group.all_reduce = all_reduce
    (m1, t1, n1, c1), (m2, t2, n2, c2) = out
    assert m1 == m2
    for k in t1:
        assert torch.equal(t1[k], t2[k]), k
    assert n1 == n2
    assert issued[0] == 0 and issued[1] > 0
    assert c2["nodes"] > c1["nodes"]
