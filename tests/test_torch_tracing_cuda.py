"""The device owners of ``svit_tpu_torch/utils/tracing.py`` on the card:
the marks survive capture.

These need an NVIDIA card and ``nvcc``; without a card they skip.  Run them
there with ``python -m pytest --noconftest tests/test_torch_tracing_cuda.py``.
A small SViT of ``configs/ssv2.yaml``'s widths (as
``tests/test_torch_graphs_cuda.py``: 2 blocks at 56 px and 4 frames, bf16
through the kernels) captured as the train step and the test step.  Held,
for each graph's last replay: the owners' intervals sum to the span from
the first mark to the last, every interval has a label, the stamps rise,
and the span covers at least nine tenths of the replay's device time as
events on the stream measure it, and no more than all of it; the tables
come most recent replay first.
"""

import pytest
import torch

from test_torch_graphs_cuda import _batch, _cfg, _setup

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _replay_timed(call):
    """The device ms of ``call``'s work: it queues behind a sleeping
    kernel, so the window holds no wait for the host's launch."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    t0.record()
    call()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def _check(table, replay_ms, fewest):
    assert table["marks"] >= fewest
    assert sum(table["ms"].values()) == pytest.approx(table["total_ms"],
                                                      rel=1e-9)
    assert min(table["ms"].values()) >= 0
    assert 0.9 * replay_ms <= table["total_ms"] <= replay_ms


def test_marks_survive_capture(card):
    from svit_tpu_torch.engine import graphs, steps
    from svit_tpu_torch.utils import tracing

    cfg = _cfg()
    state, step, _ = _setup(cfg)
    video, image = _batch(cfg, 0)
    cstep = graphs.CapturedTrainStep(step)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cstep(state, video, image, gen)          # the capture and a replay
    ms = _replay_timed(lambda: cstep(state, video, image, gen))
    train = tracing.last_table("train")
    assert train["replays"] == 2
    _check(train, ms, 40)   # the backward's sub owners among them
    assert {"video/blocks.0/attn", "video/blocks.0/attn/core"
            + tracing.BACKWARD, "backward", "optimizer"} <= set(train["ms"])
    test = graphs.CapturedStep(steps.make_test_step(state.model))
    test({"clips": video["clips"]})
    ms = _replay_timed(lambda: test({"clips": video["clips"]}))
    table = tracing.last_table("test")
    _check(table, ms, 8)    # the stem, two blocks' attn and mlp, the head
    assert {"forward/blocks.1/attn", "forward/head"} <= set(table["ms"])
    # a later replay of the train step makes it the latest table again
    cstep(state, video, image, gen)
    assert [t["kind"] for t in tracing.owner_tables()][:2] == ["train",
                                                               "test"]
    assert tracing.last_table("train")["replays"] == 3
