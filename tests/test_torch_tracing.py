"""The port's tracing (``svit_tpu_torch/utils/tracing.py``) on the CPU.

- With no profiler nothing is recorded and no range is entered: the loop's
  spans and the model's owners are the null scope, and an eager step
  applies no marker.
- Under a CPU ``torch.profiler``, ``train_epoch`` records its documented
  spans, which tile each iteration: none encloses another iteration's
  dispatch.
- The owner labels of a tiny model's train step and test step, captured
  through ``engine/graphs.py`` with the stand-in graph: every owner is
  there, forward and backward (the attention's sub owners in the backward
  only), and the marks nest (each one enters or leaves one owner), with
  ``TPU.REMAT`` off and on (where each block's recompute is one owner
  inside its backward).
- The markers leave the train step's loss, metrics, first gradient and
  parameters bit-equal to the same step without them.
- The benchmark's four readers of the program's spans, on a fake record.
"""

import types

import pytest
import torch

from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.engine import graphs, meters, steps, train
from svit_tpu_torch.tools.common import load_cfg, train_batches, train_state
from svit_tpu_torch.utils import tracing
from tests.test_torch_graphs import EagerGraph

TINY = ["DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
        "DATA.NUM_FRAMES", "2", "MVIT.DEPTH", "2",
        "MVIT.DIM_MUL", "[[1, 2.0]]", "MVIT.HEAD_MUL", "[[1, 2.0]]",
        "MVIT.POOL_Q_STRIDE", "[[0, 1, 1, 1], [1, 1, 2, 2]]",
        "TRAIN.MIXED_PRECISION", "False"]
ATTN = ("pool_q", "pool_kv", "bias", "core", "proj")
LOOP = ("train.start", "train.fetch", "train.dispatch", "train.clone",
        "train.wait", "train.meter")


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset_host_spans()
    yield
    tracing.reset_host_spans()


def _stand_in_trainer(steps_n):
    """The loop's trainer interface around a step that only counts."""
    class Loader:
        def __len__(self):
            return steps_n

        def iter_batches(self, start=0):
            for _ in range(start, steps_n):
                yield {"clips": torch.zeros(2, 1), "labels": torch.zeros(2),
                       "weight": torch.ones(2)}

    def step_fn(state, vb, image_batch, gen):
        state.step += 1
        return state, torch.tensor([1.0])

    return types.SimpleNamespace(
        image_loader=None, train_loader=Loader(),
        put_ahead=lambda *b: (b, None), wait_for=lambda b, ready: None,
        generator=torch.Generator(), step_fn=step_fn,
        steps_per_epoch=steps_n, metric_names=["loss"])


def _epoch(steps_n=4):
    cfg = get_cfg()
    cfg.LOG_PERIOD = 2
    train.train_epoch(cfg, _stand_in_trainer(steps_n),
                      types.SimpleNamespace(step=0),
                      meters.TrainMeter(steps_n, cfg), 0)


def test_with_no_profiler_nothing_is_recorded(monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "_FastRange",
                        lambda name: entered.append(name))
    assert tracing.span("train.fetch") is tracing._NULL
    assert tracing.owner("attn") is tracing._NULL
    _epoch()
    torch.manual_seed(0)
    model, _, state, step = train_state(load_cfg(opts=TINY), "cpu")
    x = torch.randn(2, 2, 32, 32, 3, requires_grad=True)
    logits, _ = model(x, train=False)
    nodes, todo = set(), [logits.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in nodes:
            nodes.add(fn)
            todo += [n for n, _ in fn.next_functions]
    assert not [n for n in nodes if "Arrive" in type(n).__name__
                or "Leave" in type(n).__name__]
    assert entered == [] and tracing.host_spans() == {}
    assert tracing._STACK == []


def test_train_epoch_spans_tile_each_iteration():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _epoch(4)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("train.")]
    names = {n for n, _, _ in spans}
    assert names == set(LOOP)
    count = {n: c for n, (c, _) in tracing.host_spans().items()}
    assert count["train.start"] == 1 and count["train.fetch"] == 5
    assert count["train.dispatch"] == count["train.clone"] == 4
    assert count["train.wait"] == 2          # one flush a LOG_PERIOD of 2
    assert count == {n: sum(1 for m, _, _ in spans if m == n) for n in names}
    dispatches = [(lo, hi) for n, lo, hi in spans if n == "train.dispatch"]
    for name, lo, hi in spans:
        inside = [d for d in dispatches if lo <= d[0] and d[1] <= hi]
        assert len(inside) <= (name == "train.dispatch"), (name, lo, hi)


def _captured(remat: bool):
    """The tiny joint train step captured with the stand-in graph, its
    metrics, first gradient and parameters; the same for the plain step;
    and the captured test step."""
    opts = TINY + ["TPU.REMAT", str(remat)]
    out = {}
    for kind in ("captured", "plain"):
        torch.manual_seed(0)
        cfg = load_cfg(opts=opts)
        model, _, state, step = train_state(cfg, "cpu")
        video, image = train_batches(cfg, 2, 2, "cpu")
        gen = torch.Generator().manual_seed(1)
        if kind == "captured":
            cstep = graphs.CapturedTrainStep(step, graph_factory=EagerGraph)
            _, metrics = cstep(state, video, image, gen)
            (entry,) = cstep.entries.values()
            out["train_labels"] = tracing.labels(entry.graph)
            test = graphs.CapturedStep(steps.make_test_step(model),
                                       graph_factory=EagerGraph)
            test({"clips": video["clips"]})
            (entry,) = test.entries.values()
            out["test_labels"] = tracing.labels(entry.graph)
            out["test_kind"] = test.kind
        else:
            _, metrics = step(state, video, image, gen)
        opt = state.tx.optimizer.state
        out[kind] = ({k: v.clone() for k, v in metrics.items()},
                     {n: opt[p]["exp_avg"].clone()
                      for n, p in model.named_parameters() if p in opt},
                     {n: p.detach().clone()
                      for n, p in model.named_parameters()})
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["", "remat"])
def captured(request):
    return request.param, _captured(request.param)


def _nested(labels, depths):
    """Each mark enters or leaves one owner: the labels form a tree walk
    from the root and back to it, and a last mark ends the step."""
    stack = []
    assert labels[0] == labels[-1] == tracing.ROOT
    assert depths[0] == depths[-1] == 0
    for label, d in zip(labels[1:-1], depths[1:-1]):
        if d == len(stack) + 1:
            stack.append(label)
        else:
            assert d == len(stack) - 1, (label, d, stack)
            stack.pop()
            assert label == (stack[-1] if stack else tracing.ROOT), label
    assert not stack


def test_owner_labels_are_complete_and_nested(captured):
    remat, out = captured
    labels, depths = out["train_labels"]
    _nested(labels, depths)
    have = set(labels)
    B = tracing.BACKWARD
    for phase in ("consistency", "video", "image"):
        for i in range(2):
            blk = f"{phase}/blocks.{i}"
            assert {blk, f"{blk}/attn", f"{blk}/mlp"} <= have
            # the attention's sub owners mark their backward only
            assert not {f"{blk}/attn/{own}" for own in ATTN} & have
        assert {f"{phase}/stem", f"{phase}/head"} <= have
    for phase in ("video", "image"):
        for i in range(2):
            blk = f"{phase}/blocks.{i}"
            assert {f"{blk}{B}", f"{blk}/attn{B}", f"{blk}/mlp{B}"} <= have
            assert {f"{blk}/attn/{own}{B}" for own in ATTN
                    if own != "bias"} <= have
            assert (f"{blk}{tracing.RECOMPUTE}" in have) == remat
        # the last block's grid output feeds nothing (the head reads the
        # cls and object tokens), so its grid queries' bias takes no
        # backward: the markers keep a dead branch out, as without them
        assert f"{phase}/blocks.0/attn/bias{B}" in have
        assert f"{phase}/blocks.1/attn/bias{B}" not in have
        assert {f"{phase}/stem{B}", f"{phase}/head{B}"} <= have
        # the no-grad consistency forward has no backward
        assert not [x for x in have if x.startswith("consistency/")
                    and x.endswith(B)]
    assert {"video_losses", "image_losses", "backward",
            "optimizer"} <= have
    labels, depths = out["test_labels"]
    _nested(labels, depths)
    assert out["test_kind"] == "test"
    assert {f"forward/blocks.{i}/{own}" for i in range(2)
            for own in ("attn", "mlp")} <= set(labels)
    assert {"forward/stem", "forward/head"} <= set(labels)
    assert not [x for x in labels if x.endswith(B) or "/attn/" in x]


def test_markers_leave_the_step_bit_equal(captured):
    _, out = captured
    for a, b in zip(out["captured"], out["plain"]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _reader(name):
    from port_bench.core import cells

    return cells.reader(name)


def test_the_readers_on_a_fake_record(monkeypatch):
    B = tracing.BACKWARD
    tables = [
        {"kind": "test", "order": 9, "ms": {
            "forward/blocks.0/attn": 1.0, "forward/blocks.0/attn/core": 2.0,
            "forward/blocks.0/mlp": 4.0, "step": 0.5}},
        {"kind": "train", "order": 7, "ms": {
            "consistency/blocks.0/attn/bias": 1.0,
            "consistency/blocks.0/mlp": 2.0,
            "video/blocks.0/attn": 4.0,
            "video/blocks.0/attn/proj" + B: 8.0,
            "video/blocks.0 (recompute)": 16.0,
            "backward": 32.0}},
        {"kind": "train", "order": 3, "ms": {"video/blocks.0/attn": 64.0}}]
    monkeypatch.setattr(tracing, "owner_tables", lambda device=None: tables)
    monkeypatch.setattr(tracing, "host_spans", lambda: {
        "train.fetch": (4, 4e6), "train.dispatch": (4, 8e6),
        "train.clone": (4, 1e6), "train.meter": (8, 3e6),
        "train.wait": (2, 100e6), "graph.launch": (4, 5e6)})
    train_ctx = {"kind": "train", "summary": {"units": 4}}
    test_ctx = {"kind": "test", "summary": {"units": 16}}
    assert _reader("attention_ms.train")(train_ctx) == 1.0 + 4.0 + 8.0
    assert _reader("consistency_ms.train")(train_ctx) == 3.0
    assert _reader("attention_ms.test")(test_ctx) == 3.0
    # the loop's spans less the launch that the dispatch waits in
    assert _reader("loop_host_ms.train")(train_ctx) == pytest.approx(2.75)
    for name in ("attention_ms.train", "consistency_ms.train",
                 "loop_host_ms.train"):
        assert _reader(name)(test_ctx) is None
    assert _reader("attention_ms.test")(train_ctx) is None
    monkeypatch.setattr(tracing, "owner_tables", lambda device=None: [])
    monkeypatch.setattr(tracing, "host_spans", lambda: {})
    for name, ctx in (("attention_ms.train", train_ctx),
                      ("consistency_ms.train", train_ctx),
                      ("attention_ms.test", test_ctx),
                      ("loop_host_ms.train", train_ctx)):
        assert _reader(name)(ctx) is None
