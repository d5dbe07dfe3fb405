"""The bookkeeping of ``svit_tpu_torch/engine/graphs.py`` on the CPU, with
a stand-in for the CUDA graph (``EagerGraph``): a capture runs the
function once and keeps it, a replay runs it again and writes its results
into the captured outputs, as a replay overwrites a graph's static
outputs.  Held: inputs go through static buffers, outputs are cloned where
a caller keeps them, a new input signature captures anew, the warm-up's
steps are undone (the captured step's first call equals the eager step,
bit for bit), each replay draws from the generator as seeded at the call,
the learning rate is read at the device step counter, launch counts are
taken at capture, and moved state is refused.  Also the tensor learning
rate of ``models/optimizer.py`` against torch's float one over three
steps for ``adamw``, ``adam`` and ``sgd`` (within 1e-6 relative: the
tensor rate is rounded to f32 before its products, and the capturable and
fused forms order them differently).
"""

import collections
import copy
import os

import numpy as np
import pytest
import torch

from svit_tpu_torch.config import get_cfg
from svit_tpu_torch.engine import graphs, steps
from svit_tpu_torch.models import optimizer as opt_lib
from svit_tpu_torch.ops import _lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class EagerGraph:
    """A CPU stand-in for ``graphs.CudaGraph``."""

    made = 0

    def __init__(self):
        EagerGraph.made += 1

    def capture(self, fn, generator=None):
        self.fn = fn
        self.outputs = fn()
        return self.outputs

    def replay(self):
        new = graphs.tensors(self.fn())
        with torch.inference_mode():   # the outputs of an inference step
            for dst, src in zip(graphs.tensors(self.outputs), new):
                dst.copy_(src)


# ---------------------------------------------------------------------------
# An inference step
# ---------------------------------------------------------------------------

def test_inputs_go_through_static_buffers_and_outputs_are_cloned():
    seen = []

    def fn(batch):
        seen.append(id(batch["x"]))
        return {"y": batch["x"] * 2, "s": batch["x"].sum()}

    step = graphs.CapturedStep(fn, graph_factory=EagerGraph)
    a, b = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    ya = step({"x": a})
    yb = step({"x": b})
    # the function only ever saw the static buffer, never a caller's
    assert len(set(seen)) == 1 and id(a) not in seen and id(b) not in seen
    assert torch.equal(ya["y"], a * 2) and torch.equal(yb["y"], b * 2)
    # the first result is a copy: the second replay left it alone
    assert not torch.equal(ya["y"], yb["y"])
    entry = step.entries[graphs.signature({"x": a})]
    assert entry.replays == 2 and ya["y"] is not entry.outputs["y"]


def test_a_new_signature_captures_a_new_graph():
    step = graphs.CapturedStep(lambda b: b["x"] + 1, graph_factory=EagerGraph)
    made = EagerGraph.made
    for shape in ((2, 3), (2, 3), (5, 3), (2, 3), (5, 3)):
        step({"x": torch.zeros(shape)})
    step({"x": torch.zeros(2, 3, dtype=torch.float64)})
    assert len(step.entries) == 3 and EagerGraph.made - made == 3
    assert sorted(e.replays for e in step.entries.values()) == [1, 2, 3]


def test_off_the_card_the_eager_step_runs():
    step = graphs.CapturedStep(lambda b: b["x"] + 1)
    assert torch.equal(step({"x": torch.zeros(2)}), torch.ones(2))
    assert not step.entries


@pytest.mark.parametrize("enabled", [True, False])
def test_no_collection_holds_the_collector_off(enabled):
    """A capture's guard: a cycle that dies inside is not collected there,
    however much is allocated, and the collector's earlier state comes
    back after."""
    import gc
    import weakref

    class Cycle:
        pass

    was, threshold = gc.isenabled(), gc.get_threshold()
    try:
        gc.enable() if enabled else gc.disable()
        gc.set_threshold(1)
        with graphs.no_collection():
            assert not gc.isenabled()
            dead = Cycle()
            dead.me = dead
            ref = weakref.ref(dead)
            del dead
            junk = [[] for _ in range(1000)]
            assert ref() is not None and len(junk) == 1000
        assert gc.isenabled() == enabled
        gc.collect()
        assert ref() is None
    finally:
        gc.set_threshold(*threshold)
        gc.enable() if was else gc.disable()


def test_launch_counts_are_taken_at_capture(monkeypatch):
    """A replay counts nothing on the host: the graph keeps the launches
    its capture made, beside its replays."""
    monkeypatch.setattr(_lib, "LAUNCHES", collections.Counter())

    def fn(batch):
        _lib.LAUNCHES["ln_linear"] += 3     # as three wrapper launches
        _lib.LAUNCHES["pool_ln"] += 1
        return batch["x"] * 2

    step = graphs.CapturedStep(fn, graph_factory=EagerGraph)
    step({"x": torch.ones(4)})
    entry = next(iter(step.entries.values()))
    assert entry.launches == {"ln_linear": 3, "pool_ln": 1}
    # the warm-up and the capture ran it eagerly (the stand-in's replay is
    # eager too, which the real graph's is not)
    assert _lib.LAUNCHES["ln_linear"] == 3 * (graphs.WARMUP + 2)
    for _ in range(4):
        step({"x": torch.ones(4)})
    assert entry.replays == 5 and entry.launches["ln_linear"] == 3


# ---------------------------------------------------------------------------
# A train step
# ---------------------------------------------------------------------------

def _state(method, lr_table=(0.1, 0.2, 0.3, 0.4, 0.5), seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.GELU(),
                                torch.nn.Linear(8, 3))
    cfg = get_cfg()
    cfg.SOLVER.OPTIMIZING_METHOD = method
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.WEIGHT_DECAY = 0.05
    tx, _ = opt_lib.construct_optimizer(cfg, model, steps_per_epoch=1)
    tx.lr_table = np.asarray(lr_table, np.float32)
    tx.lr_table_t = torch.as_tensor(tx.lr_table)
    return steps.create_train_state(model, tx)


def _step():
    """A train step as ``engine/steps.py`` builds one: the device part
    draws a dropout mask from the generator, backward, the transform; the
    packed metrics are the loss, the grad norm, the rate and a draw."""
    def device_step(state, vb, ib, generator):
        m = state.model
        params = [p for p in m.parameters()]
        for p in params:
            p.grad = None
        u = torch.rand(vb["x"].shape, generator=generator)
        out = m(vb["x"] * (u < 0.8).float() / 0.8)
        loss = ((out - vb["y"]) ** 2).mean()
        loss.backward()
        norm = state.tx.apply(params)
        return torch.stack([loss.detach(), norm, state.tx.lr.clone(),
                            u.sum()])

    def eager(state, vb, ib, generator):
        state.tx.set_step(state.step)
        out = device_step(state, vb, ib, generator)
        state.step += 1
        return state, out

    eager.device_step = device_step
    return eager


def _batch(i, rows=4):
    rs = np.random.RandomState(i)
    return {"x": torch.from_numpy(rs.randn(rows, 6).astype(np.float32)),
            "y": torch.from_numpy(rs.randn(rows, 3).astype(np.float32))}


@pytest.mark.parametrize("method", ["adamw", "adam", "sgd"])
def test_the_captured_step_equals_the_eager_step(method):
    """Three steps from the same start, batch and seeds: the captured
    step's metrics and parameters equal the eager step's bit for bit (the
    warm-up's steps are undone, the state its optimizer created takes the
    zeros the first step finds), and the graph's output is one tensor the
    next replay overwrites."""
    eager, captured = _state(method), _state(method)
    step = _step()
    cstep = graphs.CapturedTrainStep(step, graph_factory=EagerGraph)
    ge, gc = torch.Generator(), torch.Generator()
    outs = []
    for i in range(3):
        ge.manual_seed(100 + i)
        gc.manual_seed(100 + i)
        eager, me = step(eager, _batch(i), None, ge)
        captured, mc = cstep(captured, _batch(i), None, gc)
        assert torch.equal(me, mc), (method, i)
        outs.append(mc)
    assert eager.step == captured.step == 3
    for a, b in zip(eager.model.parameters(), captured.model.parameters()):
        assert torch.equal(a, b), method
    assert outs[0] is outs[1] is outs[2]   # hence train_epoch's clone
    assert len(cstep.entries) == 1


def test_each_replay_draws_from_the_generator_as_seeded():
    state = _state("sgd")
    cstep = graphs.CapturedTrainStep(_step(), graph_factory=EagerGraph)
    gen = torch.Generator()
    draws = []
    for seed in (7, 7, 8):
        gen.manual_seed(seed)
        _, m = cstep(state, _batch(0), None, gen)
        draws.append(float(m[3]))
    assert draws[0] == draws[1] != draws[2]
    # and equal to what an eager draw at that seed gives
    assert draws[0] == float(torch.rand(
        (4, 6), generator=torch.Generator().manual_seed(7)).sum())


def test_the_learning_rate_is_read_at_the_step_counter():
    table = (0.5, 0.25, 0.125, 0.0625)
    state = _state("sgd", lr_table=table)
    cstep = graphs.CapturedTrainStep(_step(), graph_factory=EagerGraph)
    gen = torch.Generator()
    rates = []
    for i in range(6):   # past the table's end, its last entry
        gen.manual_seed(i)
        _, m = cstep(state, _batch(i), None, gen)
        rates.append(float(m[2]))
        assert int(state.tx.step_t) == min(i, len(table) - 1)
    assert rates == [0.5, 0.25, 0.125, 0.0625, 0.0625, 0.0625]
    state.step = 1   # a resume: the host's step sets the counter
    gen.manual_seed(0)
    _, m = cstep(state, _batch(0), None, gen)
    assert float(m[2]) == 0.25 and state.step == 2


def test_a_replay_refuses_moved_state():
    state = _state("adamw")
    cstep = graphs.CapturedTrainStep(_step(), graph_factory=EagerGraph)
    gen = torch.Generator().manual_seed(0)
    cstep(state, _batch(0), None, gen)
    cstep(state, _batch(1), None, gen)
    # a reload from a checkpoint replaces the optimizer's state tensors
    state.tx.load_state_dict(copy.deepcopy(state.tx.optimizer.state_dict()))
    with pytest.raises(RuntimeError, match="captured on other"):
        cstep(state, _batch(2), None, gen)


def test_a_new_batch_shape_captures_a_new_train_graph():
    state = _state("adamw")
    cstep = graphs.CapturedTrainStep(_step(), graph_factory=EagerGraph)
    gen = torch.Generator().manual_seed(0)
    for rows in (4, 4, 2, 4):   # a multigrid short cycle, a last batch
        cstep(state, _batch(rows, rows), None, gen)
    assert sorted(e.replays for e in cstep.entries.values()) == [1, 3]
    assert state.step == 4


# ---------------------------------------------------------------------------
# The tensor learning rate
# ---------------------------------------------------------------------------

def _float_lr_optimizer(method, model, tx):
    """torch's optimizer as the port built it before: a float rate set on
    the groups before each step."""
    groups = [{"params": g["params"], "weight_decay": g["weight_decay"]}
              for g in tx.optimizer.param_groups]
    if method == "adamw":
        return torch.optim.AdamW(groups, lr=0.1, betas=(0.9, 0.999),
                                 eps=1e-8)
    if method == "adam":
        return torch.optim.Adam(list(model.parameters()), lr=0.1,
                                betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.SGD(groups, lr=0.1, momentum=0.9,
                           nesterov=tx.optimizer.defaults["nesterov"])


@pytest.mark.parametrize("method", ["adamw", "adam", "sgd"])
def test_tensor_lr_matches_float_lr(method):
    new, old = _state(method), _state(method)
    opt = _float_lr_optimizer(method, old.model, old.tx)
    assert all(g["lr"] is new.tx.lr for g in new.tx.optimizer.param_groups)
    for i in range(3):
        b = _batch(i)
        for st in (new, old):
            for p in st.model.parameters():
                p.grad = None
            ((st.model(b["x"]) - b["y"]) ** 2).mean().backward()
        new.tx.apply(list(new.model.parameters()), i)
        for g in opt.param_groups:
            g["lr"] = float(old.tx.lr_table[i])
        opt.step()
        assert float(new.tx.lr) == np.float32(old.tx.lr_table[i])
    for a, b in zip(new.model.parameters(), old.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_a_reload_keeps_the_transform_s_lr_tensor():
    state = _state("adamw")
    gen = torch.Generator().manual_seed(0)
    state, _ = _step()(state, _batch(0), None, gen)
    saved = state.tx.optimizer.state_dict()
    fresh = _state("adamw")
    fresh.tx.load_state_dict(saved)
    assert all(g["lr"] is fresh.tx.lr
               for g in fresh.tx.optimizer.param_groups)
