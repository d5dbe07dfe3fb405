"""Compiled steps: CUDA graphs, the port's counterpart of ``jax.jit``.

The JAX package never runs its hot paths op by op: it jit-compiles the
train step (``svit_tpu/engine/train.py:92``), the eval steps (``:99``,
``:108``), the test step (``engine/test.py:96``) and the serving forward
(``serving/server.py:73``), one program per input shape.  Run eagerly, the
port pays a Python dispatch per launch (about 18,000 a train step), and
the host paces the card.  Here each such step is captured once per input
signature into a ``torch.cuda.CUDAGraph`` and replayed:

- static input buffers, keyed by the inputs' shapes and dtypes; each call
  copies its batch into them and replays.  A new signature (multigrid's
  short cycles, a last partial batch) captures a new graph, as JAX
  re-traces;
- warm-up calls on a side stream before the capture, so that the kernels'
  build, their launch plans and the one-hot tile cache run outside it;
- the train step's warm-up really steps: the parameters, the optimizer's
  state and the generator's state are put back after the capture, so the
  first replay takes the first step;
- the Trainer's generator is registered with the graph, so each replay
  draws from the seed and offset that the generator holds at replay (the
  Trainer reseeds it per step);
- the learning rate is read on the device at the transform's step counter
  (``models/optimizer.py``), which the host sets before each replay;
- the kernel wrappers count launches on the host, so a replay counts
  nothing: each graph keeps the counts taken while it was captured
  (``launches``) and its number of replays;
- the step's device owners (``utils/tracing.py``) put their marks into
  the graph as it is captured, and each replay is reported to the
  tracing module, which reads a graph's owners for its last replay.  A
  step function names its graph's kind for that table with a ``kind``
  attribute ("test", "serve"; the train step's is "train", any other
  inference step's "eval").  While the profiler records, the capture,
  the copies in, the launch and the copies out are host spans
  (``graph.capture``, ``graph.copy_in``, ``graph.launch``,
  ``graph.clone_out``).

A step with ``TPU.REMAT`` captures as it is: each block's recompute runs
inside the captured backward, with the masks its forward drew and kept
(``models/common.py:KeptDraws``), since a generator's state cannot be read
or set while capturing.

Python's cyclic garbage collector is held off during a capture: a dead
cycle that holds another graph, collected mid-capture, destroys that
graph's executable, which a capturing stream does not permit
(``cudaErrorStreamCaptureInvalidated`` at the capture's end).  Such a
cycle is collected after the capture.

No operand may move between capture and replay (the kernels' TMA maps hold
their addresses): a replay checks that the parameters and the optimizer's
state are the tensors it was captured on, and raises otherwise.  A failed
capture raises; there is no eager fallback on the card.  On the CPU the
eager step runs, unless a stand-in graph is injected (``graph_factory``),
as the tests do.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import weakref
from typing import Any, Callable, Optional

import torch

from svit_tpu_torch.ops import _lib
from svit_tpu_torch.utils import tracing

# warm-up calls before a capture: the first builds and caches, the second
# runs as the capture will
WARMUP = 2


# every captured graph still alive, for ``release_all``
_LIVE: "weakref.WeakSet[CudaGraph]" = weakref.WeakSet()


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the two calls a capture needs.  A
    stand-in with the same two methods runs the bookkeeping on the CPU."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable[[], Any], generator=None):
        """Capture ``fn()``; returns its outputs (the graph's static
        outputs).  ``generator`` is a CUDA generator ``fn`` draws from."""
        if generator is not None:
            self.graph.register_generator_state(generator)
        _LIVE.add(self)
        with no_collection(), torch.cuda.graph(self.graph):
            return fn()

    def replay(self) -> None:
        self.graph.replay()

    def release(self) -> None:
        """Destroy the captured graph (a later replay raises)."""
        self.graph.reset()


def release_all() -> None:
    """Destroy every captured graph of this process that is still alive,
    whoever still refers to it.  NCCL destroys a communicator only once no
    graph that captured one of its collectives is left (``ncclCommDestroy``
    waits for them without end), so a process group's teardown
    (``parallel/dist.py:destroy_process_group``) calls this first."""
    live = list(_LIVE)
    if live:
        torch.cuda.synchronize()
    for graph in live:
        graph.release()
    _LIVE.clear()


@contextlib.contextmanager
def no_collection():
    """No automatic collection of garbage cycles until the block ends, in
    any thread (the collector is the process's)."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def tensors(obj) -> list:
    """The tensors of a nest of dicts, lists and tuples, in a fixed order
    (dict keys sorted)."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in tensors(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in tensors(o)]
    return []


def signature(obj):
    """The capture key of a nest: its structure, and each tensor's shape,
    dtype and device."""
    if torch.is_tensor(obj):
        return (tuple(obj.shape), obj.dtype, str(obj.device))
    if isinstance(obj, dict):
        return tuple((k, signature(obj[k])) for k in sorted(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(signature(o) for o in obj)
    return obj


def _static_copy(obj):
    """A nest of fresh tensors holding ``obj``'s values (outside inference
    mode, so that later calls may copy into them)."""
    if torch.is_tensor(obj):
        with torch.inference_mode(False):
            return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _static_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_static_copy(o) for o in obj)
    return obj


def _copy_into(static, obj) -> None:
    for dst, src in zip(tensors(static), tensors(obj)):
        if dst is not src:
            dst.copy_(src, non_blocking=True)


def _clone(obj):
    if torch.is_tensor(obj):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(o) for o in obj)
    return obj


def _on_cuda(obj) -> bool:
    return any(t.is_cuda for t in tensors(obj))


@contextlib.contextmanager
def _side_stream(device):
    """Warm-up work on a side stream, ordered with the current one (what
    the allocator and autograd want before a capture); a no-op off the
    card."""
    if device.type != "cuda":
        yield
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        yield
    torch.cuda.current_stream(device).wait_stream(side)


@dataclasses.dataclass
class Entry:
    """One captured graph: its static inputs and outputs, the launches
    counted while it was captured, its replays and the addresses it
    holds."""

    graph: Any
    inputs: Any
    outputs: Any
    launches: dict
    replays: int = 0
    holds: tuple = ()


class _Graphs:
    """Graphs of one function, one per input signature."""

    kind = "eval"

    def __init__(self, graph_factory: Optional[Callable[[], Any]] = None):
        self.graph_factory = graph_factory or CudaGraph
        self.forced = graph_factory is not None
        self.entries: dict = {}

    def captures(self, obj) -> bool:
        """Whether a call on ``obj`` takes the graph: on the card, or with
        an injected stand-in."""
        return self.forced or _on_cuda(obj)

    def _capture(self, fn, device, generator=None):
        """Warm ``fn`` up on a side stream, then capture it; returns (the
        graph, its static outputs, the launches counted during the
        capture)."""
        graph = self.graph_factory()
        with tracing.span("graph.capture"):
            with _side_stream(device):
                for _ in range(WARMUP):
                    fn()
            before = collections.Counter(_lib.LAUNCHES)
            with tracing.capturing(graph, self.kind, device) as rec:
                outputs = graph.capture(rec.wrap(fn), generator)
            launches = dict(collections.Counter(_lib.LAUNCHES) - before)
        return graph, outputs, launches

    @staticmethod
    def _replay(entry, inputs=None) -> None:
        """Copy ``inputs`` into the entry's static inputs (none at its
        capture) and replay its graph."""
        if inputs is not None:
            with tracing.span("graph.copy_in"):
                _copy_into(entry.inputs, inputs)
        with tracing.span("graph.launch"):
            entry.graph.replay()
        entry.replays += 1
        tracing.replayed(entry.graph)


class CapturedStep(_Graphs):
    """An inference step (``make_eval_step``, ``make_image_eval_step``,
    ``make_test_step``, the serving forward) of one batch argument,
    captured per batch signature.  Each call returns fresh copies of the
    graph's outputs, so a caller may keep them past the next call."""

    def __init__(self, fn, **kwargs):
        super().__init__(**kwargs)
        self.fn = fn
        self.kind = getattr(fn, "kind", "eval")

    def __call__(self, batch):
        if not self.captures(batch):
            return self.fn(batch)
        key = signature(batch)
        entry = self.entries.get(key)
        if entry is None:
            inputs = _static_copy(batch)
            graph, outputs, launches = self._capture(
                lambda: self.fn(inputs), tensors(inputs)[0].device)
            entry = self.entries[key] = Entry(graph, inputs, outputs,
                                              launches)
            self._replay(entry)
        else:
            self._replay(entry, batch)
        with tracing.span("graph.clone_out"):
            return _clone(entry.outputs)


class PinnedFeed:
    """Host arrays into a ``CapturedStep`` of one batch argument.  On the
    card each array goes through a pinned host buffer into the graph's
    static input (straight into it once the graph exists); elsewhere the
    step's function runs on the array moved to ``device``."""

    def __init__(self, step: CapturedStep, device: torch.device):
        self.step, self.device = step, device
        self._host = self._x = None   # the pinned buffer, the device input

    def __call__(self, array):
        host = torch.from_numpy(array)
        if self.device.type != "cuda":
            return self.step.fn(host.to(self.device))
        if self._host is None or self._host.shape != host.shape:
            with torch.inference_mode(False):
                self._host = torch.empty(host.shape, dtype=host.dtype,
                                         pin_memory=True)
                self._x = torch.empty(host.shape, dtype=host.dtype,
                                      device=self.device)
        self._host.copy_(host)
        self._x.copy_(self._host, non_blocking=True)
        out = self.step(self._x)
        # later batches go straight into the graph's static input
        self._x = self.step.entries[signature(self._x)].inputs
        return out


class _Restore:
    """The values a train step's warm-up changes, put back after the
    capture: the parameters and buffers, the optimizer's state (tensors the
    warm-up created take zeros, which is what the first step finds) and
    the generator's state."""

    def __init__(self, state, generator):
        self.model_tensors = ([p.detach() for p in state.model.parameters()]
                              + list(state.model.buffers()))
        self.values = [t.clone() for t in self.model_tensors]
        self.tx = state.tx
        self.opt = {id(t): t.clone() for t in state.tx.state_tensors()}
        self.generator = generator
        self.rng = generator.get_state()

    def restore(self) -> None:
        with torch.no_grad():
            for t, v in zip(self.model_tensors, self.values):
                t.copy_(v)
            for t in self.tx.state_tensors():
                saved = self.opt.get(id(t))
                if saved is None:
                    t.zero_()
                else:
                    t.copy_(saved)
        self.generator.set_state(self.rng)


def _holds(state) -> tuple:
    """The addresses a train-step graph was captured on."""
    tx = state.tx
    ts = (list(state.model.parameters()) + list(state.model.buffers())
          + tx.state_tensors() + [tx.lr, tx.lr_table_t, tx.step_t])
    return (id(state.model), id(tx)) + tuple(t.data_ptr() for t in ts)


class CapturedTrainStep(_Graphs):
    """A train step of ``engine/steps.py`` (``make_train_step`` or
    ``make_packed_train_step``'s), captured per batch signature.  Same
    call and result as the step; the result is the graph's static output,
    which the next call overwrites (the train loop clones what it keeps)."""

    kind = "train"

    def __init__(self, step, **kwargs):
        super().__init__(**kwargs)
        self.step = step

    def __call__(self, state, video_batch, image_batch, generator):
        batch = (video_batch, image_batch)
        if not self.captures(batch):
            return self.step(state, video_batch, image_batch, generator)
        key = signature(batch)
        entry = self.entries.get(key)
        state.tx.set_step(state.step)
        if entry is None:
            entry = self.entries[key] = self._capture_step(
                state, batch, generator)
            self._replay(entry)
        elif _holds(state) != entry.holds:
            raise RuntimeError(
                "the train step's graph was captured on other parameters or "
                "optimizer state (reloaded or rebuilt since); build a new "
                "CapturedTrainStep")
        else:
            self._replay(entry, batch)
        state.step += 1
        return state, entry.outputs

    def _capture_step(self, state, batch, generator) -> Entry:
        inputs = _static_copy(batch)
        keep = _Restore(state, generator)
        device_step = self.step.device_step

        def run():
            return device_step(state, inputs[0], inputs[1], generator)

        graph, outputs, launches = self._capture(
            run, tensors(inputs)[0].device, generator)
        keep.restore()
        return Entry(graph, inputs, outputs, launches, holds=_holds(state))
