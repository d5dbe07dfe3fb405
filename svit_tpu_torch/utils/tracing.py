"""Tracing of the port: device owners that survive CUDA-graph capture, and
host spans on the profiler's clock.

**Device owners.**  The model, ops and steps name the owners of their
device work with ``owner(name)`` scopes (the step's phases, the stem,
each block with its ``attn`` and ``mlp``, the ``head``; inside the
attention the ``sub`` owners ``pool_q``, ``pool_kv``, ``bias``, ``core``
and ``proj``, whose marks a captured forward leaves out: a mark costs the
card one to three microseconds, and their forward is the smaller half).
While ``engine/graphs.py`` captures a step (``capturing``), every
boundary of an owner puts a mark on the current stream: a one-thread
kernel that writes the device's global nanosecond timer into a slot of a
buffer (``csrc/stamp.cu``).  The marks are captured once with the step,
so each replay writes them anew.  Each graph keeps the label of every
mark, the owner of the interval that follows it (its full path, such as
``video/blocks.3/attn/core (backward)``), so the intervals of a replay
cover it whole, each with exactly one owner.

The backward has no module calls to scope: its boundaries come from
identity markers (``Scope.inputs``, ``Scope.outputs``), autograd Functions
at an owner's tensor edges that launch nothing and pass gradients through
untouched.  The first output marker to run opens ``<path> (backward)``
when the outputs' gradients arrive; the first input marker closes it when
the inputs' gradients leave.  A hand-written Function's ``backward`` opens its
own scopes inside that (``core`` and ``proj`` of ``_AttentionProjFn``).
Under ``TPU.REMAT`` a block's recompute in the backward is one owner,
``<path> (recompute)`` (``recompute``), with no scopes inside it.

``owner_tables()`` returns, after a synchronisation, each live graph's
device milliseconds by owner for its last replay; ``graphs.py`` reports
each replay (``replayed``).  The graphs' records live here, in a registry
that holds the graphs weakly.

**Host spans.**  ``span(name)`` is a profiler range of the fast kind
(``_RecordFunctionFast``, which the profiler keeps on the host's lanes: a
user-scope ``record_function`` around a launch comes back from the card's
profiler as a device-lane annotation too) and adds its count and host
nanoseconds to an aggregate by name (``host_spans``).  The train loop
(``train.*``) and ``graphs.py`` (``graph.*``) record them.

**The switch.**  Host spans, owner ranges and markers exist exactly while a
``torch.profiler`` session records; owner marks also while a graph is
captured.  Otherwise ``span`` and ``owner`` return one shared null scope
after a flag test, and the markers are not applied.  Eagerly under the
profiler an owner is a range ``module::<path>``, the name
``tools/trace_attrib.py --by-owner`` reads, so an eager trace and a
replay's table use the same owner names.
"""

from __future__ import annotations

import collections
import itertools
import time
import weakref
from typing import Optional

import torch

from svit_tpu_torch.ops import _lib

MODULE = "module::"          # an owner's profiler range: its path follows
BACKWARD = " (backward)"
RECOMPUTE = " (recompute)"
ROOT = "step"                # the owner of a step's work outside any scope
CHUNK = 4096                 # stamp slots per device buffer


def profiling() -> bool:
    """Whether a profiler session records (the switch)."""
    return torch._C._autograd._profiler_enabled()


# ---------------------------------------------------------------------------
# Host spans
# ---------------------------------------------------------------------------

_HOST: dict = collections.defaultdict(lambda: [0, 0])  # name -> [count, ns]
_FastRange = torch._C._profiler._RecordFunctionFast


class _Null:
    """The shared scope of ``span`` and ``owner`` with tracing off: enters
    and leaves doing nothing; its markers hand the tensors back."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def inputs(*ts):
        return ts[0] if len(ts) == 1 else ts

    outputs = inputs


_NULL = _Null()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _FastRange(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        self._range.__exit__(*exc)
        agg = _HOST[self.name]
        agg[0] += 1
        agg[1] += dt
        return False


def span(name: str):
    """A host span ``name`` while the profiler records, else the null
    scope."""
    return _Span(name) if profiling() else _NULL


def host_spans() -> dict:
    """{name: (count, host ns)} of every span recorded in this process."""
    return {n: (c, ns) for n, (c, ns) in _HOST.items()}


def reset_host_spans() -> None:
    _HOST.clear()


# ---------------------------------------------------------------------------
# Device owners
# ---------------------------------------------------------------------------

class _Open:
    """An open owner: its path, its suffix ("", backward, recompute) and
    the scope that opened it."""

    __slots__ = ("path", "suffix", "scope")

    def __init__(self, path, suffix, scope):
        self.path, self.suffix, self.scope = path, suffix, scope

    @property
    def label(self) -> str:
        return self.path + self.suffix


class _Record:
    """One captured graph's marks: the label that follows each mark, its
    nesting depth and, on the card, the stamp slots its replays write."""

    def __init__(self, kind: str, device):
        self.kind = kind
        self.device = device
        self.labels: list = []
        self.depths: list = []
        self.chunks: list = []
        self.replays = 0
        self.order = 0       # the process's replay count at the last one

    def mark(self, label: str, depth: int) -> None:
        if self.device.type == "cuda":
            n = len(self.labels)
            if n == len(self.chunks) * CHUNK:
                self.chunks.append(torch.empty(CHUNK, dtype=torch.int64,
                                               device=self.device))
            slot = self.chunks[-1][n % CHUNK:]
            _lib.call("svit_stamp", slot.data_ptr(),
                      torch.cuda.current_stream(self.device).cuda_stream)
        self.labels.append(label)
        self.depths.append(depth)

    def table(self) -> Optional[dict]:
        """Device ms by label of the last replay (None before one, or off
        the card)."""
        if not self.replays or not self.chunks or len(self.labels) < 2:
            return None
        n = len(self.labels)
        stamps = torch.cat(self.chunks).cpu()[:n].tolist()
        ms = collections.Counter()
        for label, t0, t1 in zip(self.labels, stamps, stamps[1:]):
            ms[label] += (t1 - t0) / 1e6
        return {"kind": self.kind, "replays": self.replays,
                "order": self.order, "marks": n,
                "total_ms": (stamps[-1] - stamps[0]) / 1e6, "ms": dict(ms)}


_REC: Optional[_Record] = None          # the capture in progress
_STACK: list = []                       # open owners, innermost last
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_REPLAYS = itertools.count(1)


def _on() -> bool:
    return _REC is not None or profiling()


def _mark() -> None:
    if _REC is not None:
        _REC.mark(_STACK[-1].label if _STACK else ROOT, len(_STACK))


class capturing:
    """The capture of ``graph`` (a step of ``kind``: "train", "test",
    "eval" or "serve") on ``device``: the owners' marks of the function
    that ``wrap`` returns, from a first mark of the step's root to a last
    one, are recorded for the graph if the capture succeeds."""

    def __init__(self, graph, kind: str, device):
        self.graph = graph
        self.record = _Record(kind, torch.device(device))

    def __enter__(self):
        global _REC
        _REC = self.record
        return self

    def __exit__(self, *exc):
        global _REC
        _REC = None
        _STACK.clear()
        if exc[0] is None:
            _GRAPHS[self.graph] = self.record
        return False

    @staticmethod
    def wrap(fn):
        """``fn`` between the step's first and last marks."""
        def step():
            _STACK.clear()
            _mark()
            out = fn()
            _STACK.clear()
            _mark()
            return out
        return step


def replayed(graph) -> None:
    """Note a replay of ``graph`` (a captured one's table reads its last)."""
    rec = _GRAPHS.get(graph)
    if rec is not None:
        rec.replays += 1
        rec.order = next(_REPLAYS)


def owner_tables(device=None) -> list:
    """Each live captured graph's device ms by owner in its last replay,
    after a synchronisation: a list of {kind, replays, order, marks,
    total_ms, ms: {label: ms}}, the most recently replayed first."""
    recs = list(_GRAPHS.values())
    if any(r.device.type == "cuda" for r in recs):
        torch.cuda.synchronize(device)
    tables = [t for t in (r.table() for r in recs) if t is not None]
    return sorted(tables, key=lambda t: -t["order"])


def last_table(kind: str) -> Optional[dict]:
    """``owner_tables()``' table of the graph of ``kind`` replayed last,
    None if there is none."""
    for t in owner_tables():
        if t["kind"] == kind:
            return t
    return None


def parts(label: str) -> list:
    """The names along an owner's path, without its suffix."""
    for suffix in (BACKWARD, RECOMPUTE):
        if label.endswith(suffix):
            label = label[:-len(suffix)]
    return label.split("/")


def labels(graph) -> Optional[tuple]:
    """(labels, depths) of ``graph``'s marks, None if it has no record."""
    rec = _GRAPHS.get(graph)
    return None if rec is None else (list(rec.labels), list(rec.depths))


class Scope:
    """An owner's scope: while it is open, device work belongs to it.  Its
    ``inputs`` and ``outputs`` put the backward's markers on the tensors
    that enter and leave it.  A ``sub`` owner's forward puts no marks: a
    captured forward leaves its work to the parent owner, and only the
    profiler's range names it; its backward is marked."""

    __slots__ = ("name", "sub", "path", "suffix", "_range", "_opened",
                 "__weakref__")

    def __init__(self, name: str, sub: bool = False):
        self.name, self.sub = name, sub
        self._range = None

    def __enter__(self):
        top = _STACK[-1] if _STACK else None
        if top is None:
            self.path, self.suffix = self.name, ""
        else:
            self.path, self.suffix = top.path + "/" + self.name, top.suffix
        self._opened = not self.sub or self.suffix == BACKWARD
        if self._opened:
            _open(self.path, self.suffix, self)
        if profiling():
            self._range = _FastRange(MODULE + self.path + self.suffix)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self._opened:
            _close(self)
        return False

    def inputs(self, *ts):
        """``ts`` (tensors or None) with the marker that closes this
        owner's backward when their gradients leave."""
        return _marked(_leave, self, ts)

    def outputs(self, *ts):
        """``ts`` with the marker that opens this owner's backward when
        their gradients arrive."""
        return _marked(_arrive, self, ts)


def _open(path: str, suffix: str, key) -> None:
    _STACK.append(_Open(path, suffix, key))
    _mark()


def _close(key) -> None:
    """Close the innermost owner opened by ``key`` and what lies inside it
    (one mark); nothing if none is open."""
    for i in range(len(_STACK) - 1, -1, -1):
        if _STACK[i].scope is key:
            del _STACK[i:]
            _mark()
            return


def owner(name: str, sub: bool = False):
    """The scope of owner ``name`` (a child of the innermost open one; a
    ``sub`` owner marks its backward only), or the null scope when neither
    a capture nor the profiler records, or inside a recompute."""
    return Scope(name, sub) if _on() and not _SILENT else _NULL


def path() -> str:
    """The path of the innermost open owner ("" with none)."""
    return _STACK[-1].path if _STACK else ""


class _Recompute:
    __slots__ = ("label", "_range")

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        global _SILENT
        _open(self.label, RECOMPUTE, self)
        self._range = None
        if profiling():
            self._range = _FastRange(MODULE + self.label + RECOMPUTE)
            self._range.__enter__()
        _SILENT += 1
        return self

    def __exit__(self, *exc):
        global _SILENT
        _SILENT -= 1
        if self._range is not None:
            self._range.__exit__(*exc)
        _close(self)
        return False


_SILENT = 0      # open recomputes: their blocks open no scopes of their own


def recompute(base: str, again: bool):
    """A block's run under ``TPU.REMAT``: its forward (``again`` False)
    as it is; its recompute in the backward one owner ``<base>
    (recompute)``, with the block's own scopes silent."""
    if not again or not _on():
        return _NULL
    return _Recompute(base)


def _marked(fn, scope, objs):
    """``objs`` (tensors, None, or dicts, lists and tuples of them) with
    the tensors that want a gradient through the marker ``fn`` of
    ``scope``; as they are with none, or with grad mode off."""
    leaves = []
    _leaves(objs, leaves)
    if not leaves or not torch.is_grad_enabled():
        return objs[0] if len(objs) == 1 else objs
    out = _rebuild(objs, iter(fn(scope, leaves)))
    return out[0] if len(out) == 1 else out


def _leaves(obj, out: list) -> None:
    if isinstance(obj, torch.Tensor):
        if obj.requires_grad:
            out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _leaves(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _leaves(v, out)


def _rebuild(obj, marked):
    if isinstance(obj, torch.Tensor):
        return next(marked) if obj.requires_grad else obj
    if isinstance(obj, dict):
        return {k: _rebuild(v, marked) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(v, marked) for v in obj)
    return obj


class _Arrive(torch.autograd.Function):
    """Identity on one of an owner's outputs (no kernel); the first of its
    outputs' markers to run in the backward opens the owner's backward.
    One node per output: an output that nothing downstream uses leaves its
    node, and what produced it, out of the backward."""

    @staticmethod
    def forward(ctx, scope, t):
        ctx.scope = scope
        ctx.set_materialize_grads(False)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        scope = ctx.scope
        if _on() and not (_STACK and any(o.scope is scope for o in _STACK)):
            _open(scope.path, BACKWARD, scope)
        return None, grad


class _Leave(torch.autograd.Function):
    """Identity on one of an owner's inputs (no kernel); the first of its
    inputs' markers to run in the backward closes the owner's backward.
    Autograd runs the ready node of the latest forward first, so the
    owner's own nodes, all later than its input markers, have run by then.
    One node per input, as for the outputs: an input whose gradient only
    a dead branch of the owner would give keeps that branch out."""

    @staticmethod
    def forward(ctx, scope, t):
        ctx.scope = scope
        ctx.set_materialize_grads(False)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        _close(ctx.scope)
        return None, grad


def _arrive(scope, ts):
    return [_Arrive.apply(scope, t) for t in ts]


def _leave(scope, ts):
    return [_Leave.apply(scope, t) for t in ts]
