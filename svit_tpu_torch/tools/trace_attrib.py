"""Device time of a ``torch.profiler`` trace by kernel family and by owner
(counterpart of ``tools/trace_attrib.py``).

    python -m svit_tpu_torch.tools.trace_attrib TRACE [--iters N] [--top 40]
        [--by-owner] [--ops] [--match REGEX] [--device cpu] [--out FILE]

``TRACE`` is a Chrome trace that ``torch.profiler`` exported (``.json`` or
``.json.gz``, or a directory: its newest one), such as
``trace_forward``'s or the Trainer's ``TPU.PROFILE_DIR`` trace.  Device
time is the sum of the kernels', copies' and sets' durations (a CUDA
stream runs one at a time; the device lanes' user-annotation ranges, which
span kernels that have rows of their own, are left out).  It is printed
per iteration (``--iters``):

- by family: ``KERNELS`` sorts the hand-written kernels K1 to K7 by their
  ``csrc/`` names, then ``FAMILY_RE`` the rest: cuBLAS/CUTLASS GEMMs,
  convolutions, NCCL, memcpy and memset, ``CatArrayBatchedCopy``, casts
  and copies, reductions and elementwise kernels;
- ``--ops``: the heaviest kernels by name; ``--match`` keeps the rows
  whose kernel name matches;
- ``--by-owner`` (the JAX tool's ``--by-meta``): each kernel maps to the
  runtime call that launched it by the event's ``correlation`` (or its
  ``ac2g`` flow), the call to the host op around it, and the op to its
  owner: the innermost owner range above it (``module::<path>``, which the
  program records under the profiler, ``utils/tracing.py``: the names of
  a replay's owner table), else, on autograd's thread, the owner of the
  forward op whose ``Sequence number`` its backward node
  (``autograd::engine::evaluate_function``) carries (the profiler's
  ``fwdbwd`` flow, drawn from that number and the forward thread; a
  trace without flows is matched on the number), with "(backward)"
  (the hand-written kernels' own ``autograd.Function``s among them), else
  its outermost op.  A CUDA graph's replay launches its kernels in one
  call: they are counted by family and owned by ``graph replay`` (a
  replay's owners are the program's own table,
  ``tracing.owner_tables``).  Kernels whose launch the trace lacks are
  ``unowned``, and their share is printed.

A trace without device events, or whose kernels carry neither a
``correlation`` nor a flow to their launch, raises: nothing is reported as
zero.  The report goes to ``chiprun_out/trace_attrib.json``.  It runs
where the card is, unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
from dataclasses import dataclass, field
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "chiprun_out", "trace_attrib.json")

MODULE = "module::"       # an owner range: its path follows
NODE = "autograd::engine::evaluate_function: "
BACKWARD = " (backward)"
GRAPH = "graph replay"
UNOWNED = "unowned"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
# the hand-written kernels by their csrc/ names, each with its family: the
# one table that sorts them by name
KERNELS = {
    "ln_linear_kernel": "K1 ln_linear",
    "pool_ln_kernel": "K2 pool_ln", "halo_gen_kernel": "K2 pool_ln",
    "pool_max_kernel": "K3 pool_max",
    "pool_max_bwd_kernel": "K3 pool_max_bwd",
    "pool_max_bwd_tile_kernel": "K3 pool_max_bwd",
    "attn_fwd_kernel": "K4 attention",
    "attn_bwd_q_kernel": "K5 attention_bwd",
    "attn_bwd_kv_kernel": "K5 attention_bwd",
    "attn_bwd_reduce_kernel": "K5 attention_bwd",
    "dx_kernel": "K6 conv_dx",
    "conv_dk_kernel": "K7 conv_dk", "conv_dk_reduce_kernel": "K7 conv_dk",
    "dk_gen_kernel": "K7 conv_dk",
}
HAND_WRITTEN = frozenset(KERNELS.values())
# a name as the profiler demangles it (``void pool_ln_kernel<3, true>(...)``)
# or mangled, as a graph's DOT dump has it (``_Z14pool_ln_kernelILi3E...``):
# no name of the table begins another
KERNEL_RE = re.compile(r"(?<![A-Za-z_])(" + "|".join(KERNELS) + ")")
FAMILY_RE = [
    (re.compile(r"(?i)nccl"), "NCCL"),
    (re.compile(r"(?i)^mem(cpy|set)\b"), "memcpy/memset"),
    (re.compile(r"CatArrayBatchedCopy"), "CatArrayBatchedCopy"),
    (re.compile(r"(?i)copy_kernel|_to_copy|\bcast"), "cast/copy"),
    (re.compile(r"(?i)fprop|dgrad|wgrad|cudnn|convolve|conv_depthwise"),
     "convolution"),
    (re.compile(r"(?i)nvjet|gemm|cutlass|xmma|cublas|splitkreduce"), "GEMM"),
    (re.compile(r"(?i)reduce|softmax|layer_norm|welford|norm_kernel"),
     "reduction"),
    (re.compile(r"(?i)elementwise|multi_tensor_apply|fill|index"),
     "elementwise"),
]


def kernel_name(text: str) -> Optional[str]:
    """The hand-written kernel that ``text`` names, else None."""
    m = KERNEL_RE.search(text)
    return m.group(1) if m else None


def is_hand_written(fam: str) -> bool:
    """Whether a family is one of the hand-written kernels K1 to K7."""
    return fam in HAND_WRITTEN


def family(name: str, cat: str = "kernel") -> str:
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "memcpy/memset"
    own = kernel_name(name)
    if own is not None:
        return KERNELS[own]
    for rx, fam in FAMILY_RE:
        if rx.search(name):
            return fam
    return "other"


@dataclass(eq=False)
class Op:
    """A host op or range (``cpu_op``, ``user_annotation``) or a runtime
    call, with the innermost host op around it."""

    name: str
    ts: float
    end: float
    args: dict
    runtime: bool = False
    parent: Optional["Op"] = None

    @property
    def seq(self):
        return self.args.get("Sequence number")

    def ancestors(self):
        """The host ops around this one, innermost first (itself first if
        it is a host op)."""
        op = self.parent if self.runtime else self
        while op is not None:
            yield op
            op = op.parent


@dataclass(eq=False)
class Kernel:
    name: str
    cat: str
    dur: float                    # us
    launch: Optional[Op] = None   # the runtime call
    family: str = field(default="")

    @property
    def op(self) -> Optional[Op]:
        """The host op that launched the kernel (None for a graph replay's
        or an unlinked kernel)."""
        return None if self.launch is None or self.graph else \
            self.launch.parent

    @property
    def graph(self) -> bool:
        return self.launch is not None and "GraphLaunch" in self.launch.name


def load(path: str) -> list:
    """The events of a Chrome trace: a ``.json``/``.json.gz`` file, or the
    newest one under a directory."""
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "**", "*.json*"),
                                 recursive=True), key=os.path.getmtime)
        if not found:
            raise FileNotFoundError(f"no trace under {path}")
        path = found[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def from_profiler(prof, path: str) -> "Trace":
    """Export ``prof`` (a finished ``torch.profiler.profile``) to ``path``
    as a Chrome trace (gzipped if it ends with ``.gz``) and read it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    return Trace(load(path))


class Trace:
    """The kernels of a Chrome trace, each linked to its launch and its
    launching op.  Raises if the trace has no device events or lacks the
    keys that link them to their launches."""

    def __init__(self, events):
        lanes = collections.defaultdict(list)
        self.kernels = []
        runtime_by_corr, runtime_at, flow_start, flow_end = {}, {}, {}, {}
        op_at, fwdbwd = {}, collections.defaultdict(dict)
        for e in events:
            ph, cat = e.get("ph"), e.get("cat")
            if ph == "X" and cat in DEVICE_CATS:
                self.kernels.append((e, Kernel(
                    e.get("name", "?"), cat, float(e.get("dur", 0)))))
            elif ph == "X" and cat in HOST_CATS + RUNTIME_CATS:
                ts = float(e["ts"])
                op = Op(e.get("name", "?"), ts, ts + float(e.get("dur", 0)),
                        e.get("args") or {}, runtime=cat in RUNTIME_CATS)
                lanes[(e.get("pid"), e.get("tid"))].append(op)
                where = (e.get("pid"), e.get("tid"), e["ts"])
                if op.runtime:
                    corr = op.args.get("correlation")
                    if corr is not None:
                        runtime_by_corr[corr] = op
                    runtime_at[where] = op
                else:
                    op_at[where] = op
            elif ph in ("s", "f") and cat == "ac2g":
                where = (e.get("pid"), e.get("tid"), e.get("ts"))
                if ph == "s":
                    flow_start[e.get("id")] = where
                else:
                    flow_end[where] = e.get("id")
            elif ph in ("s", "f") and cat == "fwdbwd":
                fwdbwd[e.get("id")][ph] = (e.get("pid"), e.get("tid"),
                                           e.get("ts"))
        if not self.kernels:
            raise ValueError("the trace has no device events (kernels, "
                             "copies): it was not taken with the CUDA "
                             "activity")
        for ops in lanes.values():
            _nest(ops)
        linked = 0
        for e, k in self.kernels:
            corr = (e.get("args") or {}).get("correlation")
            k.launch = runtime_by_corr.get(corr)
            if k.launch is None:
                fid = flow_end.get((e.get("pid"), e.get("tid"), e.get("ts")))
                if fid in flow_start:
                    k.launch = runtime_at.get(flow_start[fid])
            linked += k.launch is not None
            k.family = family(k.name, k.cat)
        if not linked:
            raise ValueError(
                "no device event of the trace links to its launch: they "
                "carry no correlation or ac2g flow, or the trace has no "
                "runtime calls (profile the CPU and CUDA activities)")
        self.kernels = [k for _, k in self.kernels]
        # a backward node's forward op: the profiler's fwdbwd flow, which it
        # draws by sequence number (and forward thread); without flows, the
        # first forward op that carries the node's sequence number
        self.flow_forward = {}
        for ends in fwdbwd.values():
            fwd, node = op_at.get(ends.get("s")), op_at.get(ends.get("f"))
            if fwd is not None and node is not None:
                self.flow_forward[id(node)] = fwd
                if node.parent is not None and \
                        node.parent.name.startswith(NODE):
                    # the engine's work for the node outside its own call
                    self.flow_forward[id(node.parent)] = fwd
        self.forward = {}
        for op in sorted((o for ops in lanes.values() for o in ops
                          if not o.runtime and o.seq is not None
                          and o.seq >= 0 and not _is_node(o)),
                         key=lambda o: o.ts):
            self.forward.setdefault(op.seq, op)
        self._owners = {}

    def owner(self, op: Optional[Op]) -> str:
        """The owner of a host op (see the module's docstring)."""
        if op is None:
            return UNOWNED
        cached = self._owners.get(id(op))
        if cached is not None:
            return cached
        out = None
        outermost = op
        for a in op.ancestors():
            outermost = a
            if a.name.startswith(MODULE):
                out = a.name[len(MODULE):]
                break
            fwd = self._forward_of(a)
            if fwd is not None or a.name.startswith(NODE):
                base = (self.owner(fwd) if fwd is not None
                        else a.name[len(NODE):])
                out = base if base.endswith(BACKWARD) else base + BACKWARD
                break
        if out is None:
            out = f"op {outermost.name}"
        self._owners[id(op)] = out
        return out

    def _forward_of(self, op: Op) -> Optional[Op]:
        """The forward op of a backward node's record, if ``op`` is one:
        by the fwdbwd flows, else (a trace without them) by sequence
        number, among the forward ops that began before the node."""
        if self.flow_forward:
            return self.flow_forward.get(id(op))
        if op.name.startswith(NODE):
            fwd = self.forward.get(op.seq)
            if fwd is not None and fwd.ts < op.ts:
                return fwd
        return None

    def kernel_owner(self, k: Kernel) -> str:
        if k.graph:
            return GRAPH
        if k.launch is None or k.launch.parent is None:
            return UNOWNED
        return self.owner(k.launch.parent)


def _is_node(op: Op) -> bool:
    """An autograd node's record (``evaluate_function`` or the node's own
    op inside it), which carries its forward op's sequence number."""
    return op.name.startswith(NODE) or (
        op.parent is not None and op.parent.name.startswith(NODE))


def _nest(ops) -> None:
    """Give each op of one thread the innermost host op around it."""
    ops.sort(key=lambda o: (o.ts, -(o.end - o.ts), o.runtime))
    stack = []
    for op in ops:
        while stack and not (op.ts >= stack[-1].ts
                             and op.end <= stack[-1].end + 1e-3):
            stack.pop()
        op.parent = stack[-1] if stack else None
        if not op.runtime:
            stack.append(op)


def anchor(op: Op) -> Op:
    """The nearest autograd node above ``op`` (``evaluate_function``), else
    its outermost op."""
    top = op
    for a in op.ancestors():
        top = a
        if a.name.startswith(NODE):
            break
    return top


def within(op: Optional[Op], names) -> bool:
    """Whether ``op`` lies inside a range or op named in ``names``."""
    return op is not None and any(a.name in names for a in op.ancestors())


def _rows(acc, iters, top=None):
    rows = sorted(([k, us / iters / 1e3, n / iters]
                   for k, (us, n) in acc.items()), key=lambda r: -r[1])
    return rows if top is None else rows[:top]


def summarize(trace: Trace, iters: int = 1, top: int = 40,
              match: Optional[str] = None) -> dict:
    """Device ms and launches per iteration: in all, by family, by owner
    and by kernel name ([name, ms, launches] rows, busiest first), each
    owner's ms by family, and the unowned and graph-replay shares."""
    fam, own, ops = (collections.defaultdict(lambda: [0.0, 0])
                     for _ in range(3))
    by_family = collections.defaultdict(collections.Counter)
    total = 0.0
    for k in trace.kernels:
        if match and not re.search(match, k.name):
            continue
        total += k.dur
        owner = trace.kernel_owner(k)
        for acc, key in ((fam, k.family), (own, owner), (ops, k.name)):
            acc[key][0] += k.dur
            acc[key][1] += 1
        by_family[owner][k.family] += k.dur
    unowned = own.get(UNOWNED, (0.0, 0))[0]
    graph = own.get(GRAPH, (0.0, 0))[0]
    owners = _rows(own, iters, top)
    return {"iters": iters, "device_ms": total / iters / 1e3,
            "unowned_ms": unowned / iters / 1e3,
            "unowned_share": unowned / total if total else 0.0,
            "graph_replay_share": graph / total if total else 0.0,
            "families": _rows(fam, iters), "owners": owners,
            "owner_families": {o: {f: us / iters / 1e3 for f, us in
                                   by_family[o].most_common()}
                               for o, _, _ in owners},
            "ops": _rows(ops, iters, top)}


def glue_ms(summary: dict, owner: str) -> float:
    """An owner's ms outside the hand-written kernels K1 to K7."""
    return sum(ms for f, ms in summary["owner_families"][owner].items()
               if not is_hand_written(f))


def hand_written(summary: dict) -> dict:
    """The hand-written families of a summary: {family: [ms, launches]}."""
    return {f: [ms, n] for f, ms, n in summary["families"]
            if is_hand_written(f)}


def print_summary(s: dict, by_owner=True, show_ops=False, top=40,
                  file=None) -> None:
    print(f"device time: {s['device_ms']:.3f} ms/iter over {s['iters']} "
          f"iterations; unowned {s['unowned_ms']:.3f} ms "
          f"(share {s['unowned_share']:.4f}); graph replay share "
          f"{s['graph_replay_share']:.4f}", file=file)
    print("\n== by family ==", file=file)
    for name, ms, n in s["families"][:top]:
        print(f"{ms:9.3f} ms {n:9.1f}x  {name}", file=file)
    if show_ops:
        print("\n== heaviest kernels ==", file=file)
        for name, ms, n in s["ops"][:top]:
            print(f"{ms:9.3f} ms {n:9.1f}x  {name[:110]}", file=file)
    if by_owner:
        print("\n== by owner ==", file=file)
        for name, ms, n in s["owners"][:top]:
            print(f"{ms:9.3f} ms {n:9.1f}x  {name[:140]}", file=file)


def main(argv=None, device=None):
    from svit_tpu_torch.models.build import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--by-owner", action="store_true",
                    help="aggregate by the module that launched each kernel")
    ap.add_argument("--ops", action="store_true",
                    help="print the heaviest kernels by name")
    ap.add_argument("--match", default=None,
                    help="only count kernels whose name matches this regex")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    resolve_device(device or args.device)

    s = summarize(Trace(load(args.trace)), args.iters, args.top, args.match)
    print_summary(s, args.by_owner, args.ops, args.top)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(s, trace=args.trace), f, indent=1)
    return s


if __name__ == "__main__":
    main()
