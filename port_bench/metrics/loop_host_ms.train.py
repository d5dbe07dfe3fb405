"""``loop_host_ms.train``: host milliseconds a step that the train loop
(``engine/train.py:train_epoch``) is busy over the traced slice: its spans
``train.fetch``, ``train.dispatch``, ``train.clone`` and ``train.meter``,
which the program records while the profiler does
(``svit_tpu_torch/utils/tracing.py``), less the graph's launch inside the
dispatch (``graph.launch``: the host waits there in the driver while the
card drains the previous replay, about a step), over the slice's steps;
None for a program without them."""

LOOP = ("train.fetch", "train.dispatch", "train.clone", "train.meter")


def read(ctx):
    if ctx["kind"] != "train" or not ctx["summary"]["units"]:
        return None
    try:
        from svit_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.host_spans()
    if not any(n in spans for n in LOOP):
        return None
    ns = sum(spans[n][1] for n in LOOP if n in spans)
    ns -= spans.get("graph.launch", (0, 0))[1]
    return ns / 1e6 / ctx["summary"]["units"]
