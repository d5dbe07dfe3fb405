"""``glue_ms.train``: device milliseconds a train step in operations other
than the hand-written kernels K1 to K7 (PyTorch's kernels, cuBLAS, cuDNN,
copies and sets), sorted by the yardstick's frozen name rules."""

from port_bench.core import trace


def read(ctx):
    s = ctx["summary"]
    if ctx["kind"] != "train" or not s["families"]:
        return None
    return 1e3 * trace.per_unit(s, "glue")
