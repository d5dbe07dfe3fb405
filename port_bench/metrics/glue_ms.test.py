"""``glue_ms.test``: device milliseconds a test batch in operations other
than the hand-written kernels K1 to K7."""

from port_bench.core import trace


def read(ctx):
    s = ctx["summary"]
    if ctx["kind"] != "test" or not s["families"]:
        return None
    return 1e3 * trace.per_unit(s, "glue")
