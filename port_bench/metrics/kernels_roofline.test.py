"""``kernels_roofline.test``: the hand-written kernels' share of their
roofline in a test batch, in %: the least time of the operations K1 to K4
serve in the eval forward over their device time a batch."""

from port_bench.core import trace


def read(ctx):
    s = ctx["summary"]
    if ctx["kind"] != "test" or not s["families"]:
        return None
    spent = trace.per_unit(s, "hand")
    if spent <= 0:
        return None
    return 100.0 * ctx["bound_s_per_unit"] / spent
