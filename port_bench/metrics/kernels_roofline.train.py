"""``kernels_roofline.train``: the hand-written kernels' share of their
roofline in a train step, in %: the least time of the operations K1 to K7
serve in a step (the yardstick's count of the work at the cell's shapes:
each op's larger of bytes over the HBM rate and operations over the peak)
over the device time of K1 to K7 a step in the trace."""

from port_bench.core import trace


def read(ctx):
    s = ctx["summary"]
    if ctx["kind"] != "train" or not s["families"]:
        return None
    spent = trace.per_unit(s, "hand")
    if spent <= 0:
        return None
    return 100.0 * ctx["bound_s_per_unit"] / spent
