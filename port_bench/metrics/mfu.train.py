"""``mfu.train``: the train step's share of the card's bf16 peak, in %:
the step's matmul and convolution FLOPs (the yardstick's frozen copy of
the program's FLOP model, no recompute counted) times the steps of the
traced window, over the window's length times the peak and the chips."""


def read(ctx):
    s = ctx["summary"]
    if ctx["kind"] != "train" or not s["units"] or s["window_s"] <= 0:
        return None
    return (100.0 * ctx["flops_per_unit"] * s["units"]
            / (s["window_s"] * ctx["peak_flops"] * ctx["chips"]))
