"""``idle_share.train``: the share of the traced train window, in %, in
which no kernel, copy or set ran on the card (the window less the union
of the device's intervals)."""


def read(ctx):
    s = ctx["summary"]
    if ctx["kind"] != "train" or not s["families"] or s["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - s["busy_s"] / s["window_s"])
