"""``idle_share.test``: the share of the traced test window, in %, in
which nothing ran on the card."""


def read(ctx):
    s = ctx["summary"]
    if ctx["kind"] != "test" or not s["families"] or s["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - s["busy_s"] / s["window_s"])
