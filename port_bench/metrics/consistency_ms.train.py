"""``consistency_ms.train``: device milliseconds of a train step in its
consistency forward (the clips' frames one by one, no gradient), read from
the program's own device marks in its captured step's last replay
(``svit_tpu_torch/utils/tracing.py``); None for a program without them."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    try:
        from svit_tpu_torch.utils import tracing
    except ImportError:
        return None
    table = tracing.last_table("train")
    if table is None:
        return None
    return sum(ms for label, ms in table["ms"].items()
               if tracing.parts(label)[0] == "consistency")
