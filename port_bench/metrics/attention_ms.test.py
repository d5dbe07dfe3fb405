"""``attention_ms.test``: device milliseconds of a test batch in the
attention's owners (each block's ``attn`` and the owners inside it), read
from the program's own device marks in its captured test step's last
replay (``svit_tpu_torch/utils/tracing.py``); None for a program without
them."""


def read(ctx):
    if ctx["kind"] != "test":
        return None
    try:
        from svit_tpu_torch.utils import tracing
    except ImportError:
        return None
    table = tracing.last_table("test")
    if table is None:
        return None
    return sum(ms for label, ms in table["ms"].items()
               if "attn" in tracing.parts(label))
