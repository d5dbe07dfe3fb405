"""Checkpoint converter CLI (counterpart of ``tools/convert_checkpoint.py``):
a reference ``.pyth`` <-> the port's checkpoint (a ``.pyth`` holding
``{"model_state": ...}``, which ``utils/checkpoint.py:load_params_any``
loads).  Orbax is never touched.

    python -m svit_tpu_torch.tools.convert_checkpoint --input ref.pyth \\
        --output port.pyth [--separate-qkv] [--input-order bgr|rgb]
    python -m svit_tpu_torch.tools.convert_checkpoint --to-reference \\
        --input <port .pyth or checkpoint dir> --output ref.pyth

``--separate-qkv``: the q, k and v projections separate (a model with
``MVIT.SEPARATE_QKV``; on export, the reference file's layout), else fused.
``--input-order``: the channel order the reference checkpoint was trained
on.  The reference pipeline feeds cv2's BGR frames unconverted, so released
checkpoints are ``bgr`` (the default): the stem's input channels are
flipped for the port's RGB pipeline, and back on export.  The rules are in
``utils/converter.py``.
"""

import argparse

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--to-reference", action="store_true",
                   help="convert the port's checkpoint to the reference's")
    p.add_argument("--separate-qkv", action="store_true")
    p.add_argument("--input-order", choices=["bgr", "rgb"], default="bgr")
    args = p.parse_args(argv)

    from svit_tpu_torch.utils import checkpoint as cu
    from svit_tpu_torch.utils import converter

    if args.to_reference:
        state = converter.port_to_reference(
            cu.read_params(args.input), args.separate_qkv, args.input_order)
        what = "reference"
    else:
        state = converter.reference_to_port(
            converter.load_torch_state(args.input), args.separate_qkv,
            args.input_order)
        what = "port"
    torch.save({"model_state": state}, args.output)
    print(f"wrote the {what}'s checkpoint: {args.output} ({len(state)} "
          "tensors)")


if __name__ == "__main__":
    main()
