"""Visualization CLI (counterpart of ``tools/visualization.py``).

    python -m svit_tpu_torch.tools.visualization --cfg configs/ssv2.yaml KEY VALUE ...
"""

from svit_tpu_torch.config import assert_and_infer_cfg, load_config, parse_args


def main(argv=None, device=None):
    from svit_tpu_torch.visualization.run import visualize

    visualize(assert_and_infer_cfg(load_config(parse_args(argv))), device=device)


if __name__ == "__main__":
    main()
