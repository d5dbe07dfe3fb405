"""Multi-view test CLI (counterpart of ``tools/test_net.py``).

    python -m svit_tpu_torch.tools.test_net --cfg configs/ssv2.yaml KEY VALUE ...
"""

from svit_tpu_torch.config import assert_and_infer_cfg, load_config, parse_args


def main(argv=None, device=None):
    from svit_tpu_torch.engine.test import test

    test(assert_and_infer_cfg(load_config(parse_args(argv))), device=device)


if __name__ == "__main__":
    main()
