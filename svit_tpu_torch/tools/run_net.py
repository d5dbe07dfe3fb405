"""Umbrella CLI (counterpart of ``tools/run_net.py``, reference
``tools/run_net.py``): train, then test, then visualization, then the demo,
as ``TRAIN.ENABLE``, ``TEST.ENABLE``, ``TENSORBOARD.*`` and ``DEMO.ENABLE``
say (the reference's flag contract):

    python -m svit_tpu_torch.tools.run_net --cfg configs/ssv2.yaml KEY VALUE ...
"""

from svit_tpu_torch.config import assert_and_infer_cfg, load_config, parse_args


def main(argv=None, device=None):
    cfg = assert_and_infer_cfg(load_config(parse_args(argv)))

    if cfg.TRAIN.ENABLE:
        from svit_tpu_torch.engine.train import train

        train(cfg, device=device)

    if cfg.TEST.ENABLE:
        from svit_tpu_torch.engine.test import test

        test(cfg, device=device)

    if cfg.TENSORBOARD.ENABLE and (
            cfg.TENSORBOARD.MODEL_VIS.ENABLE
            or cfg.TENSORBOARD.WRONG_PRED_VIS.ENABLE):
        from svit_tpu_torch.visualization.run import visualize

        visualize(cfg, device=device)

    if cfg.DEMO.ENABLE:
        from svit_tpu_torch.visualization.demo import demo

        demo(cfg, device=device)


if __name__ == "__main__":
    main()
