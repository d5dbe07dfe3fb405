"""Train-only CLI (counterpart of ``tools/train_net.py``).

One process per local card (``utils/misc.py:launch_job``):

    python -m svit_tpu_torch.tools.train_net --cfg configs/ssv2.yaml KEY VALUE ...
"""

from svit_tpu_torch.config import assert_and_infer_cfg, load_config, parse_args


def main(argv=None, device=None):
    from svit_tpu_torch.engine.train import train
    from svit_tpu_torch.utils.misc import launch_job

    launch_job(assert_and_infer_cfg(load_config(parse_args(argv))),
               func=train, device=device)


if __name__ == "__main__":
    main()
