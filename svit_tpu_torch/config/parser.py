"""CLI argument parsing.

Same surface as reference ``slowfast/utils/parser.py:13-100``:
``--cfg FILE`` + trailing ``KEY VALUE`` override pairs, plus multi-host
shard flags.
"""

import argparse
import sys

from svit_tpu_torch.config.defaults import get_cfg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="SViT on PyTorch and CUDA."
    )
    parser.add_argument(
        "--shard_id",
        help="The shard id (host index) of the current machine.",
        default=0,
        type=int,
    )
    parser.add_argument(
        "--num_shards",
        help="Number of shards (hosts) in the job.",
        default=1,
        type=int,
    )
    parser.add_argument(
        "--init_method",
        help="Coordinator address for multi-host init.",
        default="tcp://localhost:9999",
        type=str,
    )
    parser.add_argument(
        "--cfg",
        dest="cfg_file",
        help="Path to the config file",
        default=None,
        type=str,
    )
    parser.add_argument(
        "opts",
        help="See svit_tpu_torch/config/defaults.py for all options",
        default=None,
        nargs=argparse.REMAINDER,
    )
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        parser.print_help()
    return parser.parse_args(argv)


def load_config(args):
    """Build a config from defaults + file + CLI overrides."""
    cfg = get_cfg()
    if getattr(args, "cfg_file", None) is not None:
        cfg.merge_from_file(args.cfg_file)
    if getattr(args, "opts", None):
        cfg.merge_from_list(args.opts)

    if hasattr(args, "num_shards") and hasattr(args, "shard_id"):
        cfg.NUM_SHARDS = args.num_shards
        cfg.SHARD_ID = args.shard_id
    if hasattr(args, "init_method"):
        cfg.INIT_METHOD = args.init_method

    return cfg
