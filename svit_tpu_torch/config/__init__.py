from svit_tpu_torch.config.cfg_node import CfgNode  # noqa: F401
from svit_tpu_torch.config.defaults import (  # noqa: F401
    assert_and_infer_cfg,
    get_cfg,
    num_image_ranks,
    num_video_ranks,
)
from svit_tpu_torch.config.parser import load_config, parse_args  # noqa: F401
