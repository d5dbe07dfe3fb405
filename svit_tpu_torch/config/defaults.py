"""Default config tree.

Key schema preserves the reference's public contract
(``slowfast/config/defaults.py``): every key consumed by ``configs/ssv2.yaml``
and the engines exists here with the same name and default, so YAML configs and
``KEY VALUE`` CLI overrides written for the reference work unchanged.  A new
``TPU`` section holds the TPU-native knobs (mesh shape, dtypes, pallas flags)
that have no reference counterpart.

The PyTorch port keeps the same tree, so every config the JAX package reads
loads here unchanged.  In the port ``TPU.COMPUTE_DTYPE`` keeps its meaning
(the activation and matmul dtype under ``TRAIN.MIXED_PRECISION``) and
``TPU.USE_PALLAS_ATTENTION`` means "run the forward through the hand-written
CUDA kernels" (``svit_tpu_torch/csrc``).
"""

from svit_tpu_torch.config.cfg_node import CfgNode

_C = CfgNode()

_C.DEBUG = False
_C.DDP_FIND_UNUSED_PARAMETERS = False  # accepted for compat; no-op on TPU

# ---------------------------------------------------------------------------
# SViT object-token options (reference defaults.py:20-28)
# ---------------------------------------------------------------------------
_C.SVIT = CfgNode()
_C.SVIT.O = 4                 # number of object tokens per frame (2 hands + 2 objects)
_C.SVIT.LAMBDA_NODES = 1.0    # HAOG box-loss weight
_C.SVIT.LAMBDA_EDGES = 1.0    # contact-state loss weight
_C.SVIT.LAMBDA_CON = 1.0      # frame-clip consistency weight
# '' | 'l1' | 'l2' — actually weight the frame-clip consistency term.  The
# reference's lambda wiring leaves it inert (misc.py:412-423 adds a key no
# loss emits); '' reproduces that shipped behavior.
_C.SVIT.CONSISTENCY_LOSS = ""

# ---------------------------------------------------------------------------
# BatchNorm (legacy; SViT uses LayerNorm, kept for config compat)
# ---------------------------------------------------------------------------
_C.BN = CfgNode()
_C.BN.USE_PRECISE_STATS = False
_C.BN.NUM_BATCHES_PRECISE = 200
_C.BN.WEIGHT_DECAY = 0.0
_C.BN.NORM_TYPE = "batchnorm"
_C.BN.NUM_SPLITS = 1
_C.BN.NUM_SYNC_DEVICES = 1

# ---------------------------------------------------------------------------
# Heterogeneous image-rank training (reference defaults.py:59-68)
# On TPU the rank split becomes a weighted joint step: see engine/train.py.
# ---------------------------------------------------------------------------
_C.IMAGE_TRAIN = CfgNode()
_C.IMAGE_TRAIN.BATCH_SIZE = 63
_C.IMAGE_TRAIN.GPU_IDS = [7]       # reference rank ids; used only for the loss ratio
_C.IMAGE_TRAIN.DATASETS = ["ssv2_frames"]

# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
_C.TRAIN = CfgNode()
_C.TRAIN.ENABLE = True
_C.TRAIN.ENABLE_DOH = False
_C.TRAIN.DATASET = "kinetics"
_C.TRAIN.BATCH_SIZE = 63
_C.TRAIN.EVAL_PERIOD = 10
_C.TRAIN.CHECKPOINT_PERIOD = 10
_C.TRAIN.AUTO_RESUME = True
_C.TRAIN.CHECKPOINT_FILE_PATH = ""
_C.TRAIN.CHECKPOINT_TYPE = "pytorch"
_C.TRAIN.CHECKPOINT_INFLATE = False
_C.TRAIN.CHECKPOINT_EPOCH_RESET = False
_C.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = []
_C.TRAIN.CHECKPOINT_REPLACE_NAME_PATTERN = []
_C.TRAIN.MIXED_PRECISION = False   # bf16 compute on TPU (no loss scaling needed)
_C.TRAIN.FORWARD_VIDEO_FRAMES = True
_C.TRAIN.VAL_ONLY = False

# ---------------------------------------------------------------------------
# RandAugment / erasing (timm-style; reference defaults.py:123-152)
# ---------------------------------------------------------------------------
_C.AUG = CfgNode()
_C.AUG.ENABLE = False
_C.AUG.NUM_SAMPLE = 1
_C.AUG.COLOR_JITTER = 0.4
_C.AUG.AA_TYPE = "rand-m9-mstd0.5-inc1"
_C.AUG.INTERPOLATION = "bicubic"
_C.AUG.RE_PROB = 0.25
_C.AUG.RE_MODE = "pixel"
_C.AUG.RE_COUNT = 1
_C.AUG.RE_SPLIT = False

# ---------------------------------------------------------------------------
# MixUp / CutMix (reference defaults.py:157-175; OFF in ssv2.yaml)
# ---------------------------------------------------------------------------
_C.MIXUP = CfgNode()
_C.MIXUP.ENABLE = False
_C.MIXUP.ALPHA = 0.8
_C.MIXUP.CUTMIX_ALPHA = 1.0
_C.MIXUP.PROB = 1.0
_C.MIXUP.SWITCH_PROB = 0.5
_C.MIXUP.LABEL_SMOOTH_VALUE = 0.1

# ---------------------------------------------------------------------------
# Multi-view testing (reference defaults.py:180-205)
# ---------------------------------------------------------------------------
_C.TEST = CfgNode()
_C.TEST.ENABLE = True
_C.TEST.DATASET = "kinetics"
_C.TEST.BATCH_SIZE = 8
_C.TEST.CHECKPOINT_FILE_PATH = ""
_C.TEST.NUM_ENSEMBLE_VIEWS = 10
_C.TEST.NUM_SPATIAL_CROPS = 3
_C.TEST.CHECKPOINT_TYPE = "pytorch"
_C.TEST.SAVE_RESULTS_PATH = ""

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
_C.MODEL = CfgNode()
_C.MODEL.ARCH = "slowfast"
_C.MODEL.MODEL_NAME = "SlowFast"
_C.MODEL.NUM_CLASSES = 400
_C.MODEL.LOSS_FUNC = "cross_entropy"
_C.MODEL.SINGLE_PATHWAY_ARCH = ["2d", "c2d", "i3d", "slow", "x3d", "mvit"]
_C.MODEL.MULTI_PATHWAY_ARCH = ["slowfast"]
_C.MODEL.DROPOUT_RATE = 0.5
_C.MODEL.DROPCONNECT_RATE = 0.0
_C.MODEL.FC_INIT_STD = 0.01
_C.MODEL.HEAD_ACT = "softmax"
_C.MODEL.ACT_CHECKPOINT = False
_C.MODEL.LOAD_IN_PRETRAIN = ""
_C.MODEL.ROI_HEAD_ACT_DURING_TRAINING = False

# ---------------------------------------------------------------------------
# MViTv2 backbone hyperparameters (reference defaults.py:345-471)
# ---------------------------------------------------------------------------
_C.MVIT = CfgNode()
_C.MVIT.USE_MLP = False
_C.MVIT.MODE = "conv"
_C.MVIT.POOL_FIRST = False
_C.MVIT.CLS_EMBED_ON = True
_C.MVIT.PATCH_KERNEL = [3, 7, 7]
_C.MVIT.PATCH_STRIDE = [2, 4, 4]
_C.MVIT.PATCH_PADDING = [2, 4, 4]
_C.MVIT.PATCH_2D = False
_C.MVIT.EMBED_DIM = 96
_C.MVIT.NUM_HEADS = 1
_C.MVIT.MLP_RATIO = 4.0
_C.MVIT.QKV_BIAS = True
_C.MVIT.DROPPATH_RATE = 0.1
_C.MVIT.LAYER_SCALE_INIT_VALUE = 0.0
_C.MVIT.DEPTH = 16
_C.MVIT.NORM = "layernorm"
_C.MVIT.DIM_MUL = []
_C.MVIT.HEAD_MUL = []
_C.MVIT.POOL_KV_STRIDE = None
_C.MVIT.POOL_KV_STRIDE_ADAPTIVE = None
_C.MVIT.POOL_Q_STRIDE = []
_C.MVIT.POOL_KVQ_KERNEL = None
_C.MVIT.ZERO_DECAY_POS_CLS = True
_C.MVIT.NORM_STEM = False
_C.MVIT.SEP_POS_EMBED = False
_C.MVIT.DROPOUT_RATE = 0.0
_C.MVIT.POOL_KV_IGNORE_111_KERNEL = False
_C.MVIT.IMAGE_KERNEL_FULL_PAD = False
_C.MVIT.OBJECTS_MASKING = False
_C.MVIT.REL_POS_ZERO_INIT = False
_C.MVIT.RESIDUAL_POOLING = True
_C.MVIT.DIM_MUL_IN_ATT = True
_C.MVIT.ACT_CHECKPOINT = False
_C.MVIT.PATCH_AVG_TEMP = -1
_C.MVIT.USE_ABS_POS = True
_C.MVIT.REL_POS_SPATIAL = False
_C.MVIT.REL_POS_TEMPORAL = False
_C.MVIT.SEPARATE_QKV = False
_C.MVIT.HEAD_INIT_SCALE = 1.0
_C.MVIT.USE_MEAN_POOLING = False
_C.MVIT.USE_FIXED_SINCOS_POS = False

# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
_C.DATA = CfgNode()
_C.DATA.PATH_TO_DATA_DIR = ""
_C.DATA.PATH_LABEL_SEPARATOR = " "
_C.DATA.PATH_PREFIX = ""
_C.DATA.NUM_FRAMES = 8
_C.DATA.SAMPLING_RATE = 8
_C.DATA.TRAIN_PCA_EIGVAL = [0.225, 0.224, 0.229]
_C.DATA.TRAIN_PCA_EIGVEC = [
    [-0.5675, 0.7192, 0.4009],
    [-0.5808, -0.0045, -0.8140],
    [-0.5836, -0.6948, 0.4203],
]
_C.DATA.PATH_TO_PRELOAD_IMDB = ""
_C.DATA.MEAN = [0.45, 0.45, 0.45]
_C.DATA.INPUT_CHANNEL_NUM = [3, 3]
_C.DATA.STD = [0.225, 0.225, 0.225]
_C.DATA.TRAIN_JITTER_SCALES = [256, 320]
_C.DATA.TRAIN_JITTER_SCALES_RELATIVE = []
_C.DATA.TRAIN_JITTER_ASPECT_RELATIVE = []
_C.DATA.USE_OFFSET_SAMPLING = False
_C.DATA.TRAIN_JITTER_MOTION_SHIFT = False
_C.DATA.TRAIN_CROP_SIZE = 224
_C.DATA.TEST_CROP_SIZE = 256
_C.DATA.TARGET_FPS = 30
_C.DATA.DECODING_BACKEND = "pyav"
_C.DATA.INV_UNIFORM_SAMPLE = False
_C.DATA.RANDOM_FLIP = True
_C.DATA.MULTI_LABEL = False
_C.DATA.ENSEMBLE_METHOD = "sum"
_C.DATA.REVERSE_INPUT_CHANNEL = False
_C.DATA.TARGET_RES = [28, 28]

# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------
_C.SOLVER = CfgNode()
_C.SOLVER.BASE_LR = 0.1
_C.SOLVER.LR_POLICY = "cosine"
_C.SOLVER.COSINE_END_LR = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEP_SIZE = 1
_C.SOLVER.STEPS = []
_C.SOLVER.LRS = []
_C.SOLVER.MAX_EPOCH = 300
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.DAMPENING = 0.0
_C.SOLVER.NESTEROV = True
_C.SOLVER.WEIGHT_DECAY = 1e-4
_C.SOLVER.WARMUP_FACTOR = 0.1
_C.SOLVER.WARMUP_EPOCHS = 0.0
_C.SOLVER.WARMUP_START_LR = 0.01
_C.SOLVER.OPTIMIZING_METHOD = "sgd"
_C.SOLVER.BASE_LR_SCALE_NUM_SHARDS = False
_C.SOLVER.COSINE_AFTER_WARMUP = False
_C.SOLVER.ZERO_WD_1D_PARAM = False
_C.SOLVER.CLIP_GRAD_VAL = None
_C.SOLVER.CLIP_GRAD_L2NORM = None

# ---------------------------------------------------------------------------
# Runtime / launcher
# ---------------------------------------------------------------------------
_C.NUM_GPUS = 1          # reference name kept: number of devices (TPU chips)
_C.CUDA_VISIBLE_DEVICES = ""
_C.NUM_SHARDS = 1        # number of hosts
_C.SHARD_ID = 0
_C.OUTPUT_DIR = "./tmp"
_C.RNG_SEED = 1
_C.LOG_PERIOD = 10
_C.LOG_MODEL_INFO = False
_C.DIST_BACKEND = "nccl"  # accepted for compat; TPU uses XLA collectives
_C.INIT_METHOD = "tcp://localhost:9999"

# ---------------------------------------------------------------------------
# Data-loading benchmark (tools/benchmark.py)
# ---------------------------------------------------------------------------
_C.BENCHMARK = CfgNode()
_C.BENCHMARK.NUM_EPOCHS = 5
_C.BENCHMARK.LOG_PERIOD = 100
_C.BENCHMARK.SHUFFLE = True

_C.DATA_LOADER = CfgNode()
_C.DATA_LOADER.NUM_WORKERS = 8
_C.DATA_LOADER.NUM_WORKERS_VAL = -1
_C.DATA_LOADER.PIN_MEMORY = True
_C.DATA_LOADER.ENABLE_MULTI_THREAD_DECODE = False
_C.DATA_LOADER.PERSISTENT_WORKERS = False
_C.DATA_LOADER.PERSISTENT_WORKERS_TRAIN = False
# Process-pool workers for the train loaders (decode + augment release the
# GIL poorly under threads); each worker holds its own dataset instance and
# tasks ship only indices.  Threads remain the val/test default.
_C.DATA_LOADER.USE_PROCESSES = True

# ---------------------------------------------------------------------------
# Detection head (reference has it but its import is broken; kept for compat)
# ---------------------------------------------------------------------------
_C.DETECTION = CfgNode()
_C.DETECTION.ENABLE = False
_C.DETECTION.ALIGNED = True
_C.DETECTION.SPATIAL_SCALE_FACTOR = 16
_C.DETECTION.ROI_XFORM_RESOLUTION = 7

# ---------------------------------------------------------------------------
# Dataset-specific blocks
# ---------------------------------------------------------------------------
_C.SSV2 = CfgNode()
_C.SSV2.DATA_ROOT = ""
_C.SSV2.SPLIT = "compositional"

_C.DOH = CfgNode()
_C.DOH.DATA_ROOT = ""

_C.EPICKITCHENS = CfgNode()
_C.EPICKITCHENS.VISUAL_DATA_DIR = ""
_C.EPICKITCHENS.ANNOTATIONS_DIR = ""
_C.EPICKITCHENS.TRAIN_LIST = "EPIC_100_train.pkl"
_C.EPICKITCHENS.VAL_LIST = "EPIC_100_validation.pkl"
_C.EPICKITCHENS.TEST_LIST = "EPIC_100_validation.pkl"
_C.EPICKITCHENS.TEST_SPLIT = "validation"
_C.EPICKITCHENS.TRAIN_PLUS_VAL = False

# ---------------------------------------------------------------------------
# Multigrid training schedule (reference defaults.py:903-940; OFF by default)
# ---------------------------------------------------------------------------
_C.MULTIGRID = CfgNode()
_C.MULTIGRID.EPOCH_FACTOR = 1.5
_C.MULTIGRID.SHORT_CYCLE = False
_C.MULTIGRID.SHORT_CYCLE_FACTORS = [0.5, 0.5 ** 0.5]
_C.MULTIGRID.LONG_CYCLE = False
_C.MULTIGRID.LONG_CYCLE_FACTORS = [
    [0.25, 0.5 ** 0.5],
    [0.5, 0.5 ** 0.5],
    [0.5, 1.0],
    [1.0, 1.0],
]
_C.MULTIGRID.BN_BASE_SIZE = 8
_C.MULTIGRID.EVAL_FREQ = 3
_C.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = 0
_C.MULTIGRID.DEFAULT_B = 0
_C.MULTIGRID.DEFAULT_T = 0
_C.MULTIGRID.DEFAULT_S = 0

# ---------------------------------------------------------------------------
# TensorBoard
# ---------------------------------------------------------------------------
_C.TENSORBOARD = CfgNode()
_C.TENSORBOARD.ENABLE = True
_C.TENSORBOARD.PREDICTIONS_PATH = ""
_C.TENSORBOARD.LOG_DIR = ""
_C.TENSORBOARD.CLASS_NAMES_PATH = ""
_C.TENSORBOARD.CATEGORIES_PATH = ""
_C.TENSORBOARD.CONFUSION_MATRIX = CfgNode()
_C.TENSORBOARD.CONFUSION_MATRIX.ENABLE = False
_C.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE = [8, 8]
_C.TENSORBOARD.CONFUSION_MATRIX.SUBSET_PATH = ""
_C.TENSORBOARD.HISTOGRAM = CfgNode()
_C.TENSORBOARD.HISTOGRAM.ENABLE = False
_C.TENSORBOARD.HISTOGRAM.SUBSET_PATH = ""
_C.TENSORBOARD.HISTOGRAM.TOPK = 10
_C.TENSORBOARD.HISTOGRAM.FIGSIZE = [8, 8]
_C.TENSORBOARD.MODEL_VIS = CfgNode()
_C.TENSORBOARD.MODEL_VIS.ENABLE = False
_C.TENSORBOARD.MODEL_VIS.MODEL_WEIGHTS = False
_C.TENSORBOARD.MODEL_VIS.ACTIVATIONS = False
_C.TENSORBOARD.MODEL_VIS.INPUT_VIDEO = False
_C.TENSORBOARD.MODEL_VIS.LAYER_LIST = []
_C.TENSORBOARD.MODEL_VIS.TOPK_PREDS = 1
_C.TENSORBOARD.MODEL_VIS.COLORMAP = "Pastel2"
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM = CfgNode()
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM.ENABLE = True
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM.LAYER_LIST = []
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM.USE_TRUE_LABEL = False
_C.TENSORBOARD.MODEL_VIS.GRAD_CAM.COLORMAP = "viridis"
_C.TENSORBOARD.WRONG_PRED_VIS = CfgNode()
_C.TENSORBOARD.WRONG_PRED_VIS.ENABLE = False
_C.TENSORBOARD.WRONG_PRED_VIS.TAG = "Incorrectly classified videos."
_C.TENSORBOARD.WRONG_PRED_VIS.SUBSET_PATH = ""

# ---------------------------------------------------------------------------
# Demo
# ---------------------------------------------------------------------------
_C.DEMO = CfgNode()
_C.DEMO.ENABLE = False
_C.DEMO.LABEL_FILE_PATH = ""
_C.DEMO.WEBCAM = -1
_C.DEMO.INPUT_VIDEO = ""
_C.DEMO.DISPLAY_WIDTH = 0
_C.DEMO.DISPLAY_HEIGHT = 0
_C.DEMO.DETECTRON2_CFG = ""
_C.DEMO.DETECTRON2_WEIGHTS = ""
_C.DEMO.DETECTRON2_THRESH = 0.9
_C.DEMO.BUFFER_SIZE = 0
_C.DEMO.OUTPUT_FILE = ""
_C.DEMO.OUTPUT_FPS = -1
_C.DEMO.INPUT_FORMAT = "BGR"
_C.DEMO.CLIP_VIS_SIZE = 10
_C.DEMO.NUM_VIS_INSTANCES = 2
_C.DEMO.PREDS_BOXES = ""
_C.DEMO.THREAD_ENABLE = False
_C.DEMO.NUM_CLIPS_SKIP = 0
_C.DEMO.GT_BOXES = ""
_C.DEMO.STARTING_SECOND = 900
_C.DEMO.FPS = 30
_C.DEMO.VIS_MODE = "thres"
_C.DEMO.COMMON_CLASS_THRES = 0.7
_C.DEMO.UNCOMMON_CLASS_THRES = 0.3
_C.DEMO.COMMON_CLASS_NAMES = []
_C.DEMO.SLOWMO = 1

# ---------------------------------------------------------------------------
# TPU-native knobs (no reference counterpart)
# ---------------------------------------------------------------------------
_C.TPU = CfgNode()
_C.TPU.MESH_DATA = -1           # data-parallel mesh size; -1 = all devices
_C.TPU.MESH_MODEL = 1           # tensor-parallel mesh size (MLP/QKV sharding)
_C.TPU.COMPUTE_DTYPE = "bfloat16"   # activations/matmul dtype under jit
_C.TPU.PARAM_DTYPE = "float32"      # master weights
_C.TPU.USE_PALLAS_ATTENTION = True  # fused pooled-attention kernel where legal
_C.TPU.REMAT = False            # jax.checkpoint each block (memory for FLOPs)
_C.TPU.PREFETCH_DEPTH = 2       # host->device pipeline depth
_C.TPU.PROFILE_DIR = ""         # jax.profiler trace output ("" = disabled)
# Device-side training augmentation (svit_tpu/data/device_aug.py): the host
# ships raw uint8 frames (canonical RAW_SIZE square) and the train step runs
# crop/flip/shear/rotate/photometric/erasing/normalize on the accelerator.
# Policy-equivalent to (not bit-identical with) the host PIL pipeline.
_C.TPU.DEVICE_AUG = False
_C.TPU.RAW_SIZE = 320
# Accuracy-parity guard: the device-aug policy approximates the reference's
# PIL/imgaug distribution (no posterize/equalize/color ops, one composed
# affine).  A run that targets reference-accuracy parity must keep the host
# pipeline; with PARITY_STRICT=True, enabling DEVICE_AUG is a hard error
# (otherwise a loud warning).
_C.TPU.PARITY_STRICT = False


def get_cfg() -> CfgNode:
    """Return a fresh mutable copy of the default config."""
    return _C.clone()


def assert_and_infer_cfg(cfg: CfgNode) -> CfgNode:
    """Validate the config and derive dependent values.

    Mirrors reference ``assert_and_infer_cfg`` (defaults.py:1135-1166):
    batch divisibility checked separately for video vs image ranks, LR scaled
    by NUM_SHARDS, and ``SVIT.O == 4`` asserted (the HAOG head hardcodes the
    2-hands + 2-objects layout).
    """
    if cfg.TRAIN.ENABLE:
        assert cfg.TRAIN.BATCH_SIZE % max(num_video_ranks(cfg), 1) == 0, (
            f"TRAIN.BATCH_SIZE {cfg.TRAIN.BATCH_SIZE} not divisible by "
            f"{num_video_ranks(cfg)} video ranks"
        )
        if num_image_ranks(cfg) > 0:
            assert cfg.IMAGE_TRAIN.BATCH_SIZE % num_image_ranks(cfg) == 0, (
                f"IMAGE_TRAIN.BATCH_SIZE {cfg.IMAGE_TRAIN.BATCH_SIZE} not "
                f"divisible by {num_image_ranks(cfg)} image ranks"
            )
    if cfg.TEST.ENABLE:
        assert cfg.TEST.BATCH_SIZE % max(cfg.NUM_GPUS, 1) == 0

    assert cfg.SOLVER.CLIP_GRAD_VAL is None or cfg.SOLVER.CLIP_GRAD_L2NORM is None

    if cfg.SOLVER.BASE_LR_SCALE_NUM_SHARDS:
        cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * cfg.NUM_SHARDS

    assert cfg.SVIT.O == 4, "HAOG head assumes O == 4 (2 hands + 2 objects)"
    assert cfg.MVIT.NORM == "layernorm", "Only layernorm is supported"

    if cfg.TPU.DEVICE_AUG:
        msg = (
            "TPU.DEVICE_AUG uses an approximate augmentation policy "
            "(svit_tpu/data/device_aug.py) — not distribution-identical to "
            "the reference host pipeline; do not use it for an "
            "accuracy-parity run"
        )
        if cfg.TPU.PARITY_STRICT:
            raise ValueError(msg + " (TPU.PARITY_STRICT=True)")
        import logging

        logging.getLogger(__name__).warning(msg)
    return cfg


def num_image_ranks(cfg) -> int:
    """Number of reference ranks devoted to the image task."""
    ids = [g for g in cfg.IMAGE_TRAIN.GPU_IDS if g < cfg.NUM_GPUS]
    return len(ids)


def num_video_ranks(cfg) -> int:
    return cfg.NUM_GPUS - num_image_ranks(cfg)
