"""Default configuration tree (the port's own copy of the JAX package's).

Key-for-key mirror of the reference defaults (lib/config/default.py:17-257
and the EXTRA presets in lib/config/models.py) so the reference's 69
``experiments/**/*.yaml`` files load unchanged.  TPU-specific knobs live
under ``TPU.*`` and default to sensible values (bf16 compute, data-parallel
mesh over every local device).
"""

from __future__ import annotations

from .node import ConfigNode


def default_config() -> ConfigNode:
    c = ConfigNode()

    # run / environment (reference default.py:18-38)
    c.EXP_NAME = ""
    c.OUTPUT_DIR = ""
    c.LOG_DIR = ""
    c.DATA_DIR = ""
    c.DISTRIBUTED = False
    c.GPUS = [0]                     # kept for YAML parity
    c.WORKERS = 4
    c.PRINT_FREQ = 20
    c.AUTO_RESUME = False
    c.PIN_MEMORY = True
    c.RANK = 0
    c.VERBOSE = True
    c.DIST_BACKEND = "nccl"          # parity only; comms are XLA collectives
    c.MULTIPROCESSING_DISTRIBUTED = False
    c.WITHOUT_EVAL = False
    c.WITH_DATA_AUG = False

    c.FP16 = ConfigNode(dict(
        ENABLED=False,               # parity knob; TPU path uses bf16 natively
        STATIC_LOSS_SCALE=1.0,
        DYNAMIC_LOSS_SCALE=True,
    ))

    c.CUDNN = ConfigNode(dict(BENCHMARK=True, DETERMINISTIC=False, ENABLED=True))

    # model (reference default.py:47-125)
    m = ConfigNode()
    m.NAME = "pose_hrnet"
    m.INIT_WEIGHTS = True
    m.PRETRAINED = ""
    m.TEMPORAL_PRETRAINED = ""
    m.HRNET_PRETRAINED = ""
    m.NUM_JOINTS = 21
    m.TAG_PER_JOINT = True
    m.TARGET_TYPE = "gaussian"
    m.IMAGE_SIZE = [256, 256]
    m.HEATMAP_SIZE = [64, 64]
    m.SIGMA = 2
    m.EXTRA = ConfigNode(new_allowed=True)
    m.SYNC_BN = False
    # Pred-RNN
    m.N_HIDDEN = [64, 64, 64, 64]
    m.STRIDE = 1
    m.FILTER_SIZE = 5
    m.LAYER_NORM = 1
    # HRNet_EMB_TCN
    m.EMBEDDING_SIZE = 512
    m.TCN_CHANNELS = 1024
    m.FILTER_WIDTHS = [3, 3, 3, 3]
    # learnable triangulation
    m.TRIANGULATION_MODEL_NAME = "alg"
    m.BACKBONE_NAME = "pose_hrnet_volumetric"
    m.BACKBONE_MODEL_PATH = ""
    m.CUBOID_SIZE = 500.0
    m.VOLUME_SIZE = 64
    m.SCALE_KEYPOINTS_3D = 0.1
    m.HEATMAP_SOFTMAX = False
    m.TRAINABLE_SOFTMAX = False
    m.VOLUME_MULTIPLIER = 1.0
    m.VOLUME_SOFTMAX = True
    m.VOLUME_AGGREGATION_METHOD = "softmax"
    m.USE_GT_MIDDLEROOT = True
    m.ALG_CONFIDENCES = False
    m.VOL_CONFIDENCES = True
    m.DIRECT_OPTIMIZATION = False
    # GAN
    m.N_CRITIC = 3
    m.CLIP_VALUE = 0.01
    # multiview_pose_hrnet
    m.AGGRE = True
    # PoseAggr
    m.DILATION_RATES = [3, 6, 12, 18, 24]
    m.USE_WARPING_TRAIN = True
    m.USE_WARPING_TEST = True
    # attention
    m.PATCH_SIZE = 4
    m.EMB_DIM = [96]
    m.DROP_RATE = 0.0
    m.DROP_PATH_RATE = 0.0
    # swin
    m.DEPTHS = [2, 2, 6, 2]
    m.NUM_HEADS = [3, 6, 12, 24]
    m.ABSOLUTE_POSITION_ENCODING = False
    m.FF_TYPE = "mlp"
    # hamburger
    m.VERSION = "V2+"
    m.HAM_TYPE = "NMF"
    m.S = 1
    m.R = 64
    m.DUAL_HAM = False
    m.SPATIAL = True
    m.CHEESE_FACTOR = 1
    m.ZERO_HAM = True
    m.TRAIN_STEPS = 6
    m.EVAL_STEPS = 7
    m.INV_T = 100
    m.ETA = 0.9
    m.RAND_INIT = True
    m.BETA = 0.1
    # RVT
    m.USE_MASK = False
    m.MAKSED_BLOCKS = 0
    c.MODEL = m

    # losses (reference default.py:127-158)
    l = ConfigNode()
    l.USE_OHKM = False
    l.TOPK = 8
    l.USE_TARGET_WEIGHT = True
    l.USE_DIFFERENT_JOINTS_WEIGHT = False
    l.WITH_HEATMAP_LOSS = True
    l.HEATMAP_LOSS_FACTOR = 1.0
    l.WITH_POSE2D_LOSS = False
    l.POSE2D_LOSS_FACTOR = 1.0
    l.WITH_POSE3D_LOSS = True
    l.POSE3D_LOSS_FACTOR = 1.0
    l.WITH_TIME_CONSISTENCY_LOSS = False
    l.TIME_CONSISTENCY_LOSS_FACTOR = 1.0
    l.WITH_BONE_LOSS = False
    l.BONE_LOSS_FACTOR = 1.0
    l.WITH_JOINTANGLE_LOSS = False
    l.JOINTANGLE_LOSS_FACTOR = 1.0
    l.WITH_VOLUMETRIC_CE_LOSS = False
    l.VOLUMETRIC_LOSS_FACTOR = 0.01
    l.WITH_KCS_LOSS = False
    l.KCS_LOSS_FACTOR = 0.01
    l.WITH_KCS_TC_LOSS = False
    l.KCS_TC_LOSS_FACTOR = 0.01
    c.LOSS = l

    # dataset (reference default.py:160-200)
    d = ConfigNode()
    d.ROOT = ""
    d.BACKGROUND_DIR = ""
    d.DATASET = []
    d.TEST_DATASET = []
    d.TRAIN_SET = "training"
    d.TEST_SET = "evaluation"
    d.DATA_FORMAT = "jpg"
    d.HYBRID_JOINTS_TYPE = ""
    d.SELECT_DATA = False
    d.NUM_VIEWS = 4
    d.SEQ_IDX = [-2, -1, 0, 1, 2]
    d.STRIDE = 2
    d.NUM_JOINTS = 21
    d.INPUT_SIZE = 256
    d.OUTPUT_SIZE = [64]
    d.MAX_ROTATION = 30
    d.MIN_SCALE = 0.75
    d.MAX_SCALE = 1.25
    d.SCALE_TYPE = "short"
    d.MAX_TRANSLATE = 40
    d.FLIP = False
    d.SCALE_FACTOR = 0.25
    d.ROT_FACTOR = 30
    d.PROB_HALF_BODY = 0.0
    d.NUM_JOINTS_HALF_BODY = 8
    d.COLOR_RGB = False
    d.SIGMA = 2
    d.SCALE_AWARE_SIGMA = False
    d.BASE_SIZE = 256.0
    d.BASE_SIGMA = 2.0
    d.INT_SIGMA = False
    d.N_FRAMES = 1
    d.FRAME_STRIDE = 1
    d.SAMPLE_STRIDE = 10
    c.DATASET = d

    # train (reference default.py:202-227)
    t = ConfigNode()
    t.LR_FACTOR = 0.1
    t.LR_STEP = [3, 6]
    t.LR = 0.001
    t.LR_SCHEDULE = "multi_step"
    t.WARMUP_EPOCHS = 10
    t.PROCESS_FEATURE_LR = 0.001
    t.VOLUME_NET_LR = 0.001
    t.OPTIMIZER = "adam"
    t.BN_MOMENTUM = 3e-4
    t.MOMENTUM = 0.9
    t.WD = 0.0001
    t.NESTEROV = False
    t.GAMMA1 = 0.99
    t.GAMMA2 = 0.0
    t.BEGIN_EPOCH = 0
    t.END_EPOCH = 140
    t.RESUME = False
    t.CHECKPOINT = ""
    t.IMAGES_PER_GPU = 32
    t.SHUFFLE = True
    c.TRAIN = t

    # test (reference default.py:230-249)
    te = ConfigNode()
    te.IMAGES_PER_GPU = 32
    te.FLIP_TEST = False
    te.POST_PROCESS = False
    te.SHIFT_HEATMAP = False
    te.USE_GT_BBOX = False
    te.IMAGE_THRE = 0.1
    te.NMS_THRE = 0.6
    te.SOFT_NMS = False
    te.OKS_THRE = 0.5
    te.IN_VIS_THRE = 0.0
    te.COCO_BBOX_FILE = ""
    te.BBOX_THRE = 1.0
    te.MODEL_FILE = ""
    c.TEST = te

    # debug (reference default.py:252-257)
    c.DEBUG = ConfigNode(dict(
        DEBUG=False,
        SAVE_BATCH_IMAGES_GT=False,
        SAVE_BATCH_IMAGES_PRED=False,
        SAVE_HEATMAPS_GT=False,
        SAVE_HEATMAPS_PRED=False,
    ))

    # TPU-native knobs (no reference counterpart)
    tpu = ConfigNode()
    tpu.COMPUTE_DTYPE = "bfloat16"     # activations/conv compute dtype
    tpu.PARAM_DTYPE = "float32"        # parameter/optimizer dtype
    tpu.MESH_AXES = ["data"]           # mesh axis names for the train step
    tpu.MESH_SHAPE = []                # [] -> all local devices on axis 0
    tpu.REMAT = False                  # jax.checkpoint the backbone stages
    tpu.PREFETCH = 2                   # device-prefetch depth for input batches
    # train steps fused per dispatch (lax.scan over pre-staged batches);
    # >1 amortizes host->device dispatch latency, same motivation as the
    # reference's DataPrefetcher (lib/dataset/build.py:8-40) on CUDA streams
    tpu.STEPS_PER_DISPATCH = 1
    # train-mode BN statistics levers (models/layers.py set_bn_levers):
    # BN_STAT_SAMPLES=n computes batch statistics over the first n samples
    # only (ghost-BN-style subsampling — noisier stats, B/n less stat-pass
    # HBM traffic; running averages follow the subsample).  BN_STAT_DTYPE
    # ("bfloat16") accumulates the mean/var reductions in bf16.  Both
    # default OFF: the standard flax BatchNorm path, numerically unchanged.
    # Measured impact at B=128 on w32@256 is recorded in PERF.md round 4.
    tpu.BN_STAT_SAMPLES = 0
    tpu.BN_STAT_DTYPE = ""
    tpu.SEED = 0
    # anomaly guard (the reference trains under
    # torch.autograd.set_detect_anomaly(True), tools/train.py:335): when on,
    # non-finite gradients SKIP the optimizer update and are reported in the
    # step metrics as 'nonfinite_grads'
    tpu.DETECT_ANOMALY = True
    c.TPU = tpu

    return c


# HRNet stage presets matching reference lib/config/models.py:26-60 — used when
# an experiment YAML omits MODEL.EXTRA (none of the shipped ones do, but the
# presets are part of the reference API surface).
POSE_HIGH_RESOLUTION_NET_EXTRA = dict(
    PRETRAINED_LAYERS=["*"],
    STEM_INPLANES=64,
    FINAL_CONV_KERNEL=1,
    STAGE2=dict(NUM_MODULES=1, NUM_BRANCHES=2, NUM_BLOCKS=[4, 4],
                NUM_CHANNELS=[32, 64], BLOCK="BASIC", FUSE_METHOD="SUM"),
    STAGE3=dict(NUM_MODULES=4, NUM_BRANCHES=3, NUM_BLOCKS=[4, 4, 4],
                NUM_CHANNELS=[32, 64, 128], BLOCK="BASIC", FUSE_METHOD="SUM"),
    STAGE4=dict(NUM_MODULES=3, NUM_BRANCHES=4, NUM_BLOCKS=[4, 4, 4, 4],
                NUM_CHANNELS=[32, 64, 128, 256], BLOCK="BASIC", FUSE_METHOD="SUM"),
)

POSE_RESNET_EXTRA = dict(
    NUM_LAYERS=50,
    DECONV_WITH_BIAS=False,
    NUM_DECONV_LAYERS=3,
    NUM_DECONV_FILTERS=[256, 256, 256],
    NUM_DECONV_KERNELS=[4, 4, 4],
    FINAL_CONV_KERNEL=1,
)
