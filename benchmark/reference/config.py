"""Config schema of the port: yacs-style nested AttrDict with YAML and
`KEY VALUE` overrides.

The port's own copy of the JAX package's schema (cpm_tpu/config.py): the
same sections, keys and defaults, the same precedence (defaults -> YAML ->
trailing `KEY VALUE` pairs), the same strict unknown-key errors and
literal-eval coercion, so the shipped YAML configs drive both packages. The
port imports nothing of the JAX package; tests/test_torch_isolation.py holds
the two default trees equal key for key.

The `TPU.*` keys stay valid. `TPU.COMPUTE_DTYPE`, `TPU.DEVICE_NORMALIZE`,
`TPU.EVAL_POOLER_DTYPE` and `TPU.TOWER_BUCKETS` keep their meaning on the
GPU; the rest describe TPU layouts and are accepted and ignored (see
`modeling/model.py`). PyYAML is imported inside `merge_cfg_from_file`, so
the schema imports where it is not installed.
"""

import ast
import copy
import os
import types

import numpy as np


class AttrDict(dict):
    """dict with attribute access and an immutability latch."""

    IMMUTABLE = "__immutable__"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__[AttrDict.IMMUTABLE] = False

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if self.__dict__[AttrDict.IMMUTABLE]:
            raise AttributeError(
                f"AttrDict is immutable; cannot set {name}={value!r}"
            )
        self[name] = value

    def immutable(self, is_immutable):
        self.__dict__[AttrDict.IMMUTABLE] = is_immutable
        for v in self.values():
            if isinstance(v, AttrDict):
                v.immutable(is_immutable)

    def is_immutable(self):
        return self.__dict__[AttrDict.IMMUTABLE]


def _new_defaults():
    """Build the full default config tree."""
    C = AttrDict()

    # ---- Top level ----
    C.DEVICE = "tpu"
    C.NUM_GPUS = 1  # kept for config compat; means "number of data-parallel chips"
    C.PIXEL_MEANS = [102.9801, 115.9465, 122.7717]  # BGR caffe means
    C.PIXEL_STDS = [1.0, 1.0, 1.0]
    C.CKPT = "ckpts/rcnn/mscoco/e2e_faster_rcnn_R-50-FPN_1x"
    C.DISPLAY_ITER = 20
    C.ROOT_DIR = os.getcwd()
    C.DATA_DIR = os.path.join(os.getcwd(), "data")
    C.EPS = 1e-14
    C.TO_BGR255 = True
    C.SEED = 0

    # ---- MODEL ----
    C.MODEL = AttrDict()
    C.MODEL.TYPE = "generalized_rcnn"
    C.MODEL.FPN_ON = False
    C.MODEL.FASTER_RCNN = True
    C.MODEL.GRID_ON = False
    C.MODEL.CASCADE_ON = False
    C.MODEL.MASK_ON = False
    C.MODEL.RPN_ONLY = False
    C.MODEL.BATCH_NORM = "freeze"
    C.MODEL.NUM_CLASSES = -1
    C.MODEL.CLS_AGNOSTIC_BBOX_REG = False
    C.MODEL.CONV1_RGB2BGR = True
    C.MODEL.INIT_SCHEME = "reference"

    # ---- SOLVER ----
    C.SOLVER = AttrDict()
    C.SOLVER.OPTIMIZER = "SGD"
    C.SOLVER.BASE_LR = 0.001
    C.SOLVER.MAX_ITER = 90000
    C.SOLVER.MOMENTUM = 0.9
    C.SOLVER.WEIGHT_DECAY = 0.0005
    C.SOLVER.WEIGHT_DECAY_GN = 0.0
    C.SOLVER.BIAS_DOUBLE_LR = True
    C.SOLVER.BIAS_WEIGHT_DECAY = False
    C.SOLVER.LR_MULTIPLE = 1.0
    C.SOLVER.WARM_UP_ITERS = 500
    C.SOLVER.WARM_UP_FACTOR = 1.0 / 10.0
    C.SOLVER.WARM_UP_METHOD = "LINEAR"
    C.SOLVER.LR_POLICY = "STEP"
    C.SOLVER.LR_POW = 0.9
    C.SOLVER.STEPS = [60000, 80000]
    C.SOLVER.GAMMA = 0.1
    C.SOLVER.SNAPSHOT_ITERS = 10000

    # ---- DATALOADER ----
    C.DATALOADER = AttrDict()
    C.DATALOADER.SAMPLER_TRAIN = "DistributedSampler"
    C.DATALOADER.ASPECT_RATIO_GROUPING = True
    C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True
    C.DATALOADER.RFTSAMPLER = AttrDict()
    C.DATALOADER.RFTSAMPLER.REPEAT_THRESHOLD = 0.001
    C.DATALOADER.RFTSAMPLER.POW = 0.5
    C.DATALOADER.RFTSAMPLER.MAX_REPEAT_TIMES = 10000.0
    C.DATALOADER.RFTSAMPLER.MIN_REPEAT_TIMES = 1.0

    # ---- TRAIN ----
    C.TRAIN = AttrDict()
    C.TRAIN.WEIGHTS = ""
    C.TRAIN.DATASETS = ()
    C.TRAIN.SCALES = (600,)
    C.TRAIN.MAX_SIZE = 1000
    C.TRAIN.LOADER_THREADS = 4
    C.TRAIN.SIZE_DIVISIBILITY = 32
    C.TRAIN.BATCH_SIZE = 16
    C.TRAIN.FREEZE_CONV_BODY = False
    C.TRAIN.AUTO_RESUME = True
    C.TRAIN.BRIGHTNESS = 0.0
    C.TRAIN.CONTRAST = 0.0
    C.TRAIN.SATURATION = 0.0
    C.TRAIN.HUE = 0.0
    C.TRAIN.LEFT_RIGHT = ()
    C.TRAIN.MAX_GT_BOXES = 100

    # ---- TEST ----
    C.TEST = AttrDict()
    C.TEST.WEIGHTS = ""
    C.TEST.LOADER_THREADS = 4
    C.TEST.SIZE_DIVISIBILITY = 32
    C.TEST.DATASETS = ()
    C.TEST.SCALE = 600
    C.TEST.MAX_SIZE = 1000
    C.TEST.IMS_PER_GPU = 1
    C.TEST.SOFT_NMS = AttrDict()
    C.TEST.SOFT_NMS.ENABLED = False
    C.TEST.SOFT_NMS.METHOD = "linear"
    C.TEST.SOFT_NMS.SIGMA = 0.5
    C.TEST.BBOX_VOTE = AttrDict()
    C.TEST.BBOX_VOTE.ENABLED = False
    C.TEST.BBOX_VOTE.VOTE_TH = 0.8
    C.TEST.BBOX_VOTE.SCORING_METHOD = "ID"
    C.TEST.BBOX_VOTE.SCORING_METHOD_BETA = 1.0
    C.TEST.BBOX_AUG = AttrDict()
    C.TEST.BBOX_AUG.ENABLED = False
    C.TEST.BBOX_AUG.H_FLIP = False
    C.TEST.BBOX_AUG.SCALES = ()
    C.TEST.BBOX_AUG.MAX_SIZE = 4000
    C.TEST.EXPECTED_RESULTS = ()
    C.TEST.EXPECTED_RESULTS_SIGMA_TOL = 4

    # ---- BACKBONE ----
    C.BACKBONE = AttrDict()
    C.BACKBONE.CONV_BODY = "resnet"
    C.BACKBONE.BN_EPS = 1e-5

    C.BACKBONE.RESNET = AttrDict()
    C.BACKBONE.RESNET.LAYERS = (3, 4, 6, 3)
    C.BACKBONE.RESNET.WIDTH = 64
    C.BACKBONE.RESNET.BOTTLENECK = True
    C.BACKBONE.RESNET.STRIDE_3X3 = False
    C.BACKBONE.RESNET.USE_3x3x3HEAD = False
    C.BACKBONE.RESNET.USE_ALIGN = False  # AlignedBottleneck
    C.BACKBONE.RESNET.AVG_DOWN = False
    C.BACKBONE.RESNET.USE_GN = False
    C.BACKBONE.RESNET.USE_WS = False
    C.BACKBONE.RESNET.STAGE_WITH_CONTEXT = ("none", "none", "none", "none")
    C.BACKBONE.RESNET.CTX_RATIO = 0.0625
    C.BACKBONE.RESNET.STAGE_WITH_CONV = ("normal", "normal", "normal", "normal")
    C.BACKBONE.RESNET.C5_DILATION = 1
    C.BACKBONE.RESNET.FREEZE_AT = 2
    C.BACKBONE.RESNET.BASE_PLANES = 64

    C.BACKBONE.RESNEXT = AttrDict()
    C.BACKBONE.RESNEXT.LAYERS = (3, 4, 6, 3)
    C.BACKBONE.RESNEXT.C = 32
    C.BACKBONE.RESNEXT.WIDTH = 4
    C.BACKBONE.RESNEXT.USE_3x3x3HEAD = False
    C.BACKBONE.RESNEXT.USE_ALIGN = False  # AlignedBottleneck
    C.BACKBONE.RESNEXT.AVG_DOWN = False
    C.BACKBONE.RESNEXT.USE_GN = False
    C.BACKBONE.RESNEXT.USE_WS = False
    C.BACKBONE.RESNEXT.STAGE_WITH_CONTEXT = ("none", "none", "none", "none")
    C.BACKBONE.RESNEXT.CTX_RATIO = 0.0625
    C.BACKBONE.RESNEXT.STAGE_WITH_CONV = ("normal", "normal", "normal", "normal")
    C.BACKBONE.RESNEXT.C5_DILATION = 1
    C.BACKBONE.RESNEXT.FREEZE_AT = 2

    # ---- FPN ----
    C.FPN = AttrDict()
    C.FPN.BODY = "fpn"
    C.FPN.USE_C5 = True
    C.FPN.DIM = 256
    C.FPN.LOWEST_BACKBONE_LVL = 2
    C.FPN.HIGHEST_BACKBONE_LVL = 5
    C.FPN.MULTILEVEL_ROIS = True
    C.FPN.ROI_CANONICAL_SCALE = 224
    C.FPN.ROI_CANONICAL_LEVEL = 4
    C.FPN.ROI_MAX_LEVEL = 5
    C.FPN.ROI_MIN_LEVEL = 2
    C.FPN.MULTILEVEL_RPN = True
    C.FPN.RPN_MAX_LEVEL = 6
    C.FPN.RPN_MIN_LEVEL = 2
    C.FPN.EXTRA_CONV_LEVELS = False
    C.FPN.USE_BN = False
    C.FPN.USE_GN = False
    C.FPN.USE_WS = False

    C.FPN.HRFPN = AttrDict()
    C.FPN.HRFPN.DIM = 256
    C.FPN.HRFPN.POOLING_TYPE = "AVG"
    C.FPN.HRFPN.NUM_EXTRA_POOLING = 1
    C.FPN.HRFPN.USE_LITE = False
    C.FPN.HRFPN.USE_BN = False
    C.FPN.HRFPN.USE_GN = False

    C.FPN.NASFPN = AttrDict()
    C.FPN.NASFPN.NUM_STACK = 7
    C.FPN.NASFPN.DIM = 256
    C.FPN.NASFPN.USE_LITE = False
    C.FPN.NASFPN.USE_BN = False
    C.FPN.NASFPN.USE_GN = False

    C.FPN.BIFPN = AttrDict()
    C.FPN.BIFPN.NUM_STACK = 7
    C.FPN.BIFPN.DIM = 256
    C.FPN.BIFPN.EPS = 1e-4
    C.FPN.BIFPN.USE_LITE = False
    C.FPN.BIFPN.USE_BN = False
    C.FPN.BIFPN.USE_GN = False

    # ---- RPN ----
    C.RPN = AttrDict()
    C.RPN.ANCHOR_SIZES = (32, 64, 128, 256, 512)
    C.RPN.ANCHOR_STRIDE = (16,)
    C.RPN.ASPECT_RATIOS = (0.5, 1.0, 2.0)
    C.RPN.STRADDLE_THRESH = 0
    C.RPN.FG_IOU_THRESHOLD = 0.7
    C.RPN.BG_IOU_THRESHOLD = 0.3
    C.RPN.BATCH_SIZE_PER_IMAGE = 256
    C.RPN.POSITIVE_FRACTION = 0.5
    C.RPN.PRE_NMS_TOP_N_TRAIN = 12000
    C.RPN.PRE_NMS_TOP_N_TEST = 6000
    C.RPN.POST_NMS_TOP_N_TRAIN = 2000
    C.RPN.POST_NMS_TOP_N_TEST = 1000
    C.RPN.NMS_THRESH = 0.7
    C.RPN.MIN_SIZE = 0
    C.RPN.FPN_POST_NMS_TOP_N_TRAIN = 2000
    C.RPN.FPN_POST_NMS_TOP_N_TEST = 2000
    C.RPN.FPN_POST_NMS_PER_BATCH = True
    C.RPN.RPN_HEAD = "SingleConvRPNHead"
    C.RPN.SMOOTH_L1_BETA = 1.0 / 9

    # ---- FAST_RCNN ----
    C.FAST_RCNN = AttrDict()
    C.FAST_RCNN.ROI_BOX_HEAD = "roi_2mlp_head"
    C.FAST_RCNN.ROI_BOX_OUTPUT = "Box_output"
    C.FAST_RCNN.ROI_XFORM_METHOD = "ROIAlign"
    C.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO = 0
    C.FAST_RCNN.ROI_XFORM_RESOLUTION = (14, 14)
    C.FAST_RCNN.FG_IOU_THRESHOLD = 0.5
    C.FAST_RCNN.BG_IOU_THRESHOLD = 0.5
    C.FAST_RCNN.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    C.FAST_RCNN.BATCH_SIZE_PER_IMAGE = 512
    C.FAST_RCNN.POSITIVE_FRACTION = 0.25
    C.FAST_RCNN.SCORE_THRESH = 0.05
    C.FAST_RCNN.NMS = 0.5
    C.FAST_RCNN.DETECTIONS_PER_IMG = 100
    C.FAST_RCNN.SMOOTH_L1_BETA = 1.0
    C.FAST_RCNN.MLP_HEAD = AttrDict()
    C.FAST_RCNN.MLP_HEAD.MLP_DIM = 1024
    C.FAST_RCNN.MLP_HEAD.USE_BN = False
    C.FAST_RCNN.MLP_HEAD.USE_GN = False
    C.FAST_RCNN.MLP_HEAD.USE_WS = False
    C.FAST_RCNN.CONVFC_HEAD = AttrDict()
    C.FAST_RCNN.CONVFC_HEAD.DILATION = 1
    C.FAST_RCNN.CONVFC_HEAD.CONV_DIM = 256
    C.FAST_RCNN.CONVFC_HEAD.NUM_STACKED_CONVS = 4
    C.FAST_RCNN.CONVFC_HEAD.MLP_DIM = 1024
    C.FAST_RCNN.CONVFC_HEAD.USE_BN = False
    C.FAST_RCNN.CONVFC_HEAD.USE_WS = False
    C.FAST_RCNN.CONVFC_HEAD.USE_GN = False

    # ---- GRID_RCNN ----
    C.GRID_RCNN = AttrDict()
    C.GRID_RCNN.CASCADE_MAPPING_ON = False
    C.GRID_RCNN.RESCORE_ON = False
    C.GRID_RCNN.ROI_GRID_HEAD = "roi_grid_head"
    C.GRID_RCNN.ROI_GRID_OUTPUT = "Grid_output"
    C.GRID_RCNN.ROI_CLS_HEAD = "roi_cls_head"
    C.GRID_RCNN.ROI_CLS_OUTPUT = "Cls_output"
    C.GRID_RCNN.MAX_SAMPLE_NUM_GRID = 96
    C.GRID_RCNN.ACROSS_SAMPLE = False
    C.GRID_RCNN.ROI_XFORM_METHOD = "ROIAlign"
    C.GRID_RCNN.ROI_XFORM_SAMPLING_RATIO = 2
    C.GRID_RCNN.ROI_XFORM_RESOLUTION_CLS = (7, 7)
    C.GRID_RCNN.ROI_XFORM_RESOLUTION_GRID = (14, 14)
    C.GRID_RCNN.FG_IOU_THRESHOLD = 0.5
    C.GRID_RCNN.BG_IOU_THRESHOLD = 0.5
    C.GRID_RCNN.BATCH_SIZE_PER_IMAGE = 512
    C.GRID_RCNN.POSITIVE_FRACTION = 0.25
    C.GRID_RCNN.SCORE_THRESH = 0.03
    C.GRID_RCNN.NMS = 0.3
    C.GRID_RCNN.LOSS_WEIGHT = 15.0
    C.GRID_RCNN.POS_RADIUS = 1
    C.GRID_RCNN.GRID_POINTS = 9
    C.GRID_RCNN.ROI_FEAT_SIZE = 14
    C.GRID_RCNN.RANDOM_JITTER = False
    C.GRID_RCNN.FINEST_LEVEL_ROI = False
    C.GRID_RCNN.TARGET_REFINE = False
    C.GRID_RCNN.BETTER_ROI = False
    C.GRID_RCNN.BETTER_ROI_RATIO = 0.25
    C.GRID_RCNN.ENHANCE_FEATURES = False
    C.GRID_RCNN.FUSED_ON = True
    C.GRID_RCNN.EXTEND_ROI = False
    C.GRID_RCNN.OFFSET_ON = False
    C.GRID_RCNN.IOU_HELPER = False
    C.GRID_RCNN.IOU_HELPER_MERGE = False
    C.GRID_RCNN.IOU_LOSS_WEIGHT = 1.0
    C.GRID_RCNN.RESCORE_LOSS_WEIGHT = 1.0
    C.GRID_RCNN.SE_ON = False
    C.GRID_RCNN.TEST_MAX_DETECTIONS = 300
    C.GRID_RCNN.MLP_HEAD = AttrDict()
    C.GRID_RCNN.MLP_HEAD.MLP_DIM = 1024
    C.GRID_RCNN.MLP_HEAD.USE_BN = False
    C.GRID_RCNN.MLP_HEAD.USE_GN = False
    C.GRID_RCNN.MLP_HEAD.USE_WS = False
    C.GRID_RCNN.GRID_HEAD = AttrDict()
    C.GRID_RCNN.GRID_HEAD.NUM_CONVS = 8
    C.GRID_RCNN.GRID_HEAD.POINT_FEAT_CHANNELS = 64
    C.GRID_RCNN.CASCADE_MAPPING_OPTION = AttrDict()
    C.GRID_RCNN.CASCADE_MAPPING_OPTION.STAGE_NUM = 3
    C.GRID_RCNN.CASCADE_MAPPING_OPTION.TEST_STAGE = 3
    C.GRID_RCNN.CASCADE_MAPPING_OPTION.TEST_ENSEMBLE = True
    C.GRID_RCNN.CASCADE_MAPPING_OPTION.STAGE_WEIGHTS = (1.0, 0.5, 0.25)
    C.GRID_RCNN.CASCADE_MAPPING_OPTION.STAGE_MAPPING_RATIO = (1.0, 0.5, 0.25)
    C.GRID_RCNN.CASCADE_MAPPING_OPTION.FG_IOU_THRESHOLD = [0.5, 0.6, 0.7]
    C.GRID_RCNN.CASCADE_MAPPING_OPTION.BG_IOU_THRESHOLD = [0.5, 0.6, 0.7]
    C.GRID_RCNN.CASCADE_MAPPING_OPTION.GRID_NUM = (9, 9, 9)
    C.GRID_RCNN.CASCADE_MAPPING_OPTION.RESIZE_ROI = False
    C.GRID_RCNN.RESCORE_OPTION = AttrDict()
    C.GRID_RCNN.RESCORE_OPTION.KEEP_RATIO = False

    # ---- CASCADE_RCNN ----
    C.CASCADE_RCNN = AttrDict()
    C.CASCADE_RCNN.ROI_BOX_HEAD = "roi_2mlp_head"
    C.CASCADE_RCNN.ROI_BOX_OUTPUT = "Box_output"
    C.CASCADE_RCNN.NUM_STAGE = 3
    C.CASCADE_RCNN.FG_IOU_THRESHOLD = [0.5, 0.6, 0.7]
    C.CASCADE_RCNN.BG_IOU_THRESHOLD = [0.5, 0.6, 0.7]
    C.CASCADE_RCNN.BBOX_REG_WEIGHTS = (
        (10.0, 10.0, 5.0, 5.0),
        (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0),
    )
    C.CASCADE_RCNN.STAGE_WEIGHTS = (1.0, 0.5, 0.25)
    C.CASCADE_RCNN.TEST_STAGE = 3
    C.CASCADE_RCNN.TEST_ENSEMBLE = True
    C.CASCADE_RCNN.RESCORE_ON = False
    C.CASCADE_RCNN.IOU_HELPER = False
    C.CASCADE_RCNN.IOU_HELPER_MERGE = False
    C.CASCADE_RCNN.IOU_LOSS_WEIGHT = 1.0
    C.CASCADE_RCNN.RESCORE_LOSS_WEIGHT = 1.0

    # ---- VIS ----
    C.VIS = AttrDict()
    C.VIS.ENABLED = False
    C.VIS.VIS_TH = 0.9
    C.VIS.SHOW_BOX = AttrDict()
    C.VIS.SHOW_BOX.ENABLED = True
    C.VIS.SHOW_BOX.COLOR_SCHEME = "green"
    C.VIS.SHOW_BOX.COLORMAP = "COCO81"
    C.VIS.SHOW_BOX.BORDER_THICK = 2
    C.VIS.SHOW_CLASS = AttrDict()
    C.VIS.SHOW_CLASS.ENABLED = True
    C.VIS.SHOW_CLASS.COLOR = (218, 227, 218)
    C.VIS.SHOW_CLASS.FONT_SCALE = 0.45

    # ---- TPU-specific section (new; no reference analogue) ----
    C.TPU = AttrDict()
    C.TPU.MESH_SHAPE = (-1,)  # -1 = all local devices on the 'data' axis
    C.TPU.COMPUTE_DTYPE = "bfloat16"
    C.TPU.DONATE_TRAIN_STATE = True
    C.TPU.IMAGE_BUCKETS = ()
    C.TPU.RPN_PROPOSAL_PAD = 1000  # static proposal count fed to RoI heads
    C.TPU.POOLER_KERNEL = "auto"
    C.TPU.APPROX_TOPK = True
    C.TPU.S2D_STEM = False
    C.TPU.DEVICE_NORMALIZE = True
    C.TPU.TILED_TOWERS = False
    C.TPU.TOWER_BUCKETS = (16, 48)
    C.TPU.EVAL_TOWER_BUCKETS = (32, 128)
    C.TPU.EVAL_POOLER_DTYPE = "compute"
    C.TPU.EVAL_RESIZE = "cv2"

    return C


# The single global config.
cfg = _new_defaults()


def get_default_cfg():
    """A fresh mutable copy of the defaults (for tests / library use)."""
    return copy.deepcopy(_new_defaults())


def _decode_value(v):
    """YAML scalar -> python value, with literal_eval for tuple/list
    strings: "(800,)" becomes a tuple; plain strings stay strings."""
    if isinstance(v, dict):
        return AttrDict(v)
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce(value, default, full_key):
    """Coerce `value` to the type of `default` where safely possible."""
    if default is None:
        return value
    vt, dt = type(value), type(default)
    if vt == dt:
        return value
    # numpy array defaults accept lists
    if isinstance(default, np.ndarray):
        return np.array(value, dtype=default.dtype)
    if isinstance(default, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(default, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(default, float) and isinstance(value, int):
        return float(value)
    if isinstance(default, str):
        return str(value)
    raise ValueError(
        f"Type mismatch ({dt} vs {vt}) for config key {full_key}: "
        f"{default!r} vs {value!r}"
    )


# Deprecated keys in old YAMLs are warned about and skipped; renamed keys
# raise with the new spelling instead of a bare "non-existent key".
_DEPRECATED_KEYS = set()
_RENAMED_KEYS = {
    "EXAMPLE.RENAMED.KEY": "EXAMPLE.KEY",
    "PIXEL_MEAN": "PIXEL_MEANS",
    "PIXEL_STD": "PIXEL_STDS",
}


def _key_is_deprecated(full_key: str) -> bool:
    if full_key in _DEPRECATED_KEYS:
        import warnings

        warnings.warn(
            f"Deprecated config key (ignoring): {full_key}", stacklevel=3
        )
        return True
    return False


def _check_key_renamed(full_key: str):
    if full_key in _RENAMED_KEYS:
        new = _RENAMED_KEYS[full_key]
        msg = f"Key {full_key} was renamed to {new}"
        if isinstance(new, tuple):
            msg = (
                f"Key {full_key} was renamed to {new[0]}; "
                f"note: {new[1]}"
            )
        raise KeyError(msg + "; please update your config")


def _merge_into(src, dst, stack=None):
    assert isinstance(src, dict) and isinstance(dst, AttrDict)
    for k, v_raw in src.items():
        full_key = ".".join((stack or []) + [k])
        if k not in dst:
            if _key_is_deprecated(full_key):
                continue
            _check_key_renamed(full_key)
            raise KeyError(f"Non-existent config key: {full_key}")
        v = _decode_value(v_raw)
        if isinstance(v, AttrDict) or isinstance(v, dict):
            _merge_into(dict(v), dst[k], (stack or []) + [k])
        else:
            dst[k] = _coerce(v, dst[k], full_key)


def merge_cfg_from_file(filename, target=None):
    """Merge a YAML file into the global (or given) cfg."""
    import yaml

    target = cfg if target is None else target
    with open(filename, "r") as f:
        yml = yaml.safe_load(f)
    if yml:
        _merge_into(yml, target)
    return target


class _CfgNS(types.SimpleNamespace):
    """Attribute-only view of a config tree: lists become tuples; it is
    read-only by convention."""

    def __getitem__(self, k):
        return getattr(self, k)


def freeze_to_ns(tree):
    """Recursively convert an AttrDict config into a _CfgNS namespace."""
    if isinstance(tree, dict):
        return _CfgNS(**{k: freeze_to_ns(v) for k, v in tree.items()})
    if isinstance(tree, list):
        return tuple(freeze_to_ns(v) for v in tree)
    return tree


def flagship_cfg(tiny: bool = False):
    """The flagship CPM Grid-Cascade R-CNN, R-50-FPN, as the JAX package's
    entry module (`__graft_entry__._flagship_cfg`) builds it: 81 classes,
    CMM with 3 stages, ISM (merged) and RSM, fusion off, RPN test tops
    1000/1000/1000. `tiny` narrows every width for tests."""
    c = get_default_cfg()
    c.MODEL.FPN_ON = True
    c.MODEL.FASTER_RCNN = False
    c.MODEL.GRID_ON = True
    c.MODEL.NUM_CLASSES = 81
    c.RPN.ANCHOR_STRIDE = (4, 8, 16, 32, 64)
    g = c.GRID_RCNN
    g.CASCADE_MAPPING_ON = True
    g.IOU_HELPER = True
    g.IOU_HELPER_MERGE = True
    g.RESCORE_ON = True
    g.FUSED_ON = False
    if tiny:
        c.MODEL.NUM_CLASSES = 9
        c.BACKBONE.RESNET.LAYERS = (1, 1, 1, 1)
        c.BACKBONE.RESNET.BASE_PLANES = 8
        c.FPN.DIM = 32
        g.MLP_HEAD.MLP_DIM = 64
        c.RPN.PRE_NMS_TOP_N_TRAIN = 64
        c.RPN.POST_NMS_TOP_N_TRAIN = 32
        c.RPN.FPN_POST_NMS_TOP_N_TRAIN = 48
        c.RPN.PRE_NMS_TOP_N_TEST = 32
        c.RPN.POST_NMS_TOP_N_TEST = 16
        c.RPN.FPN_POST_NMS_TOP_N_TEST = 24
        g.BATCH_SIZE_PER_IMAGE = 32
        g.MAX_SAMPLE_NUM_GRID = 8
        g.TEST_MAX_DETECTIONS = 16
        g.GRID_HEAD.NUM_CONVS = 2
        g.GRID_HEAD.POINT_FEAT_CHANNELS = 8
    else:
        c.RPN.PRE_NMS_TOP_N_TEST = 1000
        c.RPN.POST_NMS_TOP_N_TEST = 1000
        c.RPN.FPN_POST_NMS_TOP_N_TEST = 1000
    return c


def x101_dcn_cfg(tiny: bool = False):
    """CPM R-CNN X-101-32x4d-FPN-DCN, the values of
    cfgs/rcnn/mscoco/grid_cascade/iou_helper/rescore/backbone/
    e2e_grid_cascade@567_rcnn_X-101-32x4d-FPN-DCN_2x.yaml over the defaults
    (a test holds the two equal key for key): a ResNeXt-101 32x4d trunk whose
    res3, res4 and res5 run deformable 3x3 convs, FPN, and the flagship's CPM
    head. `tiny` narrows every width for tests: one block per stage and two
    groups in the trunk (a ResNeXt has no BASE_PLANES, so its stage outputs
    keep their widths)."""
    c = get_default_cfg()
    c.PIXEL_MEANS = [102.9801, 115.9465, 122.7717]
    c.PIXEL_STDS = [1.0, 1.0, 1.0]
    c.CKPT = ("ckpts/rcnn/mscoco/grid_cascade/iou_helper/rescore/backbone/"
              "e2e_grid_cascade@567_rcnn_X-101-32x4d-FPN-DCN_2x")
    c.MODEL.FPN_ON = True
    c.MODEL.FASTER_RCNN = False
    c.MODEL.GRID_ON = True
    c.MODEL.NUM_CLASSES = 81
    c.MODEL.CONV1_RGB2BGR = False
    c.BACKBONE.CONV_BODY = "resnext"
    x = c.BACKBONE.RESNEXT
    x.LAYERS = (3, 4, 23, 3)
    x.C = 32
    x.WIDTH = 4
    x.STAGE_WITH_CONV = ("normal", "deform", "deform", "deform")
    c.RPN.ANCHOR_STRIDE = (4, 8, 16, 32, 64)
    c.RPN.PRE_NMS_TOP_N_TRAIN = 2000
    c.RPN.PRE_NMS_TOP_N_TEST = 1000
    c.RPN.POST_NMS_TOP_N_TEST = 1000
    c.RPN.FPN_POST_NMS_TOP_N_TEST = 1000
    g = c.GRID_RCNN
    g.NMS = 0.3
    g.SCORE_THRESH = 0.03
    g.FUSED_ON = False
    g.IOU_HELPER = True
    g.IOU_HELPER_MERGE = True
    g.RESCORE_ON = True
    g.CASCADE_MAPPING_ON = True
    m = g.CASCADE_MAPPING_OPTION
    m.STAGE_NUM = 3
    m.TEST_STAGE = 3
    m.TEST_ENSEMBLE = False
    m.FG_IOU_THRESHOLD = [0.5, 0.6, 0.7]
    m.BG_IOU_THRESHOLD = [0.5, 0.6, 0.7]
    s = c.SOLVER
    s.WEIGHT_DECAY = 0.0001
    s.BASE_LR = 0.02
    s.GAMMA = 0.1
    s.WARM_UP_ITERS = 500
    s.MAX_ITER = 180000
    s.STEPS = [120000, 160000]
    c.TRAIN.WEIGHTS = "weights/resnext101_32x4d.pth"
    c.TRAIN.DATASETS = ("coco_2017_train",)
    c.TRAIN.SCALES = (800,)
    c.TRAIN.MAX_SIZE = 1333
    c.TEST.DATASETS = ("coco_2017_val",)
    c.TEST.SCALE = 800
    c.TEST.MAX_SIZE = 1333
    if tiny:
        c.MODEL.NUM_CLASSES = 9
        x.LAYERS = (1, 1, 1, 1)
        x.C = 2
        c.FPN.DIM = 32
        g.MLP_HEAD.MLP_DIM = 64
        c.RPN.PRE_NMS_TOP_N_TRAIN = 64
        c.RPN.POST_NMS_TOP_N_TRAIN = 32
        c.RPN.FPN_POST_NMS_TOP_N_TRAIN = 48
        c.RPN.PRE_NMS_TOP_N_TEST = 32
        c.RPN.POST_NMS_TOP_N_TEST = 16
        c.RPN.FPN_POST_NMS_TOP_N_TEST = 24
        g.BATCH_SIZE_PER_IMAGE = 32
        g.MAX_SAMPLE_NUM_GRID = 8
        g.TEST_MAX_DETECTIONS = 16
        g.GRID_HEAD.NUM_CONVS = 2
        g.GRID_HEAD.POINT_FEAT_CHANNELS = 8
    return c
