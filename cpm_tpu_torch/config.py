"""Config schema of the port: the JAX package's own, shared by import.

`cpm_tpu.config` is free of JAX, so the port re-exports it instead of
copying it: the same keys, defaults, strict merging and YAML surface. The
`TPU.*` keys stay valid. `TPU.COMPUTE_DTYPE`, `TPU.DEVICE_NORMALIZE` and
`TPU.EVAL_POOLER_DTYPE` keep their meaning on the GPU; the rest describe
TPU layouts and are accepted and ignored (see `modeling/model.py`).

`cpm_tpu.config` imports PyYAML at module top for `merge_cfg_from_file`.
Where PyYAML is not installed, a stand-in module takes its place so that the
schema still imports; any YAML load or dump through it raises ImportError.
"""

import sys
import types


def _yaml_missing(*args, **kwargs):
    raise ImportError("PyYAML is not installed: YAML config files cannot be read")


try:
    import yaml  # noqa: F401
except ImportError:
    _stand_in = types.ModuleType("yaml")
    for _name in ("safe_load", "load", "safe_dump", "dump"):
        setattr(_stand_in, _name, _yaml_missing)
    sys.modules["yaml"] = _stand_in

from cpm_tpu.config import (  # noqa: E402
    AttrDict,
    assert_and_infer_cfg,
    cfg,
    freeze_to_ns,
    get_default_cfg,
    merge_cfg_from_cfg,
    merge_cfg_from_file,
    merge_cfg_from_list,
)

__all__ = [
    "AttrDict",
    "assert_and_infer_cfg",
    "cfg",
    "flagship_cfg",
    "freeze_to_ns",
    "get_default_cfg",
    "merge_cfg_from_cfg",
    "merge_cfg_from_file",
    "merge_cfg_from_list",
]


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
