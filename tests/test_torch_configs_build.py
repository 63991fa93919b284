"""Every shipped YAML builds in the port.

* each of the YAMLs under cfgs/ (the paper's, the baselines and the debug
  ones) through the port's config loader and `GeneralizedRCNN` on the meta
  device (parameters without storage, so that a full-width model costs no
  memory or draws): nothing raises, and the model has parameters;
* the four YAMLs whose options act only in training (RANDOM_JITTER,
  BETTER_ROI) take one training step on the CPU at a tiny width (one block
  a stage, BASE_PLANES 8, FPN 32, two tower convs of 8 channels a point,
  9 classes, f32) on a 64x64 synthetic batch: finite losses, each of the
  YAML's.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import glob
import math
import os
import sys
import types

import pytest
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, REPO)
               for p in glob.glob(os.path.join(REPO, "cfgs", "**", "*.yaml"), recursive=True))
TRAIN_ONLY = sorted(y for y in YAMLS if "/random_jitter/" in y or "/bretter_roi/" in y)
TINY = ["BACKBONE.RESNET.LAYERS", "(1, 1, 1, 1)", "BACKBONE.RESNET.BASE_PLANES", "8",
        "FPN.DIM", "32", "MODEL.NUM_CLASSES", "9", "GRID_RCNN.MLP_HEAD.MLP_DIM", "64",
        "GRID_RCNN.GRID_HEAD.NUM_CONVS", "2", "GRID_RCNN.GRID_HEAD.POINT_FEAT_CHANNELS", "8",
        "GRID_RCNN.BATCH_SIZE_PER_IMAGE", "32", "GRID_RCNN.MAX_SAMPLE_NUM_GRID", "8",
        "RPN.PRE_NMS_TOP_N_TRAIN", "64", "RPN.POST_NMS_TOP_N_TRAIN", "32",
        "RPN.FPN_POST_NMS_TOP_N_TRAIN", "48", "TPU.COMPUTE_DTYPE", "float32"]


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function.
    torch registers custom ops at the first backward or optimizer of a process
    and looks its caller up with `inspect.getmodule`, which walks
    `sys.modules` and fails on such a `__file__`. Whether that file ran
    earlier in this worker depends on the scheduling, so the stubs go before
    this file's first torch call; that file installs them again when it needs
    them."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


def test_every_yaml_is_listed():
    assert len(YAMLS) == 63 and len(TRAIN_ONLY) == 4


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_builds(yaml):
    import torch

    from cpm_tpu_torch.modeling.model import GeneralizedRCNN
    from cpm_tpu_torch.tools.train_net import load_config

    cfg = load_config(os.path.join(REPO, yaml), [])
    with torch.device("meta"):
        model = GeneralizedRCNN(cfg)
    params = list(model.parameters())
    assert params and all(p.is_meta for p in params)


@pytest.mark.parametrize("yaml", TRAIN_ONLY)
def test_training_option_yaml_takes_a_tiny_step(yaml):
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.tools.train_net import load_config

    cfg = load_config(os.path.join(REPO, yaml), TINY)
    g = cfg.GRID_RCNN
    assert g.RANDOM_JITTER or g.BETTER_ROI
    model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
    state, metrics = make_train_step(cfg, model, optimizer)(
        state, synthetic_batch(2, 64, 64, max_gt=4, num_classes=9))
    stages = g.CASCADE_MAPPING_OPTION.STAGE_NUM
    want = {"loss_objectness", "loss_rpn_box_reg", "loss_classifier"} | {
        f"loss_grid_{s + 1}" for s in range(stages)}
    assert {k for k in metrics if k.startswith("loss_")} == want
    assert all(math.isfinite(float(metrics[k])) for k in want)
