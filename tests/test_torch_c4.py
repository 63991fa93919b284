"""The C4 (non-FPN) family: the JAX package against the port.

* the tiny C4 models of tests/test_c4_family.py (the `resnet_c4` trunk at
  BASE_PLANES 8, a one-level RPN at stride 16) with `resnet_c5_head` (14x14
  pooling, stage 5 at stride 2, `BoxOutput`'s average pool of its 4-D
  block) and with `resnet_2mlp_head` (stage 5 at C5_DILATION 2 over the C4
  map, conv_new, 7x7 pooling, fc1 / fc2), in f32: the port's seeded weights
  bridged into the JAX model; eval detections (labels and counts exactly,
  boxes 1e-3 px, scores 1e-5), one training forward and backward over the
  same recorded draws, losses 1e-5 relative, gradients rtol 1e-3 / atol
  1e-5; the bridge both ways and the optimizer's labels (stage 5's
  AffineChannels frozen, as in the trunk);
* `import_c5_stage` and `import_2mlp_head` bit for bit against the JAX
  package's importers plus the bridge, from a reference-layout state_dict
  with BatchNorm running statistics.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import sys
import types

import jax
import numpy as np
import pytest

from cpm_tpu.config import get_default_cfg
from cpm_tpu.solver.optimizer import param_label_tree
from cpm_tpu.utils import weight_import as jax_import
from tests.test_torch_box_head import (
    assert_bridge_round_trip,
    assert_detections_match,
    assert_losses_and_gradients_match,
    model_outputs,
)
from tests.test_torch_train import _flat
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)
from tests.torch_support import memo

HEADS = ("resnet_c5_head", "resnet_2mlp_head")
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")


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


def tiny_c4_cfg(head):
    """tests/test_c4_family.py's tiny C4 config, in f32 and with every
    detection kept (random weights score near 1/5)."""
    cfg = get_default_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.FPN_ON = False
    cfg.MODEL.FASTER_RCNN = True
    cfg.MODEL.NUM_CLASSES = 5
    cfg.BACKBONE.CONV_BODY = "resnet_c4"
    cfg.BACKBONE.RESNET.LAYERS = (1, 1, 1, 1)
    cfg.BACKBONE.RESNET.BASE_PLANES = 8
    cfg.FAST_RCNN.ROI_BOX_HEAD = head
    cfg.FAST_RCNN.MLP_HEAD.MLP_DIM = 64
    cfg.FAST_RCNN.SCORE_THRESH = 0.0
    cfg.RPN.ANCHOR_STRIDE = (16,)
    cfg.RPN.ANCHOR_SIZES = (32, 64, 128)
    cfg.RPN.PRE_NMS_TOP_N_TRAIN = 64
    cfg.RPN.POST_NMS_TOP_N_TRAIN = 32
    cfg.RPN.FPN_POST_NMS_TOP_N_TRAIN = 64
    cfg.RPN.PRE_NMS_TOP_N_TEST = 32
    cfg.RPN.POST_NMS_TOP_N_TEST = 16
    cfg.RPN.FPN_POST_NMS_TOP_N_TEST = 32
    cfg.FAST_RCNN.BATCH_SIZE_PER_IMAGE = 16
    cfg.FAST_RCNN.DETECTIONS_PER_IMG = 10
    if head == "resnet_c5_head":
        cfg.FAST_RCNN.ROI_XFORM_RESOLUTION = (14, 14)
    else:
        cfg.FAST_RCNN.ROI_XFORM_RESOLUTION = (7, 7)
        cfg.BACKBONE.RESNET.C5_DILATION = 2
    return cfg


@pytest.fixture(scope="module", params=HEADS)
def c4_outputs(request, tmp_path_factory):
    return memo(f"c4 {request.param}", lambda: dict(model_outputs(
        tiny_c4_cfg(request.param), share=(tmp_path_factory, f"c4_{request.param}")),
        head=request.param))


def test_c4_eval_matches_jax(c4_outputs):
    out = c4_outputs
    assert_detections_match(out["got_dets"], out["dets"])
    assert sum(int(m.sum()) for m in out["got_dets"].mask) > 0


def test_c4_losses_and_gradients_match_jax(c4_outputs):
    out = c4_outputs
    # the one-level RPN's [B, 4 x 4 x 9 anchors] twice, then the head's
    # sample [B, proposals + gt] twice
    assert [a.shape for a in out["draws"]] == out["draw_shapes"] == [(2, 144)] * 2 + [(2, 36)] * 2
    assert assert_losses_and_gradients_match(out, LOSSES) > 20


def test_c4_bridge_and_labels(c4_outputs):
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.utils.param_bridge import name_map

    out = c4_outputs
    assert_bridge_round_trip(out)
    model, params = out["model"], out["params"]
    assert model.fpn is None and not any(k.startswith("backbone.layer4.") for k in
                                         model.state_dict())
    head = {k.split(".")[2] for k in model.state_dict() if k.startswith("roi_head.head.")}
    assert head == ({"layer4"} if out["head"] == "resnet_c5_head"
                    else {"layer4", "conv_new", "fc1", "fc2"})
    names = name_map(params)
    for freeze_at in (0, 2):
        want = _flat(param_label_tree(params, freeze_at))
        got = classify_params(model, freeze_at)
        assert set(got) == set(names.values())
        for path, key in names.items():
            assert got[key] == want[path], (freeze_at, key)
    assert classify_params(model, 2)["roi_head.head.layer4.0.bn1.weight"] == "frozen"


def _reference_head(shapes, rng):
    """A reference-layout head state_dict for the port's `roi_head.head.*`
    shapes: `layer4.{b}.conv{i}` with BatchNorm `bn{i}` (running statistics)
    and `downsample.{0,1}`, `conv_new.0`, `fc1`, `fc2`."""
    import torch

    out = {}
    for key, shape in shapes.items():
        name = key[len("roi_head.head."):]
        if name.startswith("conv_new."):
            name = name.replace("conv_new.", "conv_new.0.")
        out[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if name.endswith(".weight") and (".bn" in name or ".downsample.1." in name):
            pref = name[: -len(".weight")]
            out[f"{pref}.running_mean"] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))
            out[f"{pref}.running_var"] = torch.from_numpy(
                rng.uniform(0.5, 2.0, shape).astype(np.float32))
    return out


@pytest.mark.parametrize("head", HEADS)
def test_c4_head_importers_match_jax(head):
    import torch

    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named
    from cpm_tpu_torch.utils.weight_import import import_2mlp_head, import_c5_stage

    model = build_model(tiny_c4_cfg(head), "cpu")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
              if k.startswith("roi_head.head.")}
    sd = _reference_head(shapes, np.random.RandomState(4))
    n_blocks = 1
    if head == "resnet_c5_head":
        got = import_c5_stage(sd, n_blocks)
        tree = jax_import.import_c5_stage({k: v.numpy() for k, v in sd.items()}, n_blocks)
    else:
        got = import_2mlp_head(sd, n_blocks)
        tree = jax_import.import_2mlp_head({k: v.numpy() for k, v in sd.items()}, n_blocks)
        # fc1 reads the flattened pool in the reference's (C, H, W) order
        assert not torch.equal(got["roi_head.head.fc1.weight"], sd["fc1.weight"])
    want = flax_tree_to_named({"roi_head": {"head": tree}}, shapes)
    assert sorted(got) == sorted(want) == sorted(shapes)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    model.load_state_dict(got, strict=False)
