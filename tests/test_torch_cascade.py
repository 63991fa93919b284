"""The Cascade R-CNN head with ISM and RSM: the JAX package against the port.

* `CascadeStageOutput` with the ISM branch, through the bridge: outputs to
  1e-5 relative, in the compute dtype (no upcast, as in the JAX package);
* the tiny cascade (cfgs/debug/tiny_cascade.yaml: 3 stages, at FPN 32 in
  f32, ISM on, RSM on), the port's seeded weights bridged into the JAX
  model, with FAST_RCNN.SCORE_THRESH 0.0 and the IoU branch's fg bias at
  0.5 (seeded weights give IoU logits near 0, of either sign): eval
  detections with ISM merged and RSM, with ISM unmerged and no RSM, and at
  TEST_STAGE 2 (the ISM branch then unused), labels and counts exactly,
  boxes 1e-3 px, scores 1e-5; one training forward and backward on the
  same batch and the same recorded draws (the sampler draws over [B, S + G]
  from stage 2 on), losses 1e-5 relative, gradients rtol 1e-3 / atol 1e-5;
  the bridge both ways;
* `train_net` then `test_net` with `--device cpu` on tiny_cascade.yaml;
* a whole reference checkpoint is imported for the grid-cascade family
  only, as in the JAX package: the cascade's raises.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest

from cpm_tpu.modeling.model import build_model as jax_build_model
from cpm_tpu.modeling.roi_heads.cascade_head import CascadeStageOutput as JaxStageOutput
from tests.test_torch_box_head import (
    DATA_DIR,
    REPO,
    _close,
    assert_bridge_round_trip,
    assert_detections_match,
    assert_losses_and_gradients_match,
    model_outputs,
    tiny_cfg,
)
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)
from tests.torch_support import memo

TINY = os.path.join(REPO, "cfgs", "debug", "tiny_cascade.yaml")
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "s1_cls_loss", "s1_bbox_loss", "s2_cls_loss",
          "s2_bbox_loss", "s3_cls_loss", "s3_bbox_loss", "loss_iou_3", "loss_rescore")
ISM_RSM = {"CASCADE_RCNN.IOU_HELPER": True, "CASCADE_RCNN.IOU_HELPER_MERGE": True,
           "CASCADE_RCNN.RESCORE_ON": True, "FAST_RCNN.SCORE_THRESH": 0.0}


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


def test_stage_output_matches_jax_and_keeps_the_compute_dtype():
    import torch
    from torch import nn

    from cpm_tpu_torch.modeling.roi_heads.cascade_head import CascadeStageOutput
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    x = np.random.RandomState(5).randn(12, 48).astype(np.float32)
    jo = JaxStageOutput(num_classes=7, cls_agnostic_bbox_reg=True, iou_helper=True)

    @jax.jit
    def run(x):
        p = jo.init(jax.random.PRNGKey(0), x)["params"]
        return p, jo.apply({"params": p}, x)

    params, want = run(x)
    model = nn.Module()
    model.roi_head = nn.Module()
    model.roi_head.outputs = nn.ModuleList([CascadeStageOutput(48, 7, True, iou_helper=True)])
    load_flax_params(model, jax.device_get({"roi_head": {"output_0": params}}))
    out = model.roi_head.outputs[0]
    with torch.no_grad():
        got = out(torch.from_numpy(x))
        bf16 = out.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16))
    for g, w, shape in zip(got, want, ((12, 7), (12, 8), (12, 2))):
        assert tuple(g.shape) == shape
        _close(g, w)
    assert all(t.dtype == torch.bfloat16 for t in bf16)


def _positive_iou(model):
    """Seeded weights give IoU logits near 0, of either sign; a positive
    bias on the fg logit keeps ISM's scores (score x IoU, or the IoU) above
    the threshold, so that the detection sets are not empty."""
    import torch

    with torch.no_grad():
        model.roi_head.outputs[-1].iou_pred.bias.copy_(torch.tensor([0.0, 0.5]))


@pytest.fixture(scope="module")
def cascade_outputs(tmp_path_factory):
    return memo("cascade", lambda: model_outputs(
        tiny_cfg(TINY, **ISM_RSM), prepare=_positive_iou, share=(tmp_path_factory, "cascade")))


def _without_rescore(params):
    head = {k: v for k, v in params["roi_head"].items() if not k.startswith("rescore")}
    return {**params, "roi_head": head}


@pytest.mark.parametrize("variant", ["ism_merged_rsm", "ism_unmerged", "test_stage_2"])
def test_cascade_eval_matches_jax(cascade_outputs, variant):
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    out = cascade_outputs
    if variant == "ism_merged_rsm":
        assert_detections_match(out["got_dets"], out["dets"])
        return
    over = dict(ISM_RSM, **{"CASCADE_RCNN.RESCORE_ON": False})
    if variant == "ism_unmerged":
        over["CASCADE_RCNN.IOU_HELPER_MERGE"] = False
    else:
        over["CASCADE_RCNN.TEST_STAGE"] = 2
    cfg = tiny_cfg(TINY, **over)
    params = _without_rescore(out["params"])
    images = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[64, 64], [56, 48]], np.int32)
    jm = jax_build_model(cfg)
    want = jax.device_get(jax.jit(
        lambda p, i, s: jm.apply({"params": p}, i, s, train=False))(params, images, sizes))
    model = load_flax_params(build_model(cfg, "cpu"), params)
    assert_detections_match(make_forward_fn(cfg, model)(images, sizes), want)


def test_cascade_losses_and_gradients_match_jax(cascade_outputs):
    out = cascade_outputs
    # RPN [B, anchors]; stage 1 [B, proposals + gt]; stages 2 and 3 [B, S + G];
    # RSM [B, S + S]; two draws each
    want_shapes = [(2, 1023), (2, 104), (2, 36), (2, 36), (2, 64)]
    assert [a.shape for a in out["draws"]] == out["draw_shapes"] == [
        s for s in want_shapes for _ in range(2)]
    assert assert_losses_and_gradients_match(out, LOSSES) > 30


def test_cascade_bridge_both_ways(cascade_outputs):
    assert_bridge_round_trip(cascade_outputs)
    heads = {k.split(".")[1] for k in cascade_outputs["model"].state_dict()
             if k.startswith("roi_head.")}
    assert heads == {"box_heads", "outputs", "rescore_head", "rescore_output"}


def test_cascade_cli_trains_and_evaluates_on_the_cpu(tmp_path):
    from cpm_tpu_torch.tools import test_net, train_net

    common = ["--cfg", TINY, "--device", "cpu", "CKPT", str(tmp_path), "DATA_DIR", DATA_DIR,
              "CASCADE_RCNN.IOU_HELPER", "True", "CASCADE_RCNN.IOU_HELPER_MERGE", "True",
              "CASCADE_RCNN.RESCORE_ON", "True"]
    history = train_net.main(common + ["SOLVER.MAX_ITER", "2", "SOLVER.SNAPSHOT_ITERS", "2"])
    assert [r["iter"] for r in history] == [1, 2]
    for r in history:
        assert sorted(k for k in r if k.startswith(("loss_", "s1_", "s2_", "s3_"))) == sorted(LOSSES)
        assert all(np.isfinite(r[k]) for k in LOSSES)
    out = test_net.main(common + ["FAST_RCNN.SCORE_THRESH", "0.0"])
    with open(tmp_path / "test" / "bbox.json") as f:
        assert json.load(f) == out["results"]
    assert len(out["results"]) > 0 and "AP" in out["stats"]


def test_whole_checkpoint_import_is_for_the_grid_family():
    from cpm_tpu_torch.utils.weight_import import import_cpm_checkpoint

    # as in the JAX package, a reference checkpoint is read as Grid_Cascade_RCNN.*
    with pytest.raises(NotImplementedError, match="grid-cascade family only"):
        import_cpm_checkpoint({}, tiny_cfg(TINY, **ISM_RSM))
