"""The grid-cascade options of the paper's YAMLs: the JAX package against the port.

* `resize_large_rois`, `extend_rois`, `enhance_features` (at the odd level
  sizes of a 600x1000 bucket, P2 152x256 .. P6 10x16), `random_jitter_boxes`
  (the JAX draw recorded and handed to the port) and `better_roi_mask`, and
  `SeBlock`: 1e-6 absolute;
* `GridHead` with FINEST_LEVEL_ROI and OFFSET_ON and `GridOutput` with
  OFFSET_ON, fused and not (`offset_emb` exists only without the fused
  tower, as in the JAX module), through the bridge: outputs to 1e-5
  relative (SE_ON is held in a model below: the JAX module creates its
  block once a tower, so it runs where one tower runs, FUSED_ON off);
* two tiny grid-cascade models (the tiny flagship in f32, 2 stages), the
  port's seeded weights bridged into the JAX model: one with FINEST_LEVEL_ROI,
  RESIZE_ROI, EXTEND_ROI, BETTER_ROI, RANDOM_JITTER, KEEP_RATIO, RESCORE_ON
  and OFFSET_ON under FUSED_ON (2x2 grids), one with ENHANCE_FEATURES and
  SE_ON without FUSED_ON. Each: eval detections (labels and counts exactly,
  boxes 1e-3 px, scores 1e-5), one training forward and backward on a
  128x128 batch with large gt boxes (so that RESIZE_ROI shrinks refined
  boxes) over the same recorded draws (the sampler's, the jitter's and the
  keep ratio's), losses 1e-5 relative, gradients rtol 1e-3 / atol 1e-5; the
  bridge both ways and the optimizer's labels;
* OFFSET_ON under FUSED_ON: the offset branch gets a zero gradient and
  still moves by weight decay in a train step, as optax's SGD moves it;
  the reference checkpoint importer reads it.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship_cfg
from cpm_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from cpm_tpu.modeling.context import SeBlock as JaxSeBlock
from cpm_tpu.modeling.roi_heads import grid_ops as jgo
from cpm_tpu.modeling.roi_heads.grid_modules import GridHead as JaxGridHead
from cpm_tpu.modeling.roi_heads.grid_modules import GridOutput as JaxGridOutput
from cpm_tpu.solver.optimizer import param_label_tree
from tests.test_torch_box_head import (
    _close,
    assert_bridge_round_trip,
    assert_detections_match,
    assert_losses_and_gradients_match,
    model_outputs,
)
from tests.test_torch_train import RecordedUniform, _flat
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)
from tests.torch_support import memo

FRAMES = ("cpm_tpu.utils.sampler", "cpm_tpu.modeling.roi_heads.grid_ops",
          "cpm_tpu.modeling.roi_heads.grid_cascade_head")
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_grid_1",
          "loss_grid_2", "loss_iou_2", "loss_rescore")
# P2..P6 of a 600x1000 image padded to 608x1024
BUCKET_LEVELS = ((152, 256), (76, 128), (38, 64), (19, 32), (10, 16))


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


def _boxes(rng, n, size=120.0):
    xy = rng.rand(n, 2) * size * 0.7
    wh = rng.rand(n, 2) * size * 0.6 + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("op", ["resize_large_rois", "extend_rois", "enhance_features",
                                "random_jitter_boxes", "better_roi_mask"])
def test_grid_ops_match_jax(op):
    import torch

    from cpm_tpu_torch.modeling.roi_heads import grid_ops

    rng = np.random.RandomState(11)
    boxes = _boxes(rng, 64).reshape(2, 32, 4)
    sizes = np.array([[120, 110], [96, 128]], np.int32)
    t = torch.from_numpy
    if op == "resize_large_rois":
        boxes = boxes * 2  # half of them above 96 x 96
        want = jgo.resize_large_rois(jnp.asarray(boxes))
        got = grid_ops.resize_large_rois(t(boxes))
        assert (np.asarray(want) != boxes).any() and (np.asarray(want) == boxes).any()
    elif op == "extend_rois":
        want = jgo.extend_rois(jnp.asarray(boxes), jnp.asarray(sizes)[:, None, :])
        got = grid_ops.extend_rois(t(boxes), t(sizes)[:, None, :])
    elif op == "enhance_features":
        feats = [rng.randn(1, h, w, 2).astype(np.float32) for h, w in BUCKET_LEVELS]
        want = jax.jit(jgo.enhance_features)([jnp.asarray(f) for f in feats])
        got = grid_ops.enhance_features([t(f) for f in feats])
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
        # the plain nearest of torch reads another cell on the 19 -> 10 and
        # 32 -> 16 downsamples, which the port must not use
        p5 = torch.nn.functional.interpolate(t(feats[4]).permute(0, 3, 1, 2), size=(19, 32),
                                             mode="nearest").permute(0, 2, 3, 1)
        assert not np.allclose((t(feats[3]) + p5).numpy()[0, ::2], np.asarray(want[3])[0, ::2])
        return
    elif op == "random_jitter_boxes":
        draws = RecordedUniform(3, ("cpm_tpu.modeling.roi_heads.grid_ops",))
        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(jax.random, "uniform", draws)
            want = jgo.random_jitter_boxes(jnp.asarray(boxes), jax.random.PRNGKey(0),
                                           jnp.asarray(sizes)[:, None, :])
        finally:
            mp.undo()
        (u,) = draws.arrays
        assert u.shape == (2, 32, 4)
        got = grid_ops.random_jitter_boxes(t(boxes), t(u), t(sizes)[:, None, :])
    else:
        gt = boxes + rng.randn(*boxes.shape).astype(np.float32) * 8
        want = jgo.better_roi_mask(jnp.asarray(boxes), jnp.asarray(gt), 0.25)
        got = grid_ops.better_roi_mask(t(boxes), t(gt), 0.25)
        assert got.dtype == torch.bool and 0 < int(got.sum()) < got.numel()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_se_block_matches_jax():
    import torch

    from cpm_tpu_torch.modeling.context import SeBlock
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    x = np.random.RandomState(2).randn(5, 6, 7, 24).astype(np.float32)
    se = JaxSeBlock(24, 3)
    params = jax.jit(lambda x: se.init(jax.random.PRNGKey(0), x))(x)["params"]
    want = se.apply({"params": params}, x)
    block = load_flax_params(SeBlock(24, 3), jax.device_get(params))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["finest_offset_unfused", "offset_fused"])
def test_grid_head_and_output_options_match_jax(case):
    import torch
    from torch import nn

    from cpm_tpu_torch.modeling.roi_heads.grid_modules import GridHead, GridOutput
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    fused = case == "offset_fused"
    points, pc, cin = (4, 8, 16) if fused else (9, 8, 16)
    kw = dict(grid_points=points, num_convs=2, point_feat_channels=pc, fused_on=fused,
              offset_on=True)
    gh = JaxGridHead(finest_level_only=not fused, **kw)
    go = JaxGridOutput(grid_points=points, point_feat_channels=pc, iou_helper=True,
                       fused_on=fused, offset_on=True)
    pooled = np.random.RandomState(0).randn(6, 14, 14, cin).astype(np.float32)
    mask = np.ones(6, bool)

    @jax.jit
    def run(pooled):
        ph = gh.init(jax.random.PRNGKey(0), None, None, mask, pooled=pooled)["params"]
        x, x_so, x_off = gh.apply({"params": ph}, None, None, mask, pooled=pooled)
        po = go.init(jax.random.PRNGKey(1), x, x_so, x_off, train=True)["params"]
        return (ph, po), (x, x_so, x_off), go.apply({"params": po}, x, x_so, x_off, train=True)

    (ph, po), (x, x_so, x_off), (hm, iou) = jax.device_get(run(pooled))
    assert ("offset_emb" in po) == (not fused)
    heads = nn.Module()
    heads.roi_head = nn.Module()
    head = GridHead(cin, points, 14, num_convs=2, point_feat_channels=pc, fused_on=fused,
                    finest_level_only=not fused, offset_on=True)
    out = GridOutput(points, pc, 14, iou_helper=True, fused_on=fused, offset_on=True)
    heads.roi_head.grid_heads = nn.ModuleList([head])
    heads.roi_head.grid_outputs = nn.ModuleList([out])
    # every flax leaf lands on one port parameter and back (a strict load)
    load_flax_params(heads, {"roi_head": {"grid_head_0": ph, "grid_output_0": po}})
    with torch.no_grad():
        tx, tx_so, tx_off = head(pooled=torch.from_numpy(pooled))
        thm, tiou = out(tx, tx_so, tx_off, train=True)
    _close(tx, x)
    _close(tiou, iou)
    _close(thm["unfused"], hm["unfused"])
    _close(thm["fused"], hm["fused"])
    if fused:
        # the fused tower reads x_so; the offsets feed nothing
        _close(tx_so, x_so)
        assert tx_off is None and head.pooler.scales == (0.25, 0.125, 0.0625, 0.03125)
    else:
        _close(tx_off, x_off)
        assert tx_so is None and head.pooler.scales == (0.25,)


# ---------------------------------------------------------------------------
# the tiny models
# ---------------------------------------------------------------------------


def options_cfg(which):
    """The tiny flagship in f32 with two stages and one set of options."""
    cfg = _flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    g = cfg.GRID_RCNN
    opt = g.CASCADE_MAPPING_OPTION
    opt.STAGE_NUM = opt.TEST_STAGE = 2
    opt.STAGE_WEIGHTS, opt.STAGE_MAPPING_RATIO = (1.0, 0.5), (1.0, 0.5)
    opt.FG_IOU_THRESHOLD = opt.BG_IOU_THRESHOLD = (0.5, 0.6)
    if which == "finest_offset":
        opt.GRID_NUM = (4, 4)
        opt.RESIZE_ROI = True
        g.FUSED_ON = g.OFFSET_ON = True
        g.FINEST_LEVEL_ROI = g.EXTEND_ROI = g.BETTER_ROI = g.RANDOM_JITTER = True
        g.RESCORE_ON = g.RESCORE_OPTION.KEEP_RATIO = True
    else:
        opt.GRID_NUM = (9, 9)
        g.FUSED_ON = False
        g.ENHANCE_FEATURES = g.SE_ON = True
    return cfg


def _big_gt_batch():
    """A 128x128 batch whose first gt boxes are large (over 96 x 96), so that
    refined boxes of their positives pass RESIZE_ROI's area."""
    batch = jax_synthetic_batch(2, 128, 128, max_gt=4, num_classes=9, seed=3)
    batch["gt_boxes"][:, 0] = [[6.0, 9.0, 121.0, 118.0], [12.0, 4.0, 117.0, 124.0]]
    batch["gt_mask"][:, 0] = True
    batch["gt_labels"][:, 0] = [3, 5]
    return batch


@pytest.fixture(scope="module", params=["finest_offset", "enhance_se"])
def option_outputs(request, tmp_path_factory):
    return memo(f"options {request.param}", lambda: _option_outputs(request.param,
                                                                    tmp_path_factory))


def _option_outputs(which, tmp_path_factory):
    from cpm_tpu_torch.modeling.roi_heads import grid_cascade_head

    real = grid_cascade_head.resize_large_rois
    shrunk = []

    def counting(boxes):
        out = real(boxes)
        shrunk.append(int((out != boxes).any(-1).sum()))
        return out

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(grid_cascade_head, "resize_large_rois", counting)
        out = model_outputs(options_cfg(which), batch=_big_gt_batch(), frames=FRAMES,
                            share=(tmp_path_factory, f"options_{which}"))
    finally:
        mp.undo()
    return dict(out, which=which, shrunk=shrunk)


def test_option_models_eval_matches_jax(option_outputs):
    out = option_outputs
    assert_detections_match(out["got_dets"], out["dets"])
    assert sum(int(m.sum()) for m in out["got_dets"].mask) > 0


def test_option_models_losses_and_gradients_match_jax(option_outputs):
    out = option_outputs
    # RPN [B, anchors] x2 and the cls sample [B, proposals + gt] x2; then the
    # jitter [B, S, 4] before the grid cap [B, S]; then the keep ratio
    # [B, S] before the RSM sample [B, S + refined + gt] x2
    shapes = [a.shape for a in out["draws"]]
    assert shapes == out["draw_shapes"]
    head = [(2, 32, 4), (2, 32), (2, 32)] if out["which"] == "finest_offset" else [(2, 32)]
    assert shapes[:4] == [(2, 4092)] * 2 + [(2, 52)] * 2
    assert shapes[4:4 + len(head)] == head and len(shapes) == 6 + len(head)
    assert assert_losses_and_gradients_match(out, LOSSES) > 30
    # RESIZE_ROI shrank refined boxes between the two stages
    if out["which"] == "finest_offset":
        assert len(out["shrunk"]) == 1 and out["shrunk"][0] > 0
    else:
        assert out["shrunk"] == []


def test_option_models_bridge_and_labels(option_outputs):
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.utils.param_bridge import name_map

    out = option_outputs
    assert_bridge_round_trip(out)
    params, model = out["params"], out["model"]
    names = name_map(params)
    new = {"offset_conv", "offset_fc"} if out["which"] == "finest_offset" else {"se"}
    assert all(any(f".{n}." in k for k in names.values()) for n in new)
    assert not any(".offset_emb." in k for k in names.values())
    for freeze_at in (0, 2):
        want = _flat(param_label_tree(params, freeze_at))
        got = classify_params(model, freeze_at)
        assert set(got) == set(names.values())
        for path, key in names.items():
            assert got[key] == want[path], (freeze_at, key)


def test_unused_offset_branch_moves_by_weight_decay_and_imports():
    """OFFSET_ON under FUSED_ON: no loss reaches the offset branch; a train
    step gives it a zero gradient, so that SGD's weight decay moves it as
    optax's moves the JAX package's (first step: p - lr * wd * p). And the
    reference checkpoint importer reads the branch."""
    import chip_smoke
    import torch

    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.utils.weight_import import import_cpm_checkpoint

    cfg = options_cfg("finest_offset")
    model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    got = import_cpm_checkpoint(chip_smoke.reference_state_dict(sd, cfg.MODEL.CONV1_RGB2BGR), cfg)
    assert sorted(got) == sorted(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    branch = {k: p for k, p in model.named_parameters() if ".offset_" in k}
    assert len(branch) == 8
    before = {k: p.detach().clone() for k, p in branch.items()}
    state, metrics = make_train_step(cfg, model, optimizer)(state, synthetic_batch(
        2, 64, 64, max_gt=4, num_classes=9))
    lr, wd = metrics["lr"], cfg.SOLVER.WEIGHT_DECAY
    for k, p in branch.items():
        assert p.grad is not None and not p.grad.any(), k
        # biases take no weight decay (SOLVER.BIAS_WEIGHT_DECAY False)
        decay = 0.0 if k.endswith(".bias") else wd
        want = (before[k].double() * (1 - lr * decay)).float()
        torch.testing.assert_close(p.detach(), want, rtol=1.2e-7, atol=0)
        assert k.endswith(".bias") or not torch.equal(p.detach(), before[k]), k
