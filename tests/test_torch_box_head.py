"""The Fast R-CNN box head family and model: the JAX package against the port.

* `TwoMLPHead`, `ConvFCHead` (plain and dilated) and `BoxOutput` (class
  specific and agnostic), through the bridge: outputs to 1e-5 relative;
* `fast_rcnn_losses`, class specific and agnostic: 1e-5 relative;
* `decode_boxes_per_class`: 1e-4 px;
* `filter_detections` under hard NMS, soft-NMS (linear, gaussian) and box
  voting: the kept sets with labels and counts exactly, boxes 1e-3 px,
  scores 1e-5;
* the tiny Fast R-CNN model (cfgs/debug/tiny_fast_rcnn.yaml at FPN 32, MLP
  64, in f32), the port's seeded weights bridged into the JAX model: eval
  detections as above; one training
  forward and backward on the same batch and the same recorded draws
  (tests/test_torch_train.py::RecordedUniform), losses 1e-5 relative and
  gradients rtol 1e-3 / atol 1e-5; the bridge both ways;
* `train_net` then `test_net` with `--device cpu` on tiny_fast_rcnn.yaml;
* MODEL.RPN_ONLY: the proposals as detections and the RPN's losses;
* what is not ported raises NotImplementedError at build: a C4 model with a
  head other than Fast R-CNN's, a context module in the C5 head's stage 5
  and the ConvFC head's weight standardisation (the C4 family itself is
  held in tests/test_torch_c4.py).

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

from cpm_tpu.config import assert_and_infer_cfg, get_default_cfg, merge_cfg_from_file
from cpm_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from cpm_tpu.engine.train import batch_gt as jax_batch_gt
from cpm_tpu.modeling.model import build_model as jax_build_model
from cpm_tpu.modeling.roi_heads import box_head as jbh
from cpm_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from tests.test_torch_model import assert_same_detection_sets
from tests.test_torch_train import RecordedUniform, _flat
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)
from tests.torch_support import memo, shared

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "data")
SCALES = (0.25, 0.125, 0.0625, 0.03125)
CIN = 32


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


def _close(got, want, rtol=1e-5):
    """rtol relative to the tensor's largest magnitude (f32 sums in another
    order)."""
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _features(rng):
    shapes = [(32, 40), (16, 20), (8, 10), (4, 5)]
    feats = [rng.randn(2, h, w, CIN).astype(np.float32) for h, w in shapes]
    rois = np.zeros((20, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, 20)
    rois[:, 1:3] = rng.rand(20, 2) * 100
    rois[:, 3:5] = rois[:, 1:3] + rng.rand(20, 2) * 60 + 1
    return feats, rois, rng.rand(20) > 0.3


@pytest.mark.parametrize("head,agnostic", [
    ("two_mlp", False), ("two_mlp", True), ("convfc", False), ("convfc_dilated", True),
])
def test_box_head_and_output_match_jax(head, agnostic):
    import torch
    from torch import nn

    from cpm_tpu_torch.modeling.roi_heads.box_head import BoxOutput, ConvFCHead, TwoMLPHead
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    feats, rois, mask = _features(np.random.RandomState(1))
    if head == "two_mlp":
        jh = jbh.TwoMLPHead(scales=SCALES, sampling_ratio=2, mlp_dim=64)
        th = TwoMLPHead(CIN, (7, 7), SCALES, 2, 64)
    else:
        dil = 2 if head == "convfc_dilated" else 1
        jh = jbh.ConvFCHead(scales=SCALES, conv_dim=16, num_stacked_convs=2, mlp_dim=64,
                            dilation=dil)
        th = ConvFCHead(CIN, (7, 7), SCALES, 0, conv_dim=16, num_stacked_convs=2, mlp_dim=64,
                        dilation=dil)
    jo = jbh.BoxOutput(num_classes=7, cls_agnostic_bbox_reg=agnostic)

    @jax.jit
    def run(feats, rois, mask):
        ph = jh.init(jax.random.PRNGKey(0), feats, rois, mask)["params"]
        x = jh.apply({"params": ph}, feats, rois, mask)
        po = jo.init(jax.random.PRNGKey(1), x)["params"]
        return (ph, po), x, jo.apply({"params": po}, x)

    (ph, po), want_x, (want_cls, want_box) = run(feats, rois, mask)
    model = nn.Module()
    model.roi_head = nn.Module()
    model.roi_head.head = th
    model.roi_head.output = BoxOutput(64, 7, agnostic)
    load_flax_params(model, jax.device_get({"roi_head": {"head": ph, "output": po}}))
    with torch.no_grad():
        x = th([torch.from_numpy(f) for f in feats], torch.from_numpy(rois), torch.from_numpy(mask))
        cls, box = model.roi_head.output(x)
    assert cls.dtype == box.dtype == torch.float32
    assert box.shape[1] == (8 if agnostic else 28)
    _close(x, want_x)
    _close(cls, want_cls)
    _close(box, want_box)


@pytest.mark.parametrize("agnostic", [False, True], ids=["class_specific", "agnostic"])
def test_fast_rcnn_losses_match_jax(agnostic):
    import torch

    from cpm_tpu_torch.modeling.roi_heads.box_head import fast_rcnn_losses

    rng = np.random.RandomState(3)
    N, C = 48, 6
    logits = rng.randn(N, C).astype(np.float32) * 2
    box = rng.randn(N, 8 if agnostic else 4 * C).astype(np.float32)
    labels = rng.randint(-1, C, N).astype(np.int32)
    targets = rng.randn(N, 4).astype(np.float32)
    mask = ((labels >= 0) & (rng.rand(N) > 0.2)).astype(np.float32)
    kw = dict(smooth_l1_beta=1.0 / 9, cls_agnostic_bbox_reg=agnostic)
    want = jax.jit(lambda *a: jbh.fast_rcnn_losses(*a, **kw))(logits, box, labels, targets, mask)
    got = fast_rcnn_losses(*(torch.from_numpy(a) for a in (logits, box, labels, targets, mask)), **kw)
    for g, w in zip(got, want):
        assert float(w) > 0
        assert float(g) == pytest.approx(float(w), rel=1e-5)


@pytest.mark.parametrize("agnostic", [False, True], ids=["class_specific", "agnostic"])
def test_decode_boxes_per_class_matches_jax(agnostic):
    import torch

    from cpm_tpu_torch.modeling.roi_heads.box_head import decode_boxes_per_class
    from cpm_tpu_torch.ops.box_coder import BoxCoder

    rng = np.random.RandomState(4)
    B, K, C = 2, 30, 5
    xy = rng.rand(B, K, 2) * 150
    props = np.concatenate([xy, xy + rng.rand(B, K, 2) * 80 + 1], -1).astype(np.float32)
    deltas = (rng.randn(B, K, 8 if agnostic else 4 * C) * 2).astype(np.float32)
    sizes = np.array([[120, 200], [90, 160]], np.int32)
    w = (10.0, 10.0, 5.0, 5.0)
    want = jbh.decode_boxes_per_class(deltas, props, sizes, JaxBoxCoder(weights=w), C, agnostic)
    got = decode_boxes_per_class(torch.from_numpy(deltas), torch.from_numpy(props),
                                 torch.from_numpy(sizes), BoxCoder(w), C, agnostic)
    assert tuple(got.shape) == (B, K, C, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


FILTERS = {
    "hard": dict(),
    "soft_linear": dict(use_soft_nms=True, soft_nms_method="linear"),
    "soft_gaussian": dict(use_soft_nms=True, soft_nms_method="gaussian", soft_nms_sigma=0.5),
    "hard_vote": dict(use_box_voting=True, vote_thresh=0.7),
    "soft_vote_temp_avg": dict(use_soft_nms=True, use_box_voting=True, vote_thresh=0.7,
                               vote_scoring_method="TEMP_AVG", vote_beta=2.0),
}


def _rows(dets, b):
    return np.concatenate(
        [np.asarray(dets.labels[b])[np.asarray(dets.mask[b])][:, None].astype(np.float64),
         np.asarray(dets.boxes[b])[np.asarray(dets.mask[b])],
         np.asarray(dets.scores[b])[np.asarray(dets.mask[b])][:, None]], 1)


@pytest.mark.parametrize("name", list(FILTERS))
def test_filter_detections_matches_jax(name):
    import torch

    from cpm_tpu_torch.modeling.roi_heads.box_head import filter_detections

    rng = np.random.RandomState(6)
    B, K, C = 2, 40, 6
    # boxes crowd around a few centres so that NMS and voting have work
    ctr = rng.rand(B, 5, 2)[:, rng.randint(0, 5, K)] * 100 + rng.randn(B, K, 2)
    ctr = ctr[:, :, None, :]
    wh = rng.rand(B, K, C, 2) * 30 + 3
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    logits = rng.randn(B, K, C).astype(np.float32) * 2
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    mask = rng.rand(B, K) > 0.2
    kw = dict(score_thresh=0.05, nms_thresh=0.5, detections_per_img=25, **FILTERS[name])
    want = jax.jit(lambda b, p, m: jbh.filter_detections(b, p, m, **kw))(boxes, probs, mask)
    got = filter_detections(torch.from_numpy(boxes), torch.from_numpy(probs),
                            torch.from_numpy(mask), **kw)
    got = type(got)(*(t.numpy() for t in got))
    for f in ("boxes", "scores", "labels", "mask"):
        assert getattr(got, f).shape == np.asarray(getattr(want, f)).shape
    np.testing.assert_array_equal(got.scores[~got.mask], 0.0)
    for b in range(B):
        assert_same_detection_sets(_rows(got, b), _rows(want, b), box_atol=1e-3, score_atol=1e-5)


# ---------------------------------------------------------------------------
# the tiny Fast R-CNN model
# ---------------------------------------------------------------------------

TINY = os.path.join(REPO, "cfgs", "debug", "tiny_fast_rcnn.yaml")
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")


def tiny_cfg(path, **overrides):
    """A debug YAML on the JAX package's config, in f32 at FPN 32 and MLP 64;
    `overrides` maps dotted keys to values."""
    cfg = get_default_cfg()
    merge_cfg_from_file(path, cfg)
    cfg = assert_and_infer_cfg(cfg, make_immutable=False)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.FPN.DIM = 32
    cfg.FAST_RCNN.MLP_HEAD.MLP_DIM = 64
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


def model_outputs(cfg, prepare=None, batch=None, frames=("cpm_tpu.utils.sampler",),
                  share=None, compiler_options=None):
    """The port's seeded weights (passed to `prepare(model)` first, when
    given) bridged into the JAX model; both models' eval detections, and
    their losses and gradients on a seeded batch (or `batch`) with the same
    recorded draws (those of the JAX modules in `frames`). Shared by
    this file, tests/test_torch_cascade.py, tests/test_torch_grid_options.py,
    tests/test_torch_c4.py and tests/test_torch_zoo.py. With `share`
    (tmp_path_factory, name) the JAX side is computed once a session
    (tests/torch_support.py::shared): the port's weights are drawn from a
    seed, so each worker's are the same. `compiler_options` go to XLA's
    compile of the JAX side (tests/test_torch_zoo.py compiles at backend
    optimisation level 0: the same program, compiled with less work)."""
    import torch

    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import state_dict_to_flax
    from cpm_tpu_torch.utils.sampler import Draws

    if batch is None:
        batch = jax_synthetic_batch(2, 64, 64, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES)
    images = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[64, 64], [56, 48]], np.int32)
    gt = jax_batch_gt(batch)
    model = build_model(cfg, "cpu", seed=0)
    if prepare is not None:
        prepare(model)

    def jax_side():
        jm = jax_build_model(cfg)
        # the flax tree's structure from an abstract init (a compiled init
        # of the cascade costs about 10 s), its values the port's seeded
        # weights
        like = jax.eval_shape(
            lambda: jm.init({"params": jax.random.PRNGKey(0)}, images, sizes, train=False))["params"]
        params = state_dict_to_flax(
            model.state_dict(), jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), like))

        def loss_fn(p):
            losses = jm.apply({"params": p}, batch["images"], batch["image_sizes"], gt=gt,
                              train=True, rngs={"sample": jax.random.PRNGKey(1)})
            return sum(losses.values()), losses

        @jax.jit
        def run(params, images, sizes):
            dets = jm.apply({"params": params}, images, sizes, train=False)
            return dets, jax.value_and_grad(loss_fn, has_aux=True)(params)

        mp = pytest.MonkeyPatch()
        draws = RecordedUniform(7, frames)
        try:
            mp.setattr(jax.random, "uniform", draws)
            if compiler_options is not None:
                run = run.lower(params, images, sizes).compile(compiler_options=compiler_options)
            dets, ((_, losses), grads) = jax.device_get(run(params, images, sizes))
        finally:
            mp.undo()
        return dict(params=params, dets=dets, losses=losses, grads=grads, draws=draws.arrays)

    jx = jax_side() if share is None else shared(*share, jax_side)
    params, dets, losses, grads = jx["params"], jx["dets"], jx["losses"], jx["grads"]

    got_dets = make_forward_fn(cfg, model)(images, sizes)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    port_draws = Draws(jx["draws"])
    got_losses = model(tb["images"], tb["image_sizes"], train=True, draws=port_draws,
                       gt=dict(boxes=tb["gt_boxes"], labels=tb["gt_labels"], mask=tb["gt_mask"]))
    sum(got_losses.values()).backward()
    return dict(
        cfg=cfg, params=params, dets=dets, losses=losses, grads=grads, draws=jx["draws"],
        model=model, got_dets=got_dets, draw_shapes=port_draws.shapes,
        got_losses={k: float(v.detach()) for k, v in got_losses.items()},
    )


def assert_detections_match(got, want):
    """Fixed shapes alike; per image the valid sets with labels and counts
    exactly, boxes 1e-3 px, scores 1e-5."""
    got = type(got)(*(t.float().numpy() if t.is_floating_point() else t.numpy() for t in got))
    for f in ("boxes", "scores", "labels", "mask"):
        assert getattr(got, f).shape == np.asarray(getattr(want, f)).shape, f
    for b in range(got.mask.shape[0]):
        assert_same_detection_sets(_rows(got, b), _rows(want, b), box_atol=1e-3, score_atol=1e-5)


def assert_losses_and_gradients_match(out, names):
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named

    assert set(out["losses"]) == set(names) == set(out["got_losses"])
    for k in names:
        assert np.isfinite(out["losses"][k])
        assert out["got_losses"][k] == pytest.approx(float(out["losses"][k]), rel=1e-5), k
    model = out["model"]
    want = flax_tree_to_named(out["grads"], {k: tuple(p.shape) for k, p in model.named_parameters()})
    n = 0
    for k, p in model.named_parameters():
        if not p.requires_grad:
            continue
        # no gradient reached a parameter that no loss reads (OFFSET_ON's
        # branch under FUSED_ON): JAX's is zeros there
        got = np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[k], rtol=1e-3, atol=1e-5, err_msg=k)
        n += int(np.abs(want[k]).max() > 0)
    return n


def assert_bridge_round_trip(out):
    """Every flax leaf lands on one port parameter and every parameter
    receives one leaf; back to flax bit for bit."""
    from cpm_tpu_torch.utils.param_bridge import flax_to_state_dict, state_dict_to_flax

    model, params = out["model"], out["params"]
    sd = flax_to_state_dict(params, model)
    assert set(sd) == set(model.state_dict())
    assert len(jax.tree_util.tree_leaves(params)) == len(sd)
    back = _flat(state_dict_to_flax(model.state_dict(), params))
    want = _flat(params)
    assert set(back) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], np.asarray(leaf), err_msg=str(path))


@pytest.fixture(scope="module")
def fast_outputs(tmp_path_factory):
    return memo("box_head fast", lambda: model_outputs(
        tiny_cfg(TINY), share=(tmp_path_factory, "box_head_fast")))


def test_fast_rcnn_eval_matches_jax(fast_outputs):
    assert_detections_match(fast_outputs["got_dets"], fast_outputs["dets"])


def test_fast_rcnn_losses_and_gradients_match_jax(fast_outputs):
    out = fast_outputs
    # [B, anchors] twice (RPN), [B, proposals + gt] twice (the head's sample)
    assert [a.shape for a in out["draws"]] == out["draw_shapes"] == [(2, 1023)] * 2 + [(2, 104)] * 2
    assert assert_losses_and_gradients_match(out, LOSSES) > 20


def test_fast_rcnn_bridge_both_ways(fast_outputs):
    assert_bridge_round_trip(fast_outputs)
    names = {k for k in fast_outputs["model"].state_dict() if k.startswith("roi_head.")}
    assert names == {f"roi_head.{m}.{p}" for m in ("head.fc6", "head.fc7", "output.cls_score",
                                                    "output.bbox_pred") for p in ("weight", "bias")}


def test_fast_rcnn_cli_trains_and_evaluates_on_the_cpu(tmp_path):
    from cpm_tpu_torch.tools import test_net, train_net

    common = ["--cfg", TINY, "--device", "cpu", "CKPT", str(tmp_path), "DATA_DIR", DATA_DIR]
    history = train_net.main(common + ["SOLVER.MAX_ITER", "2", "SOLVER.SNAPSHOT_ITERS", "2"])
    assert [r["iter"] for r in history] == [1, 2]
    for r in history:
        assert sorted(k for k in r if k.startswith("loss_")) == sorted(LOSSES)
        assert all(np.isfinite(r[k]) for k in LOSSES)
    out = test_net.main(common + ["FAST_RCNN.SCORE_THRESH", "0.0"])
    with open(tmp_path / "test" / "bbox.json") as f:
        assert json.load(f) == out["results"]
    assert len(out["results"]) > 0 and "AP" in out["stats"]


def test_rpn_only_matches_jax():
    """MODEL.RPN_ONLY: the RPN's two losses, and its proposals as the
    detections (labels 0), against the JAX model's."""
    out = model_outputs(tiny_cfg(TINY, **{"MODEL.RPN_ONLY": True}))
    assert not any(k.startswith("roi_head.") for k in out["model"].state_dict())
    assert not (out["got_dets"].labels != 0).any()
    assert_detections_match(out["got_dets"], out["dets"])
    assert assert_losses_and_gradients_match(out, LOSSES[:2]) > 10


@pytest.mark.parametrize("case", ["c4_family", "convfc_ws", "c5_head"])
def test_unported_box_head_options_raise(case):
    """A C4 model with a head other than Fast R-CNN's raises at build, as the
    JAX package's Cascade and grid heads have no levels to pool there. The
    ConvFC head's weight standardisation, and the C5 head's stage 5 with an
    SE block, now run: their eval detections, losses and gradients match the
    JAX package's (as test_fast_rcnn_eval_matches_jax and
    test_fast_rcnn_losses_and_gradients_match_jax hold them)."""
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.modeling.ws import WSConv2d

    c4 = os.path.join(REPO, "cfgs", "debug", "tiny_fast_rcnn_c4.yaml")
    if case == "c4_family":
        cfg = tiny_cfg(c4, **{"MODEL.CASCADE_ON": True})
        with pytest.raises(NotImplementedError, match="C4 family"):
            build_model(cfg, "cpu")
        return
    if case == "convfc_ws":
        cfg = tiny_cfg(TINY, **{"FAST_RCNN.ROI_BOX_HEAD": "roi_xconv1fc_head",
                                "FAST_RCNN.CONVFC_HEAD.USE_WS": True,
                                "FAST_RCNN.CONVFC_HEAD.CONV_DIM": 32,
                                "FAST_RCNN.CONVFC_HEAD.NUM_STACKED_CONVS": 2})
    else:
        cfg = tiny_cfg(c4, **{"FAST_RCNN.ROI_BOX_HEAD": "resnet_c5_head",
                              "FAST_RCNN.ROI_XFORM_RESOLUTION": (14, 14),
                              "FAST_RCNN.SCORE_THRESH": 0.0,
                              "BACKBONE.RESNET.STAGE_WITH_CONTEXT": ("none",) * 3 + ("se",)})
    out = model_outputs(cfg)
    head = out["model"].roi_head.head
    if case == "convfc_ws":
        assert all(type(conv) is WSConv2d for conv in head.convs)
    else:
        assert {"fc1", "fc2"} <= {n for n, _ in head.layer4[0].context.named_children()}
    assert_detections_match(out["got_dets"], out["dets"])
    assert assert_losses_and_gradients_match(out, LOSSES) > 10
    assert_bridge_round_trip(out)
