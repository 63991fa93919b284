"""The port's test-time augmentation against the JAX package's, on the CPU.

* soft-NMS (`soft_nms`, `ml_soft_nms`; linear, gaussian, hard) and box
  voting (`box_voting`, `box_ml_voting`; the six scoring methods) against
  cpm_tpu.ops.nms on seeded boxes in clusters, with masked entries and tied
  scores: indices and keep masks exactly, scores 1e-5, voted boxes rtol 1e-5
  (coordinates reach 200, where an f32 ulp is 1.5e-5);
* `merge_tta_detections` on the four scenarios of tests/test_tta_merge.py and
  on seeded sets under hard NMS, soft-NMS and soft-NMS with voting: the kept
  sets exactly (count, labels, order), boxes and scores as above;
* `run_inference_on_dataset` with TEST.BBOX_AUG on (the flip and two scales,
  six passes) and soft-NMS on cfgs/debug/tiny_cpm.yaml over two synthetic
  images, with the JAX package's params bridged into the port: each pass's
  images exactly and its detections at the tolerances of
  tests/test_torch_eval_cli.py::_assert_same_results (boxes 1e-2 px, scores
  1e-5, labels exactly); and the loop on the JAX package's per-pass
  detections, whose results equal the JAX package's to 1e-5.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpm_tpu.data.loader as jax_loader_mod
from cpm_tpu.config import get_default_cfg as jax_default_cfg
from cpm_tpu.ops.nms import box_ml_voting as jax_box_ml_voting
from cpm_tpu.ops.nms import box_voting as jax_box_voting
from cpm_tpu.ops.nms import ml_soft_nms as jax_ml_soft_nms
from cpm_tpu.ops.nms import soft_nms as jax_soft_nms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORING_METHODS = ("ID", "TEMP_AVG", "AVG", "IOU_AVG", "GENERALIZED_AVG", "QUASI_SUM")


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


def _boxes(rng, n, n_objects=6, span=200.0):
    """n boxes jittered around a few objects (so that many overlap), some
    far apart; scores on a grid of 0.05, so that many tie."""
    centers = rng.uniform(20, span - 20, (n_objects, 2))
    sizes = rng.uniform(10, 60, (n_objects, 2))
    k = rng.randint(0, n_objects, n)
    c = centers[k] + rng.normal(0, 4, (n, 2))
    wh = sizes[k] * rng.uniform(0.8, 1.2, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).clip(0, span).astype(np.float32)
    scores = (rng.randint(1, 20, n) * 0.05).astype(np.float32)
    labels = rng.randint(1, 4, n).astype(np.int32)
    mask = rng.uniform(size=n) > 0.2
    return boxes, scores, labels, mask


def _t(*arrays):
    import torch

    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("labelled", [False, True], ids=["soft_nms", "ml_soft_nms"])
@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
def test_soft_nms_matches_jax(method, labelled):
    from cpm_tpu_torch.ops import nms

    rng = np.random.RandomState(3)
    boxes, scores, labels, mask = _boxes(rng, 80)
    assert len(np.unique(scores[mask])) < mask.sum() / 2  # many ties
    kw = dict(sigma=0.5, overlap_thresh=0.3, score_thresh=0.01, method=method)
    if labelled:
        want = jax_ml_soft_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                               60, mask=jnp.asarray(mask), **kw)
        b, s, lab, m = _t(boxes, scores, labels, mask)
        got = nms.ml_soft_nms(b, s, lab, 60, mask=m, **kw)
    else:
        want = jax_soft_nms(jnp.asarray(boxes), jnp.asarray(scores), 60,
                            mask=jnp.asarray(mask), **kw)
        b, s, m = _t(boxes, scores, mask)
        got = nms.soft_nms(b, s, 60, mask=m, **kw)
    w_idx, w_scores, w_valid = (np.asarray(x) for x in want)
    g_idx, g_scores, g_valid = (x.numpy() for x in got)
    np.testing.assert_array_equal(g_valid, w_valid)
    np.testing.assert_array_equal(g_idx, w_idx)
    np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=1e-5)
    assert 5 < w_valid.sum() < 60


@pytest.mark.parametrize("labelled", [False, True], ids=["box_voting", "box_ml_voting"])
@pytest.mark.parametrize("scoring", SCORING_METHODS)
def test_box_voting_matches_jax(scoring, labelled):
    from cpm_tpu_torch.ops import nms

    rng = np.random.RandomState(4)
    boxes, scores, labels, mask = _boxes(rng, 90)
    scores[:3] = 0.0  # the TEMP_AVG transform passes zero through
    top = rng.choice(90, 20, replace=False)
    top_mask = rng.uniform(size=20) > 0.2
    kw = dict(scoring_method=scoring, beta=2.0)
    jx = [jnp.asarray(a) for a in (boxes[top], scores[top], labels[top], boxes, scores, labels)]
    pt = _t(boxes[top], scores[top], labels[top], boxes, scores, labels)
    jm, pm = [jnp.asarray(top_mask), jnp.asarray(mask)], _t(top_mask, mask)
    if labelled:
        want = jax_box_ml_voting(*jx, 0.5, top_mask=jm[0], pool_mask=jm[1], **kw)
        got = nms.box_ml_voting(*pt, 0.5, top_mask=pm[0], pool_mask=pm[1], **kw)
    else:
        want = jax_box_voting(jx[0], jx[1], jx[3], jx[4], 0.5, top_mask=jm[0],
                              pool_mask=jm[1], **kw)
        got = nms.box_voting(pt[0], pt[1], pt[3], pt[4], 0.5, top_mask=pm[0], pool_mask=pm[1],
                             **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)


def _pass(boxes, scores, labels):
    return dict(boxes=np.asarray(boxes, np.float32), scores=np.asarray(scores, np.float32),
                labels=np.asarray(labels, np.int32), mask=np.ones(len(boxes), bool))


def _scenario_cfgs(option):
    """Both packages' configs of one scenario of tests/test_tta_merge.py."""
    from cpm_tpu_torch.config import get_default_cfg

    out = []
    for cfg in (jax_default_cfg(), get_default_cfg()):
        cfg.FAST_RCNN.SCORE_THRESH = 0.05
        cfg.FAST_RCNN.NMS = 0.5
        cfg.FAST_RCNN.DETECTIONS_PER_IMG = 8
        if option == "soft_nms":
            cfg.TEST.SOFT_NMS.ENABLED = True
        if option == "box_voting":
            cfg.TEST.BBOX_VOTE.ENABLED = True
            cfg.TEST.BBOX_VOTE.VOTE_TH = 0.5
        if option == "soft_nms_voting":
            cfg.FAST_RCNN.DETECTIONS_PER_IMG = 40
            cfg.TEST.SOFT_NMS.ENABLED = True
            cfg.TEST.SOFT_NMS.METHOD = "gaussian"
            cfg.TEST.BBOX_VOTE.ENABLED = True
            cfg.TEST.BBOX_VOTE.SCORING_METHOD = "TEMP_AVG"
        out.append(cfg)
    return out


SCENARIOS = {
    "cross_pass_duplicates": ("hard", [
        ([[10, 10, 50, 50], [100, 100, 160, 160]], [0.9, 0.8], [1, 2]),
        ([[11, 11, 51, 51], [101, 99, 161, 159], [200, 200, 240, 240]], [0.85, 0.82, 0.7],
         [1, 2, 1])]),
    "different_labels": ("hard", [([[10, 10, 50, 50]], [0.9], [1]),
                                  ([[10, 10, 50, 50]], [0.8], [2])]),
    "soft_nms": ("soft_nms", [([[10, 10, 50, 50]], [0.9], [1]),
                              ([[11, 11, 51, 51]], [0.85], [1])]),
    "box_voting": ("box_voting", [([[10, 10, 50, 50]], [0.6], [1]),
                                  ([[14, 14, 54, 54]], [0.6], [1])]),
}


def _seeded_passes(seed, n_passes=4, k=30):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_passes):
        boxes, scores, labels, mask = _boxes(rng, k)
        out.append(dict(boxes=boxes, scores=scores, labels=labels, mask=mask))
    return out


def _assert_same_merge(got, want):
    keep = np.asarray(want["mask"])
    np.testing.assert_array_equal(got["mask"].numpy(), keep)
    np.testing.assert_array_equal(got["labels"].numpy()[keep], np.asarray(want["labels"])[keep])
    np.testing.assert_allclose(got["boxes"].numpy()[keep], np.asarray(want["boxes"])[keep],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy()[keep], np.asarray(want["scores"])[keep],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", list(SCENARIOS) + ["seeded_hard", "seeded_soft_nms",
                                                    "seeded_soft_nms_voting"])
def test_merge_tta_detections_matches_jax(case):
    import torch

    from cpm_tpu.engine.test import merge_tta_detections as jax_merge

    from cpm_tpu_torch.engine.test import merge_tta_detections

    if case in SCENARIOS:
        option, raw = SCENARIOS[case]
        passes = [_pass(*p) for p in raw]
    else:
        option = case[len("seeded_"):]
        passes = _seeded_passes(5)
    want_cfg, got_cfg = _scenario_cfgs(option)
    want = jax_merge(want_cfg, passes)
    got = merge_tta_detections(got_cfg, [{f: torch.from_numpy(v) for f, v in p.items()}
                                         for p in passes])
    _assert_same_merge(got, want)
    assert want["mask"].sum() >= 1
    if case == "cross_pass_duplicates":
        assert int(want["mask"].sum()) == 3


def test_merge_tta_detections_is_batched():
    """Rows of a batch merge as they do alone."""
    import torch

    from cpm_tpu_torch.engine.test import merge_tta_detections

    _, cfg = _scenario_cfgs("soft_nms_voting")
    rows = [_seeded_passes(seed) for seed in (6, 7)]
    batched = merge_tta_detections(cfg, [
        {f: torch.from_numpy(np.stack([rows[0][p][f], rows[1][p][f]])) for f in rows[0][p]}
        for p in range(len(rows[0]))])
    for r, passes in enumerate(rows):
        alone = merge_tta_detections(cfg, [{f: torch.from_numpy(v) for f, v in p.items()}
                                           for p in passes])
        for f, v in alone.items():
            assert torch.equal(batched[f][r], v), f


def _same_sets(got, want, what, box_atol=1e-2, score_atol=1e-5):
    """Two detection sets (numpy fields, one image) hold the same masked
    entries: counts and labels exactly, boxes and scores within the
    tolerances, paired one to one."""
    gm, wm = got["mask"].astype(bool), want["mask"].astype(bool)
    assert gm.sum() == wm.sum(), what
    have = list(zip(got["labels"][gm], got["boxes"][gm], got["scores"][gm]))
    for lw, bw, sw in zip(want["labels"][wm], want["boxes"][wm], want["scores"][wm]):
        for j, (lh, bh, sh) in enumerate(have):
            if lh == lw and np.abs(bh - bw).max() <= box_atol and abs(sh - sw) <= score_atol:
                del have[j]
                break
        else:
            raise AssertionError(f"{what}: no detection matches ({lw}, {bw}, {sw})")


def test_tta_inference_matches_jax(monkeypatch, tmp_path):
    """Each pass's forward (its loader's flip and scale included) against the
    JAX package's at the tolerances of _assert_same_results; then the port's
    loop fed the JAX package's per-pass detections, whose results must equal
    the JAX package's to 1e-5. The two are held apart because random weights
    give zero-width boxes at the image border, whose IoUs are 0/0 in one
    package and any value in the other under 1e-5 of noise: the merge turns
    the forwards' agreement within 1e-5 into different kept sets there."""
    import torch

    import cpm_tpu.engine.test as jax_engine
    from cpm_tpu.data.coco import build_dataset as jax_build_dataset
    from cpm_tpu.modeling.model import build_model as jax_build_model
    from test_torch_eval_cli import _assert_same_results, _cfgs

    import cpm_tpu_torch.engine.test as engine
    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.modeling.roi_heads.box_head import Detections
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    monkeypatch.setattr(jax_loader_mod, "_native", lambda: None)  # the JAX PIL path
    want_cfg, got_cfg = _cfgs(
        "TPU.COMPUTE_DTYPE", "float32", "CKPT", str(tmp_path), "TEST.BBOX_AUG.ENABLED", "True",
        "TEST.BBOX_AUG.H_FLIP", "True", "TEST.BBOX_AUG.SCALES", "(48, 96)",
        "TEST.BBOX_AUG.MAX_SIZE", "200", "TEST.SOFT_NMS.ENABLED", "True",
        # random weights score near 1/9; the merge keeps FAST_RCNN's threshold
        "FAST_RCNN.SCORE_THRESH", "0.0")
    assert [(p["scale"], p["hflip"]) for p in engine.tta_passes(got_cfg)] == [
        (None, False), (None, True), (48, False), (48, True), (96, False), (96, True)]
    (jd,) = jax_build_dataset(want_cfg, want_cfg.TEST.DATASETS, is_train=False)
    (pd,) = build_dataset(got_cfg, got_cfg.TEST.DATASETS, is_train=False)

    jm = jax_build_model(want_cfg)
    images = np.zeros((1, 64, 128, 3), np.uint8)
    sizes = np.array([[64, 128]], np.int32)
    params = jax.device_get(jax.jit(
        lambda i, s: jm.init({"params": jax.random.PRNGKey(0)}, i, s, train=False)["params"]
    )(images, sizes))

    def recording(make, calls, to_np):
        def make_forward_fn(*args):
            forward = make(*args)

            def recorded(images, image_sizes):
                dets = forward(images, image_sizes)
                calls.append((np.array(images), {f: to_np(v) for f, v in dets._asdict().items()}))
                return dets
            return recorded
        return make_forward_fn

    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_engine, "make_forward_fn",
                        recording(jax_engine.make_forward_fn, jax_calls, np.array))
    want = jax_engine.run_inference_on_dataset(want_cfg, jm, params, jd, start=0, end=2,
                                               progress_every=0)
    model = load_flax_params(build_model(got_cfg, "cpu"), params)
    with monkeypatch.context() as m:
        m.setattr(engine, "make_forward_fn", recording(
            engine.make_forward_fn, port_calls, lambda v: v.float().numpy() if v.is_floating_point()
            else v.numpy()))
        seconds = []
        engine.run_inference_on_dataset(got_cfg, model, pd, start=0, end=2, progress_every=0,
                                        batch_seconds=seconds)
    assert len(jax_calls) == len(port_calls) == 12 and len(seconds) == 2
    for k, ((jimg, jdets), (pimg, pdets)) in enumerate(zip(jax_calls, port_calls)):
        np.testing.assert_array_equal(pimg, jimg, err_msg=f"forward {k}'s images")
        _same_sets({f: v[0] for f, v in pdets.items()}, {f: v[0] for f, v in jdets.items()},
                   f"image {k // 6} pass {k % 6}")

    replay = iter(jax_calls)

    def replaying(cfg, model):
        def forward(images, image_sizes):
            jimg, jdets = next(replay)
            np.testing.assert_array_equal(np.asarray(images), jimg)
            return Detections(**{f: torch.from_numpy(v) for f, v in jdets.items()})
        return forward

    monkeypatch.setattr(engine, "make_forward_fn", replaying)
    got = engine.run_inference_on_dataset(got_cfg, model, pd, start=0, end=2, progress_every=0)
    assert {r["image_id"] for r in want} == {jd.id_to_img_map[i] for i in range(2)}
    assert len(want) > 20
    _assert_same_results(got, want, box_atol=1e-5, score_atol=1e-5)
