"""Training targets, sampling and losses of the port against the JAX package.

Identical numpy inputs from a seed go through each JAX function and its
port. The samplers' uniform draws are the JAX side's own: made here with
`jax.random.uniform` on the keys the JAX functions use (`balanced_sample`
splits its key) and passed to the port as numpy. Masks and integer outputs
must match exactly, floats to atol 1e-5.

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.modeling.roi_heads import grid_ops as jax_grid_ops
from cpm_tpu.modeling.roi_heads import targets as jax_targets
from cpm_tpu.modeling.rpn import AnchorLayout as JaxAnchorLayout
from cpm_tpu.modeling.rpn import rpn_losses as jax_rpn_losses
from cpm_tpu.modeling.rpn import select_proposals as jax_select_proposals
from cpm_tpu.ops import losses as jax_losses
from cpm_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from cpm_tpu.structures.boxes import box_iou as jax_box_iou
from cpm_tpu.utils import matcher as jax_matcher
from cpm_tpu.utils import sampler as jax_sampler
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)


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


ATOL = 1e-5


def _t(x):
    import torch

    return torch.from_numpy(np.asarray(x))


def _boxes(rng, shape, size=200.0):
    x1 = rng.rand(*shape) * size
    y1 = rng.rand(*shape) * size
    w = rng.rand(*shape) * size * 0.5 + 4
    h = rng.rand(*shape) * size * 0.5 + 4
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _gt(rng, B=2, G=5, num_classes=9):
    boxes = _boxes(rng, (B, G))
    labels = rng.randint(1, num_classes, (B, G)).astype(np.int32)
    mask = np.ones((B, G), bool)
    mask[0, 3:] = False
    mask[1, 4:] = False
    return boxes, labels, mask


def _proposals(rng, gt_boxes, K=60):
    """Random boxes, plus jittered and exact copies of the gt boxes so that
    every label class (positive, background, ignored) occurs."""
    B, G = gt_boxes.shape[:2]
    props = _boxes(rng, (B, K))
    props[:, :G] = gt_boxes + rng.randn(B, G, 4).astype(np.float32) * 3
    props[:, G:2 * G] = gt_boxes
    mask = rng.rand(B, K) > 0.2
    return props, mask


def _uniform_pair(key, shape):
    kp, kn = jax.random.split(key)
    return np.array(jax.random.uniform(kp, shape)), np.array(jax.random.uniform(kn, shape))


@pytest.mark.parametrize("low_quality", [False, True])
def test_match_boxes_matches_jax(low_quality):
    import torch

    from cpm_tpu_torch.utils import matcher

    assert (matcher.BELOW_LOW_THRESHOLD, matcher.BETWEEN_THRESHOLDS) == (
        jax_matcher.BELOW_LOW_THRESHOLD, jax_matcher.BETWEEN_THRESHOLDS)
    rng = np.random.RandomState(0)
    gt_boxes, _, gt_mask = _gt(rng)
    props, _ = _proposals(rng, gt_boxes)
    quality = np.array(jax_box_iou(jnp.asarray(gt_boxes), jnp.asarray(props)))
    quality[:, :, 20] = quality[:, :, 21]  # ties across predictions
    quality[:, 1, 30] = quality[:, 0, 30]  # and across gt rows
    want = jax_matcher.match_boxes(
        jnp.asarray(quality), jnp.asarray(gt_mask), 0.7, 0.3, low_quality)
    got = matcher.match_boxes(_t(quality), _t(gt_mask), 0.7, 0.3, low_quality)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {-1, -2} <= set(np.unique(np.asarray(want))) and np.asarray(want).max() >= 0


@pytest.mark.parametrize("k", [0, 5, 17, 1000])
def test_sample_k_from_mask_matches_jax(k):
    from cpm_tpu_torch.utils.sampler import sample_k_from_mask

    rng = np.random.RandomState(1)
    mask = rng.rand(3, 200) > 0.7
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.uniform(key, mask.shape))
    noise[0, 5] = noise[0, 9] = noise[0, 2]  # ties break by index
    mask[0, [2, 5, 9]] = True
    want = np.asarray(jax_sampler.sample_k_from_mask(jnp.asarray(mask), k, key))
    got = sample_k_from_mask(_t(mask), k, _t(noise)).numpy()
    np.testing.assert_array_equal(got.sum(-1), np.minimum(k, mask.sum(-1)))
    # the JAX side drew its own noise from the key: equal except the forced ties
    noise_jax = np.array(jax.random.uniform(key, mask.shape))
    got_plain = sample_k_from_mask(_t(mask), k, _t(noise_jax)).numpy()
    np.testing.assert_array_equal(got_plain, want)
    # per-row k as a tensor
    ks = np.array([3, 0, 40])
    got_rows = sample_k_from_mask(_t(mask), _t(ks), _t(noise_jax)).numpy()
    np.testing.assert_array_equal(got_rows.sum(-1), np.minimum(ks, mask.sum(-1)))
    assert not (got_rows & ~mask).any()


def test_sample_k_breaks_ties_by_index_and_draws_from_a_generator():
    import torch

    from cpm_tpu_torch.utils.sampler import Draws, balanced_sample, sample_k_from_mask

    mask = torch.tensor([[True, True, False, True, True]])
    noise = torch.tensor([[0.5, 0.2, 0.0, 0.2, 0.2]])
    got = sample_k_from_mask(mask, 2, noise)
    assert got.tolist() == [[False, True, False, True, False]]
    with pytest.raises(ValueError):
        sample_k_from_mask(mask, 2)
    a = sample_k_from_mask(mask, 2, generator=torch.Generator().manual_seed(1))
    b = sample_k_from_mask(mask, 2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and int(a.sum()) == 2
    sp, sn = balanced_sample(mask, ~mask, 4, 0.5, generator=torch.Generator().manual_seed(2))
    assert int(sp.sum()) == 2 and int(sn.sum()) == 1
    # Draws: a generator on the CPU, or arrays in call order with shape checks
    d1, d2 = (Draws(torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(d1((2, 3), "cpu"), d2((2, 3), "cpu")) and d1.shapes == [(2, 3)]
    d = Draws([np.zeros((2, 3), np.float32)])
    assert d((2, 3), "cpu").shape == (2, 3)
    with pytest.raises(IndexError):
        d((2, 3), "cpu")
    with pytest.raises(ValueError):
        Draws([np.zeros((2, 3), np.float32)])((3, 2), "cpu")


@pytest.mark.parametrize("batch_size,fraction", [(16, 0.25), (64, 0.5), (8, 1.0)])
def test_balanced_sample_matches_jax(batch_size, fraction):
    from cpm_tpu_torch.utils.sampler import balanced_sample

    rng = np.random.RandomState(2)
    pos = rng.rand(2, 300) > 0.95
    neg = ~pos & (rng.rand(2, 300) > 0.3)
    key = jax.random.PRNGKey(11)
    want_p, want_n = jax_sampler.balanced_sample(
        jnp.asarray(pos), jnp.asarray(neg), batch_size, fraction, key)
    npos, nneg = _uniform_pair(key, pos.shape)
    got_p, got_n = balanced_sample(_t(pos), _t(neg), batch_size, fraction, _t(npos), _t(nneg))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert (got_p.sum(-1) + got_n.sum(-1) <= batch_size).all()


def test_assign_targets_and_subsample_rois_match_jax():
    import torch

    from cpm_tpu_torch.modeling.roi_heads import targets
    from cpm_tpu_torch.ops.box_coder import BoxCoder

    rng = np.random.RandomState(3)
    gt_boxes, gt_labels, gt_mask = _gt(rng)
    props, prop_mask = _proposals(rng, gt_boxes)
    weights = (10.0, 10.0, 5.0, 5.0)
    kw = dict(fg_iou_threshold=0.5, bg_iou_threshold=0.3)
    jargs = [jnp.asarray(a) for a in (props, prop_mask, gt_boxes, gt_labels, gt_mask)]
    targs = [_t(a) for a in (props, prop_mask, gt_boxes, gt_labels, gt_mask)]

    want = jax_targets.assign_targets(*jargs, box_coder=JaxBoxCoder(weights), **kw)
    got = targets.assign_targets(*targs, box_coder=BoxCoder(weights), **kw)
    assert got["labels"].dtype == torch.int32
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert {-1, 0} <= set(np.unique(np.asarray(want["labels"])))
    for k in ("reg_targets", "matched_gt", "matched_iou"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=ATOL, err_msg=k)

    key = jax.random.PRNGKey(5)
    skw = dict(batch_size_per_image=56, positive_fraction=0.25, **kw)
    want_s = jax_targets.subsample_rois(*jargs, key, box_coder=JaxBoxCoder(weights), **skw)
    npos, nneg = _uniform_pair(key, prop_mask.shape)
    got_s = targets.subsample_rois(
        *targs, _t(npos), _t(nneg), box_coder=BoxCoder(weights), **skw)
    assert got_s._fields == want_s._fields
    for f in ("mask", "labels", "is_pos"):
        np.testing.assert_array_equal(getattr(got_s, f).numpy(), np.asarray(getattr(want_s, f)), f)
    for f in ("boxes", "reg_targets", "matched_gt", "matched_iou"):
        np.testing.assert_allclose(
            getattr(got_s, f).numpy(), np.asarray(getattr(want_s, f)), rtol=0, atol=ATOL, err_msg=f)
    assert got_s.is_pos.any() and (got_s.labels == -1).any() and (got_s.labels == 0).any()


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("ratio", [1.0, 0.5, 0.25])
def test_grid_targets_match_jax(ratio, refine):
    from cpm_tpu_torch.modeling.roi_heads.grid_ops import grid_targets

    rng = np.random.RandomState(4)
    N = 24
    boxes = _boxes(rng, (N,))
    gt = boxes + rng.randn(N, 4).astype(np.float32) * 12
    gt[:4] = boxes[:4] + np.array([60, 60, 90, 90], np.float32)  # grid points outside the map
    boxes[4] = [10, 10, 11.5, 11.5]                              # too small after expansion
    valid = rng.rand(N) > 0.2
    valid[:5] = True
    kw = dict(mapping_ratio=ratio, grid_points=9, roi_feat_size=14, pos_radius=1,
              target_refine=refine)
    want = jax_grid_ops.grid_targets(jnp.asarray(boxes), jnp.asarray(gt), jnp.asarray(valid), **kw)
    got = grid_targets(_t(boxes), _t(gt), _t(valid), **kw)
    assert tuple(got.shape) == (N, 9, 28, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got[4].any() and not got[~_t(valid)].any()


def test_losses_match_jax():
    from cpm_tpu_torch.ops import losses

    rng = np.random.RandomState(5)
    pred = rng.randn(40, 4).astype(np.float32)
    target = (pred + rng.randn(40, 4) * 0.2).astype(np.float32)
    w = (rng.rand(40, 1) > 0.5).astype(np.float32)
    mask = rng.rand(40, 4) > 0.4
    cases = [
        (jax_losses.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(target), 1 / 9, jnp.asarray(w), 7.0),
         losses.smooth_l1_loss(_t(pred), _t(target), 1 / 9, _t(w), 7.0)),
        (jax_losses.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(target), 1.0, None, 0.25),
         losses.smooth_l1_loss(_t(pred), _t(target), 1.0, None, 0.25)),
        (jax_losses.l2_loss(jnp.asarray(pred), jnp.asarray(target)),
         losses.l2_loss(_t(pred), _t(target))),
        (jax_losses.l2_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask)),
         losses.l2_loss(_t(pred), _t(target), _t(mask))),
        (jax_losses.binary_cross_entropy_with_logits(jnp.asarray(pred * 8), jnp.asarray(w * 1.0)),
         losses.binary_cross_entropy_with_logits(_t(pred * 8), _t(w * 1.0))),
        (jax_losses.binary_cross_entropy_with_logits(
            jnp.asarray(pred * 8), jnp.asarray(w * 1.0), jnp.asarray(mask)),
         losses.binary_cross_entropy_with_logits(_t(pred * 8), _t(w * 1.0), _t(mask))),
        (jax_losses.binary_cross_entropy_with_logits(
            jnp.asarray(pred), jnp.asarray(w), jnp.zeros((40, 4), bool)),
         losses.binary_cross_entropy_with_logits(_t(pred), _t(w), _t(np.zeros((40, 4), bool)))),
    ]
    for i, (want, got) in enumerate(cases):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=ATOL, err_msg=str(i))


def test_softmax_cross_entropy_matches_jax_with_ignored_labels():
    import torch

    from cpm_tpu_torch.ops.losses import softmax_cross_entropy

    rng = np.random.RandomState(6)
    logits = (rng.randn(30, 9) * 4).astype(np.float32)
    labels = rng.randint(-1, 9, 30).astype(np.int32)
    mask = labels >= 0
    logits[~mask] = np.inf  # a masked row must not poison the sum
    for m in (mask, np.zeros(30, bool)):
        want = jax_losses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(m))
        got = softmax_cross_entropy(_t(logits), _t(labels), _t(m))
        assert torch.isfinite(got)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=ATOL)
    ok = mask
    want = jax_losses.softmax_cross_entropy(jnp.asarray(logits[ok]), jnp.asarray(labels[ok]))
    got = softmax_cross_entropy(_t(logits[ok]), _t(labels[ok]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=ATOL)
    # not the reduction of F.cross_entropy(ignore_index): the divisor is the mask's count
    want_manual = -np.mean([jax.nn.log_softmax(jnp.asarray(logits[i]))[labels[i]]
                            for i in np.nonzero(mask)[0]])
    np.testing.assert_allclose(float(softmax_cross_entropy(_t(logits), _t(labels), _t(mask))),
                               want_manual, rtol=1e-5)


@pytest.mark.parametrize("n_valid", [0, 1, 2, 9])
def test_ism_l2_loss_matches_jax(n_valid):
    from cpm_tpu_torch.ops.losses import ism_l2_loss

    rng = np.random.RandomState(7)
    N = 12
    pred = rng.randn(N, 2).astype(np.float32)
    iou = rng.rand(N).astype(np.float32)
    iou[1] = 1.0  # a zero bg target
    target = np.stack([1 - iou, iou], -1)
    valid = np.zeros(N, bool)
    valid[rng.permutation(N)[:n_valid]] = True
    want = jax_losses.ism_l2_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(valid))
    p = _t(pred).requires_grad_()
    got = ism_l2_loss(p, _t(target), _t(valid))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=ATOL)
    want_g = jax.grad(lambda x: jax_losses.ism_l2_loss(x, jnp.asarray(target), jnp.asarray(valid)))(
        jnp.asarray(pred))
    got.backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=ATOL)
    if n_valid == 0:
        assert float(got.detach()) == 0.0


SHAPES = ((16, 20), (8, 10), (4, 5), (2, 3), (1, 2))
STRIDES = (4, 8, 16, 32, 64)
SIZES = (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)


def _layouts(straddle=0.0):
    from cpm_tpu_torch.modeling.rpn import AnchorLayout

    return (JaxAnchorLayout(SHAPES, STRIDES, SIZES, RATIOS, straddle_thresh=straddle),
            AnchorLayout(SHAPES, STRIDES, SIZES, RATIOS, straddle_thresh=straddle))


def _head_outputs(rng, B=2, A=3, scale=1.0):
    obj = [(rng.randn(B, h, w, A) * scale).astype(np.float32) for h, w in SHAPES]
    reg = [(rng.randn(B, h, w, 4 * A) * 0.3).astype(np.float32) for h, w in SHAPES]
    return obj, reg


@pytest.mark.parametrize("straddle", [0.0, 8.0, -1.0])
def test_anchor_visibility_matches_jax(straddle):
    jl, tl = _layouts(straddle)
    sizes = np.array([[64, 80], [50, 61]], np.int32)
    want = np.asarray(jl.visibility(jnp.asarray(sizes)))
    got = tl.visibility(_t(sizes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, sum(tl.level_sizes))
    if straddle >= 0:
        assert got.any() and not got.all() and got[0].sum() > got[1].sum()


def _rows(boxes, scores, mask):
    rows = np.concatenate([boxes[mask], scores[mask][:, None]], 1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("per_batch", [True, False])
def test_select_proposals_train_branch_matches_jax_as_masked_sets(per_batch):
    from cpm_tpu_torch.modeling.rpn import select_proposals

    rng = np.random.RandomState(8)
    jl, tl = _layouts()
    obj, reg = _head_outputs(rng)
    sizes = np.array([[64, 80], [56, 72]], np.int32)
    gt_boxes, _, gt_mask = _gt(rng)
    gt_boxes = np.clip(gt_boxes * 0.25, 0, 60).astype(np.float32)
    kw = dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.7, min_size=0,
              fpn_post_nms_top_n=30, fpn_post_nms_per_batch=per_batch, is_train=True)
    wb, ws, wm = jax_select_proposals(
        jl, [jnp.asarray(o) for o in obj], [jnp.asarray(r) for r in reg], jnp.asarray(sizes),
        gt_boxes=jnp.asarray(gt_boxes), gt_mask=jnp.asarray(gt_mask), approx_topk=False, **kw)
    gb, gs, gm = select_proposals(
        tl, [_t(o) for o in obj], [_t(r) for r in reg], _t(sizes),
        gt_boxes=_t(gt_boxes), gt_mask=_t(gt_mask), **kw)
    assert tuple(gb.shape) == tuple(wb.shape) == (2, 30 + gt_boxes.shape[1], 4)
    wm, gm = np.asarray(wm), gm.numpy()
    np.testing.assert_array_equal(gm.sum(1), wm.sum(1))
    # the appended gt slots come last, in order
    np.testing.assert_array_equal(gm[:, 30:], gt_mask)
    np.testing.assert_array_equal(gb[:, 30:].numpy(), gt_boxes)
    assert (gs[:, 30:].numpy() == 1.0).all()
    for i in range(2):
        np.testing.assert_allclose(
            _rows(gb[i].numpy(), gs[i].numpy(), gm[i]),
            _rows(np.asarray(wb[i]), np.asarray(ws[i]), wm[i]), rtol=0, atol=1e-4)
    if per_batch:
        # the batch-wide top-k leaves 30 proposals over the batch, not per image
        assert gm[:, :30].sum() == 30


def test_rpn_losses_and_gradients_match_jax():
    from cpm_tpu_torch.modeling.rpn import rpn_losses

    rng = np.random.RandomState(9)
    jl, tl = _layouts()
    obj, reg = _head_outputs(rng, scale=2.0)
    sizes = np.array([[64, 80], [56, 72]], np.int32)
    gt_boxes, _, gt_mask = _gt(rng)
    gt_boxes = np.clip(gt_boxes * 0.3, 0, 62).astype(np.float32)
    key = jax.random.PRNGKey(13)
    kw = dict(fg_iou_threshold=0.7, bg_iou_threshold=0.3, batch_size_per_image=64,
              positive_fraction=0.5, smooth_l1_beta=1 / 9)

    def jax_total(o, r):
        lo, lb = jax_rpn_losses(jl, o, r, jnp.asarray(sizes), jnp.asarray(gt_boxes),
                                jnp.asarray(gt_mask), key, **kw)
        return lo + lb, (lo, lb)

    (_, (want_o, want_b)), (go, gr) = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(o) for o in obj], [jnp.asarray(r) for r in reg])
    n_anchors = (2, sum(tl.level_sizes))
    npos, nneg = _uniform_pair(key, n_anchors)
    to = [_t(o).requires_grad_() for o in obj]
    tr = [_t(r).requires_grad_() for r in reg]
    got_o, got_b = rpn_losses(tl, to, tr, _t(sizes), _t(gt_boxes), _t(gt_mask),
                              _t(npos), _t(nneg), **kw)
    assert float(want_o) > 0 and float(want_b) > 0
    np.testing.assert_allclose(float(got_o.detach()), float(want_o), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(float(got_b.detach()), float(want_b), rtol=1e-6, atol=ATOL)
    (got_o + got_b).backward()
    for got, want in zip(to + tr, list(go) + list(gr)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-5, atol=ATOL)
