"""The port's loss zoo, matrix NMS, RoIPool and point sampling, and rotated
ops against the JAX package's, on the CPU.

The same seeded numpy arrays go through `cpm_tpu` and `cpm_tpu_torch`.
Tolerances: f32 values and gradients rtol 1e-5 / atol 1e-6 (`F32`); rotated
IoU atol 1e-4 (`ROT`: the clip runs in another order of operations); NMS keep
sets equal, except for a box whose deciding IoU lies within 1e-5 of the
threshold, which the test names. Gradients are taken against a seeded
cotangent where the output is not a scalar. Each JAX side is one program
compiled at XLA's backend optimisation level 0 (`_jit`): run op by op, the
rotated clip alone took seconds. `roi_pool`'s is run op by op: compiled,
XLA rewrites its bin-bound arithmetic (`floor(py * roi_w / pw)`), and a
bound that lands on a whole cell moves by one cell, where the op-by-op JAX
program and the port agree bit for bit.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.ops import losses as jl
from cpm_tpu.ops import rotated as jr
from cpm_tpu.ops.nms import matrix_nms as jax_matrix_nms
from cpm_tpu.ops.roi_pool import pool_points_interp as jax_pool_points
from cpm_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

F32 = dict(rtol=1e-5, atol=1e-6)
ROT = dict(rtol=0.0, atol=1e-4)


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


def _jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _t(a, grad=False):
    import torch

    return torch.tensor(np.asarray(a), requires_grad=grad)


def _np(t):
    return t.detach().numpy()


def _compare(jax_fn, port_fn, args, grad_args, tol=F32, cotangent_seed=0, jit=_jit):
    """Values of jax_fn(*args) and port_fn(*args), and the gradients of
    <output, cotangent> with respect to args[i] for i in grad_args."""
    want = np.asarray(jit(jax_fn)(*[jnp.asarray(a) for a in args]))
    ts = [_t(a, i in grad_args) for i, a in enumerate(args)]
    got = port_fn(*ts)
    np.testing.assert_allclose(_np(got), want, **tol)
    if not grad_args:
        return
    cot = np.asarray(np.random.RandomState(cotangent_seed).randn(*want.shape), np.float32)

    def scalar(*xs):
        return jnp.sum(jax_fn(*xs) * cot)

    g_want = jit(jax.grad(scalar, argnums=tuple(grad_args)))(*[jnp.asarray(a) for a in args])
    (got * _t(cot)).sum().backward()
    for i, gw in zip(grad_args, g_want):
        np.testing.assert_allclose(_np(ts[i].grad), np.asarray(gw), **tol)


def _xyxy(rng, n, span=60.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(2, span / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------- losses


def test_sigmoid_focal_loss():
    from cpm_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(0)
    logits = rng.randn(40, 7).astype(np.float32)
    labels = rng.randint(-1, 8, 40).astype(np.int32)
    _compare(lambda x, y: jl.sigmoid_focal_loss(x, y, 8),
             lambda x, y: tl.sigmoid_focal_loss(x, y, 8), (logits, labels), (0,))


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
@pytest.mark.parametrize("masked", [False, True])
def test_iou_loss(loss_type, masked):
    from cpm_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(1)
    pred, target = _xyxy(rng, 32), _xyxy(rng, 32)
    pred[:16] = target[:16] + rng.uniform(-3, 3, (16, 4)).astype(np.float32)
    mask = rng.rand(32) > 0.3
    args = (pred, target, mask) if masked else (pred, target)
    _compare(lambda *a: jl.iou_loss(*a, loss_type=loss_type),
             lambda *a: tl.iou_loss(*a, loss_type=loss_type), args, (0, 1))


@pytest.mark.parametrize("loss_type", ["iou", "liou", "giou", "diou", "ciou"])
def test_iou_loss_lrtb(loss_type):
    from cpm_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(2)
    pred = rng.uniform(1, 20, (24, 4)).astype(np.float32)
    target = rng.uniform(1, 20, (24, 4)).astype(np.float32)
    weight = rng.rand(24).astype(np.float32)
    _compare(lambda *a: jl.iou_loss_lrtb(*a, loss_type=loss_type),
             lambda *a: tl.iou_loss_lrtb(*a, loss_type=loss_type), (pred, target, weight), (0,))
    _compare(lambda *a: jl.iou_loss_lrtb(*a, loss_type=loss_type),
             lambda *a: tl.iou_loss_lrtb(*a, loss_type=loss_type), (pred, target), (0,))


def test_bounded_iou_and_label_smoothing_and_dice():
    from cpm_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(3)
    pred, target = _xyxy(rng, 20), _xyxy(rng, 20)
    mask = rng.rand(20) > 0.25
    _compare(jl.bounded_iou_loss, tl.bounded_iou_loss, (pred, target, mask), (0,))
    logits = rng.randn(30, 6).astype(np.float32)
    labels = rng.randint(-1, 6, 30).astype(np.int32)
    _compare(lambda x, y, m: jl.label_smoothing_ce(x, y, 0.2, m),
             lambda x, y, m: tl.label_smoothing_ce(x, y, 0.2, m),
             (logits, labels, labels >= 0), (0,))
    seg = rng.randn(3, 1, 9, 11).astype(np.float32)
    tgt = (rng.rand(3, 1, 9, 11) > 0.6).astype(np.float32)
    _compare(jl.dice_loss, tl.dice_loss, (seg, tgt), (0,))


def test_lovasz_hinge():
    from cpm_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(4)
    logits = rng.randn(3, 10, 12).astype(np.float32)
    labels = (rng.rand(3, 10, 12) > 0.5).astype(np.float32)
    _compare(jl.lovasz_hinge, tl.lovasz_hinge, (logits, labels), (0,))


@pytest.mark.parametrize("ignore_index,only_present", [(None, True), (255, True), (255, False)])
def test_lovasz_softmax(ignore_index, only_present):
    """The port takes NCHW logits, as the reference does; the JAX package NHWC."""
    from cpm_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(5)
    logits = rng.randn(2, 5, 8, 9).astype(np.float32)
    labels = rng.randint(0, 4, (2, 8, 9)).astype(np.int32)  # class 4 absent
    labels[rng.rand(2, 8, 9) < 0.2] = 255 if ignore_index else 0
    _compare(lambda x, y: jl.lovasz_softmax(jnp.transpose(x, (0, 2, 3, 1)), y, ignore_index,
                                            only_present),
             lambda x, y: tl.lovasz_softmax(x, y, ignore_index, only_present),
             (logits, labels), (0,))


def test_smooth_l1_lw_mask_iou_and_equalization():
    from cpm_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(6)
    pred, tgt = rng.randn(2, 4, 8).astype(np.float32), rng.randn(2, 4, 8).astype(np.float32)
    w_in, w_out = rng.rand(2, 4, 8).astype(np.float32), rng.rand(2, 4, 8).astype(np.float32)
    _compare(lambda *a: jl.smooth_l1_loss_LW(*a, beta=0.5),
             lambda *a: tl.smooth_l1_loss_LW(*a, beta=0.5), (pred, tgt, w_in, w_out), (0,))
    rays_p = rng.uniform(1, 10, (12, 36)).astype(np.float32)
    rays_t = rng.uniform(1, 10, (12, 36)).astype(np.float32)
    _compare(jl.mask_iou_loss, tl.mask_iou_loss, (rays_p, rays_t, rng.rand(12).astype(np.float32)),
             (0,))
    logits = rng.randn(25, 9).astype(np.float32)
    labels = rng.randint(-1, 9, 25).astype(np.int32)
    freq = np.array([0.5, 1e-3, 0.2, 1e-4, 0.1, 1e-3, 0.3, 0.01, 1e-5], np.float32)
    _compare(lambda x, y, m: jl.equalization_loss(x, y, jnp.asarray(freq), mask=m),
             lambda x, y, m: tl.equalization_loss(x, y, _t(freq), mask=m),
             (logits, labels, labels >= 0), (0,))


# ---------------------------------------------------------------- matrix NMS


@pytest.mark.parametrize("method", ["gauss", "linear"])
def test_matrix_nms(method):
    from cpm_tpu_torch.ops.nms import matrix_nms
    from cpm_tpu_torch.structures.boxes import box_iou

    rng = np.random.RandomState(7)
    boxes = _xyxy(rng, 60, span=40.0)
    scores = rng.rand(60).astype(np.float32)
    labels = rng.randint(0, 3, 60).astype(np.int32)
    mask = rng.rand(60) > 0.1
    want = _jit(lambda *a: jax_matrix_nms(*a, method=method, sigma=0.5))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(mask))
    got = matrix_nms(_t(boxes), _t(scores), _t(labels), _t(mask), method=method, sigma=0.5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    # the JAX package compensates each pair with the suppressed box's own
    # worst overlap, where SOLOv2 takes the suppressor's, so no factor falls
    # below 1 and no score decays (ROADMAP Queue 3); the port copies it
    iou = _np(box_iou(_t(boxes), _t(boxes), legacy_plus1=False))
    same = (labels[:, None] == labels[None, :]) & mask[:, None] & mask[None, :]
    assert (np.triu(iou * same, 1) > 0.2).sum() > 5
    np.testing.assert_array_equal(_np(got), scores)


# ---------------------------------------------------------------- RoIPool, points


def _rois(rng, n, batch, span, size):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(1, size, (n, 2))
    b = rng.randint(0, batch, (n, 1))
    return np.concatenate([b, xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("roi_size,max_cells", [(24.0, 8), (120.0, 4)])
def test_roi_pool(roi_size, max_cells):
    """Bins below and above `max_cells_per_bin` (the second case has bins of
    up to 8 cells against a lattice of 4, where both packages read the first
    4 cells a side); values and gradients on inputs with no ties."""
    from cpm_tpu_torch.ops.roi_pool import roi_pool

    rng = np.random.RandomState(8)
    feats = rng.randn(2, 16, 20, 5).astype(np.float32)
    rois = _rois(rng, 12, 2, 60.0, roi_size)
    cells = (rois[:, 3:5] - rois[:, 1:3]) * 0.25 / 3
    assert (cells.max() > max_cells) == (roi_size > 100)
    _compare(lambda f, r: jax_roi_pool(f, r, (3, 3), 0.25, max_cells),
             lambda f, r: roi_pool(f, r, (3, 3), 0.25, max_cells), (feats, rois), (0,),
             jit=lambda fn: fn)


def test_roi_pool_ties_share_the_gradient(monkeypatch):
    """A map of few distinct values, so that most bins' maxima are tied:
    JAX's and the port's gradients share them alike among the tied cells.
    One roi a chunk gives the unchunked result. (The shapes are the first
    case's, whose JAX primitives are then compiled already.)"""
    import cpm_tpu_torch.ops.roi_pool as mod

    rng = np.random.RandomState(9)
    feats = rng.randint(0, 3, (2, 16, 20, 5)).astype(np.float32)
    rois = _rois(rng, 12, 2, 60.0, 24.0)
    monkeypatch.setattr(mod, "CHUNK_BYTES", 1)
    _compare(lambda f, r: jax_roi_pool(f, r, (3, 3), 0.25, 8),
             lambda f, r: mod.roi_pool(f, r, (3, 3), 0.25, 8), (feats, rois), (0,),
             jit=lambda fn: fn)


def test_pool_points_interp():
    from cpm_tpu_torch.ops.roi_pool import pool_points_interp

    rng = np.random.RandomState(10)
    feats = rng.randn(2, 12, 14, 6).astype(np.float32)
    pts = np.concatenate([rng.randint(0, 2, (50, 1)),
                          rng.uniform(-12, 70, (50, 2))], 1).astype(np.float32)
    _compare(lambda f, p: jax_pool_points(f, p, 0.25),
             lambda f, p: pool_points_interp(f, p, 0.25), (feats, pts), (0, 1))


# ---------------------------------------------------------------- rotated


def _rotated(rng, n, span=50.0):
    c = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(3, span / 2, (n, 2))
    a = rng.uniform(-90, 90, (n, 1))
    return np.concatenate([c, wh, a], 1).astype(np.float32)


def test_corners_areas_and_rotated_iou():
    from cpm_tpu_torch.ops import rotated as tr

    rng = np.random.RandomState(11)
    b1, b2 = _rotated(rng, 30), _rotated(rng, 25)
    b2[:5] = b1[:5] + np.array([0.5, -0.5, 1, 1, 7], np.float32)  # near copies
    corners, inter, want_iou = _jit(lambda x, y: (
        jr.rotated_box_corners(x), jr.rotated_pair_intersection_area(x, y),
        jr.box_iou_rotated(x, y)))(jnp.asarray(b1), jnp.asarray(b2))
    np.testing.assert_allclose(_np(tr.rotated_box_corners(_t(b1))), np.asarray(corners), **F32)
    np.testing.assert_allclose(_np(tr.rotated_pair_intersection_area(_t(b1), _t(b2))),
                               np.asarray(inter), rtol=0.0, atol=1e-2)  # areas reach 600 px^2
    iou = _np(tr.box_iou_rotated(_t(b1), _t(b2)))
    np.testing.assert_allclose(iou, np.asarray(want_iou), **ROT)
    assert (iou > 0.3).sum() >= 5
    # quadrilaterals: the same boxes by their corners (no pair is a box with
    # itself, whose every vertex lies on a clipping line)
    q1, q2 = (_np(tr.rotated_box_corners(_t(b))).reshape(-1, 8) for b in (b1, b2))
    np.testing.assert_allclose(_np(tr.quad_area(_t(q1))), b1[:, 2] * b1[:, 3], rtol=1e-5)
    poly = _np(tr.poly_iou(_t(q1), _t(q2)))
    np.testing.assert_allclose(poly, np.asarray(_jit(jr.poly_iou)(jnp.asarray(q1),
                                                                  jnp.asarray(q2))), **ROT)
    np.testing.assert_allclose(poly, iou, **ROT)


def _same_keeps(got, want, iou, scores, mask, thresh):
    """Equal keep sets, save for boxes whose fate an IoU within 1e-5 of the
    threshold decides; returns those boxes."""
    got_set = {int(i) for i, k in zip(*got) if k}
    want_set = {int(i) for i, k in zip(*want) if k}
    order = np.argsort(-np.where(mask, scores, -np.inf), kind="stable")
    near = {int(order[c]) for r in range(len(order)) for c in range(r + 1, len(order))
            if abs(iou[order[r], order[c]] - thresh) < 1e-5}
    assert got_set ^ want_set <= near, (sorted(got_set ^ want_set), sorted(near))
    return near


@pytest.mark.parametrize("kind", ["rotated", "poly"])
def test_rotated_and_poly_nms(kind):
    from cpm_tpu_torch.ops import rotated as tr

    rng = np.random.RandomState(12)
    boxes = _rotated(rng, 80, span=30.0)
    scores = rng.rand(80).astype(np.float32)
    mask = rng.rand(80) > 0.1
    if kind == "poly":
        boxes = _np(tr.rotated_box_corners(_t(boxes))).reshape(-1, 8)
        jax_fn, port_fn, iou_fn = jr.poly_nms, tr.poly_nms, tr.poly_iou
    else:
        jax_fn, port_fn, iou_fn = jr.nms_rotated, tr.nms_rotated, tr.box_iou_rotated
    want = _jit(lambda b, s, m: jax_fn(b, s, 0.3, 50, m))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask))
    got = port_fn(_t(boxes), _t(scores), 0.3, 50, _t(mask))
    want, got = [np.asarray(w) for w in want], [_np(g) for g in got]
    iou = _np(iou_fn(_t(boxes), _t(boxes)))
    _same_keeps(got, want, iou, scores, mask, 0.3)
    assert 5 < got[1].sum() < mask.sum()


def test_roi_align_rotated():
    from cpm_tpu_torch.ops.rotated import roi_align_rotated

    rng = np.random.RandomState(13)
    feats = rng.randn(2, 14, 16, 4).astype(np.float32)
    r = _rotated(rng, 10, span=60.0)
    rois = np.concatenate([rng.randint(0, 2, (10, 1)), r], 1).astype(np.float32)
    _compare(lambda f, x: jr.roi_align_rotated(f, x, (3, 4), 0.25, 2),
             lambda f, x: roi_align_rotated(f, x, (3, 4), 0.25, 2), (feats, rois), (0,))
    _compare(lambda f, x: jr.roi_align_rotated(f, x, (2, 2), 0.25, 0),
             lambda f, x: roi_align_rotated(f, x, (2, 2), 0.25, 0), (feats, rois), ())
