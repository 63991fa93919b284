"""The port's trunk, FPN, RPN head, anchors, proposal selection, NMS and box
coder against the JAX package, on identical numpy inputs in f32.

The flax parameters go through cpm_tpu_torch.utils.param_bridge. Proposal
sets are compared as sets: top-k and NMS may order equal scores differently.

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker (see tests/test_torch_roi_align.py).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.modeling.backbone.resnet import ResNetBody as JaxResNetBody
from cpm_tpu.modeling.fpn import FPN as JaxFPN
from cpm_tpu.modeling.rpn import AnchorLayout as JaxAnchorLayout
from cpm_tpu.modeling.rpn import RPNHead as JaxRPNHead
from cpm_tpu.modeling.rpn import generate_cell_anchors as jax_cell_anchors
from cpm_tpu.modeling.rpn import select_proposals as jax_select_proposals
from cpm_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from cpm_tpu.ops.nms import batched_nms as jax_batched_nms
from cpm_tpu.ops.nms import multiclass_nms as jax_multiclass_nms
from cpm_tpu.ops.nms import nms as jax_nms
from cpm_tpu.structures.boxes import box_iou as jax_box_iou
from cpm_tpu.structures.boxes import clip_boxes_to_image as jax_clip


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


STRIDES = (4, 8, 16, 32, 64)
SIZES = (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)


def _trunk():
    from torch import nn

    from cpm_tpu_torch.modeling.backbone.resnet import ResNetBody
    from cpm_tpu_torch.modeling.fpn import FPN
    from cpm_tpu_torch.modeling.rpn import RPNHead

    trunk = nn.Module()
    trunk.backbone = ResNetBody(layers=(1, 1, 1, 1), base_planes=8)
    trunk.fpn = FPN(trunk.backbone.dim_out, fpn_dim=32)
    trunk.rpn_head = RPNHead(32, 3)
    return trunk


@pytest.fixture(scope="module")
def trunk_outputs():
    import torch

    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    jb = JaxResNetBody(layers=(1, 1, 1, 1), base_planes=8)
    jf = JaxFPN(fpn_dim=32)
    jr = JaxRPNHead(num_anchors=3)

    @jax.jit
    def init_and_apply(x):
        pb = jb.init(jax.random.PRNGKey(0), x)["params"]
        c = jb.apply({"params": pb}, x)
        pf = jf.init(jax.random.PRNGKey(1), c)["params"]
        p = jf.apply({"params": pf}, c)
        pr = jr.init(jax.random.PRNGKey(2), p)["params"]
        logits, regs = jr.apply({"params": pr}, p)
        return (pb, pf, pr), (c, p, logits, regs)

    (pb, pf, pr), (c, p, logits, regs) = init_and_apply(x)
    want = dict(c=c, p=p, logits=logits, regs=regs)

    trunk = _trunk()
    params = jax.device_get({"backbone": pb, "fpn": pf, "rpn_head": pr})
    load_flax_params(trunk, params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        ct = trunk.backbone(xt)
        pt = trunk.fpn(ct)
        lt, rt = trunk.rpn_head(pt)
    got = dict(
        c=[f.permute(0, 2, 3, 1) for f in ct], p=[f.permute(0, 2, 3, 1) for f in pt],
        logits=lt, regs=rt,
    )
    return want, got


def _close(got, want, atol=1e-4):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    # f32 convolutions summed in another order; maps smaller than 1 (the RPN
    # outputs are ~1e-2) get the tolerance scaled down with them
    tol = atol * min(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["c", "p", "logits", "regs"])
def test_trunk_fpn_rpn_head_match_jax(trunk_outputs, name):
    want, got = trunk_outputs
    assert len(got[name]) == len(want[name])
    for g, w in zip(got[name], want[name]):
        _close(g, w)


def test_cell_anchors_and_layout_match_jax_exactly():
    from cpm_tpu_torch.modeling.rpn import AnchorLayout, generate_cell_anchors

    for s, sz in zip(STRIDES, SIZES):
        np.testing.assert_array_equal(
            generate_cell_anchors(s, (sz,), RATIOS), jax_cell_anchors(s, (sz,), RATIOS)
        )
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    want = JaxAnchorLayout(shapes, STRIDES, SIZES, RATIOS)
    got = AnchorLayout(shapes, STRIDES, SIZES, RATIOS)
    assert got.level_sizes == want.level_sizes
    for g, w in zip(got.on("cpu"), want.per_level):
        np.testing.assert_array_equal(g.numpy(), w)


def _valid_rows(boxes, scores, mask):
    rows = np.concatenate([boxes[mask], scores[mask][:, None]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize(
    "shapes,pre,post,fpn_post",
    [
        ([(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)], 32, 16, 24),
        ([(32, 40), (16, 20), (8, 10), (4, 5), (2, 3)], 200, 60, 150),
    ],
)
def test_select_proposals_matches_jax_as_sets(shapes, pre, post, fpn_post):
    import torch

    from cpm_tpu_torch.modeling.rpn import AnchorLayout, select_proposals

    rng = np.random.RandomState(1)
    obj = [rng.randn(2, h, w, 3).astype(np.float32) for h, w in shapes]
    reg = [(0.3 * rng.randn(2, h, w, 12)).astype(np.float32) for h, w in shapes]
    sizes = np.array([[shapes[0][0] * 4, shapes[0][1] * 4], [shapes[0][0] * 3, shapes[0][1] * 4 - 7]],
                     np.int32)
    kw = dict(pre_nms_top_n=pre, post_nms_top_n=post, nms_thresh=0.7, min_size=0,
              fpn_post_nms_top_n=fpn_post)
    layout = JaxAnchorLayout(shapes, STRIDES, SIZES, RATIOS)
    wb, ws, wm = jax.jit(
        lambda o, r, s: jax_select_proposals(
            layout, o, r, s, fpn_post_nms_per_batch=True, is_train=False, **kw
        )
    )(obj, reg, sizes)
    gb, gs, gm = select_proposals(
        AnchorLayout(shapes, STRIDES, SIZES, RATIOS), [torch.from_numpy(o) for o in obj],
        [torch.from_numpy(r) for r in reg], torch.from_numpy(sizes), **kw,
    )
    assert tuple(gb.shape) == tuple(wb.shape)
    for i in range(2):
        want = _valid_rows(np.asarray(wb[i]), np.asarray(ws[i]), np.asarray(wm[i]))
        got = _valid_rows(gb[i].numpy(), gs[i].numpy(), gm[i].numpy())
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _random_boxes(rng, n):
    ctr = rng.rand(n, 2) * 100
    wh = rng.rand(n, 2) * 40 + 2
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_matches_jax(thresh):
    import torch

    from cpm_tpu_torch.ops.nms import nms

    rng = np.random.RandomState(2)
    boxes = _random_boxes(rng, 120)
    scores = rng.rand(120).astype(np.float32)
    mask = rng.rand(120) > 0.2
    wi, wk = jax.jit(lambda b, s, m: jax_nms(b, s, thresh, 50, mask=m))(boxes, scores, mask)
    gi, gk = nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, 50,
                 mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gi.numpy()[gk.numpy()], np.asarray(wi)[np.asarray(wk)])


@pytest.mark.parametrize(
    "name,jax_fn", [("batched_nms", jax_batched_nms), ("multiclass_nms", jax_multiclass_nms)]
)
def test_batched_nms_matches_jax_per_image(name, jax_fn):
    import torch

    from cpm_tpu_torch.ops import nms

    port_fn = getattr(nms, name)
    rng = np.random.RandomState(3)
    boxes = np.stack([_random_boxes(rng, 80) for _ in range(2)])
    scores = rng.rand(2, 80).astype(np.float32)
    labels = rng.randint(1, 4, (2, 80)).astype(np.int32)
    mask = rng.rand(2, 80) > 0.1
    gi, gk = port_fn(torch.from_numpy(boxes), torch.from_numpy(scores),
                     torch.from_numpy(labels), 0.4, 40, mask=torch.from_numpy(mask))
    run = jax.jit(lambda b, s, l, m: jax_fn(b, s, l, 0.4, 40, mask=m))
    for b in range(2):
        wi, wk = run(boxes[b], scores[b], labels[b], mask[b])
        np.testing.assert_array_equal(gk[b].numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gi[b].numpy()[gk[b].numpy()], np.asarray(wi)[np.asarray(wk)])


def test_box_coder_iou_and_clip_match_jax():
    import torch

    from cpm_tpu_torch.ops.box_coder import BoxCoder
    from cpm_tpu_torch.structures.boxes import box_iou, clip_boxes_to_image

    rng = np.random.RandomState(4)
    boxes = _random_boxes(rng, 50)
    deltas = (rng.randn(50, 8) * 0.5).astype(np.float32)
    deltas[0, 2] = 10.0  # beyond the dw clamp
    for weights in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        want = JaxBoxCoder(weights).decode(jnp.asarray(deltas), jnp.asarray(boxes))
        got = BoxCoder(weights).decode(torch.from_numpy(deltas), torch.from_numpy(boxes))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
        gt = boxes + rng.randn(50, 4).astype(np.float32)
        want = JaxBoxCoder(weights).encode(jnp.asarray(gt), jnp.asarray(boxes))
        got = BoxCoder(weights).encode(torch.from_numpy(gt), torch.from_numpy(boxes))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for plus1 in (True, False):
        want = jax_box_iou(jnp.asarray(boxes), jnp.asarray(boxes[:20]), legacy_plus1=plus1)
        got = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes[:20]), legacy_plus1=plus1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    want = jax_clip(jnp.asarray(boxes), (80, 60))
    got = clip_boxes_to_image(torch.from_numpy(boxes), (80, 60))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
