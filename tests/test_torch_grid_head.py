"""The port's grid-head modules, grid decode and detection filter against
the JAX package, on identical numpy inputs in f32.

GridHead and GridOutput are driven through the `pooled=` path, as
tests/test_grid_cascade.py drives the JAX modules; parameters go through
cpm_tpu_torch.utils.param_bridge.

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker (see tests/test_torch_roi_align.py).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.modeling.roi_heads.box_head import filter_detections as jax_filter_detections
from cpm_tpu.modeling.roi_heads.grid_modules import ClsHead as JaxClsHead
from cpm_tpu.modeling.roi_heads.grid_modules import ClsOutput as JaxClsOutput
from cpm_tpu.modeling.roi_heads.grid_modules import GridHead as JaxGridHead
from cpm_tpu.modeling.roi_heads.grid_modules import GridOutput as JaxGridOutput
from cpm_tpu.modeling.roi_heads.grid_modules import grouped_deconv as jax_grouped_deconv
from cpm_tpu.modeling.roi_heads.grid_ops import _point_factors as jax_point_factors
from cpm_tpu.modeling.roi_heads.grid_ops import calc_sub_regions as jax_calc_sub_regions
from cpm_tpu.modeling.roi_heads.grid_ops import expand_boxes as jax_expand_boxes
from cpm_tpu.modeling.roi_heads.grid_ops import grid_decode as jax_grid_decode
from cpm_tpu.modeling.roi_heads.targets import compact_by_mask as jax_compact_by_mask
from cpm_tpu.modeling.roi_heads.targets import rois_with_batch_index as jax_rois_with_batch_index


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


SCALES = (0.25, 0.125, 0.0625, 0.03125)
P, PC, CIN = 9, 8, 32


def _scaled_close(got, want, atol=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    # f32 sums in another order; tensors smaller than 1 get the tolerance
    # scaled down with them
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * min(1.0, float(np.abs(want).max())))


def _heads(points, fused_on):
    from torch import nn

    from cpm_tpu_torch.modeling.roi_heads.grid_modules import GridHead, GridOutput

    heads = nn.Module()
    heads.roi_head = nn.Module()
    heads.roi_head.grid_heads = nn.ModuleList(
        [GridHead(CIN, points, 14, num_convs=2, point_feat_channels=PC, fused_on=fused_on)]
    )
    heads.roi_head.grid_outputs = nn.ModuleList(
        [GridOutput(points, PC, 14, iou_helper=True, fused_on=fused_on)]
    )
    return heads


# the neighbour fusion runs on a 2x2 grid: 16 transition convs instead of 48
@pytest.mark.parametrize("points,fused_on", [(9, False), (4, True)])
def test_grid_head_and_output_match_jax(points, fused_on):
    import torch

    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    rng = np.random.RandomState(0)
    pooled = rng.randn(6, 14, 14, CIN).astype(np.float32)
    mask = np.ones(6, bool)
    gh = JaxGridHead(grid_points=points, num_convs=2, point_feat_channels=PC, fused_on=fused_on)
    go = JaxGridOutput(grid_points=points, point_feat_channels=PC, iou_helper=True,
                       fused_on=fused_on)

    @jax.jit
    def run(pooled):
        ph = gh.init(jax.random.PRNGKey(0), None, None, mask, pooled=pooled)["params"]
        x, x_so, _ = gh.apply({"params": ph}, None, None, mask, pooled=pooled)
        po = go.init(jax.random.PRNGKey(1), x, x_so, None, train=True)["params"]
        hm, iou = go.apply({"params": po}, x, x_so, None, train=True)
        return (ph, po), (x, x_so, hm, iou)

    (ph, po), (x, x_so, hm, iou) = run(pooled)
    heads = _heads(points, fused_on)
    load_flax_params(heads, jax.device_get(
        {"roi_head": {"grid_head_0": ph, "grid_output_0": po}}
    ))
    with torch.no_grad():
        tx, tx_so, _ = heads.roi_head.grid_heads[0](pooled=torch.from_numpy(pooled))
        thm, tiou = heads.roi_head.grid_outputs[0](tx, tx_so, train=True)
    _scaled_close(tx, x)
    _scaled_close(thm["unfused"], hm["unfused"])
    _scaled_close(tiou, iou)
    if fused_on:
        _scaled_close(tx_so, x_so)
        _scaled_close(thm["fused"], hm["fused"])
    else:
        assert tx_so is None and thm["fused"] is None


def test_grouped_deconv_mapping():
    import torch
    from torch import nn

    from cpm_tpu_torch.utils.param_bridge import deconv_kernel_to_torch

    rng = np.random.RandomState(1)
    groups, cin_g, cout = 3, 4, 6
    x = rng.randn(2, 5, 7, groups * cin_g).astype(np.float32)
    kernel = rng.randn(4, 4, cin_g, cout).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    want = jax_grouped_deconv(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), groups)
    deconv = nn.ConvTranspose2d(groups * cin_g, cout, 4, stride=2, padding=1, groups=groups)
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(deconv_kernel_to_torch(kernel, groups)))
        deconv.bias.copy_(torch.from_numpy(bias))
        got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_cls_head_and_output_match_jax():
    import torch
    from torch import nn

    from cpm_tpu_torch.modeling.roi_heads.grid_modules import ClsHead, ClsOutput
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    rng = np.random.RandomState(2)
    shapes = [(32, 40), (16, 20), (8, 10), (4, 5)]
    feats = [rng.randn(2, h, w, CIN).astype(np.float32) for h, w in shapes]
    rois = np.zeros((20, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, 20)
    rois[:, 1:3] = rng.rand(20, 2) * 100
    rois[:, 3:5] = rois[:, 1:3] + rng.rand(20, 2) * 60 + 1
    mask = rng.rand(20) > 0.3
    ch = JaxClsHead(scales=SCALES, mlp_dim=64)
    co = JaxClsOutput(num_classes=9)

    @jax.jit
    def run(feats, rois, mask):
        pc = ch.init(jax.random.PRNGKey(0), feats, rois, mask)["params"]
        h = ch.apply({"params": pc}, feats, rois, mask)
        po = co.init(jax.random.PRNGKey(1), h)["params"]
        return (pc, po), co.apply({"params": po}, h)

    (pc, po), logits = run(feats, rois, mask)
    heads = nn.Module()
    heads.roi_head = nn.Module()
    heads.roi_head.cls_head = ClsHead(CIN, (7, 7), SCALES, 2, 64)
    heads.roi_head.cls_output = ClsOutput(64, 9)
    load_flax_params(heads, jax.device_get({"roi_head": {"cls_head": pc, "cls_output": po}}))
    with torch.no_grad():
        got = heads.roi_head.cls_output(heads.roi_head.cls_head(
            [torch.from_numpy(f) for f in feats], torch.from_numpy(rois), torch.from_numpy(mask)
        ))
    assert got.dtype == torch.float32
    _scaled_close(got, logits)


@pytest.mark.parametrize("ratio", [1.0, 0.5, 0.25])
def test_grid_decode_matches_jax(ratio):
    import torch

    from cpm_tpu_torch.modeling.roi_heads.grid_ops import grid_decode

    rng = np.random.RandomState(3)
    n = 12
    props = np.concatenate([rng.rand(n, 2) * 80, rng.rand(n, 2) * 80 + 90], 1).astype(np.float32)
    hm = (rng.randn(n, P, 28, 28) * 3).astype(np.float32)
    sizes = np.repeat(np.array([[150, 170]], np.int32), n, 0)
    want = jax_grid_decode(jnp.asarray(props), jnp.asarray(hm), jnp.asarray(sizes), mapping_ratio=ratio)
    got = grid_decode(torch.from_numpy(props), torch.from_numpy(hm), torch.from_numpy(sizes),
                      mapping_ratio=ratio)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_grid_geometry_helpers_match_jax():
    import torch

    from cpm_tpu_torch.modeling.roi_heads.grid_ops import (
        _point_factors,
        calc_sub_regions,
        expand_boxes,
    )

    for pts, size in ((9, 3), (4, 2), (16, 4)):
        assert calc_sub_regions(pts, size, 56) == jax_calc_sub_regions(pts, size, 56)
        np.testing.assert_array_equal(_point_factors(pts, size), jax_point_factors(pts, size))
    boxes = np.random.RandomState(4).rand(7, 4).astype(np.float32) * 50
    np.testing.assert_allclose(
        expand_boxes(torch.from_numpy(boxes), 0.5).numpy(),
        np.asarray(jax_expand_boxes(jnp.asarray(boxes), 0.5)), rtol=0, atol=1e-6,
    )


def test_compact_and_rois_with_batch_index_match_jax():
    import torch

    from cpm_tpu_torch.modeling.roi_heads.targets import compact_by_mask, rois_with_batch_index

    rng = np.random.RandomState(5)
    select = rng.rand(3, 11) > 0.5
    wi, wv = jax_compact_by_mask(jnp.asarray(select), 11)
    gi, gv = compact_by_mask(torch.from_numpy(select), 11)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    boxes = rng.rand(3, 4, 4).astype(np.float32)
    np.testing.assert_array_equal(
        rois_with_batch_index(torch.from_numpy(boxes)).numpy(),
        np.asarray(jax_rois_with_batch_index(jnp.asarray(boxes))),
    )


def _det_rows(boxes, scores, labels, mask):
    rows = np.concatenate([labels[mask][:, None].astype(np.float32), boxes[mask], scores[mask][:, None]], 1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("score_thresh,nms_thresh", [(0.05, 0.5), (0.0, 0.3)])
def test_filter_detections_matches_jax(score_thresh, nms_thresh):
    import torch

    from cpm_tpu_torch.modeling.roi_heads.box_head import filter_detections

    rng = np.random.RandomState(6)
    B, K, C = 2, 40, 6
    ctr = rng.rand(B, K, 1, 2) * 100
    wh = rng.rand(B, K, C, 2) * 30 + 3
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    logits = rng.randn(B, K, C).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = rng.rand(B, K) > 0.2
    kw = dict(score_thresh=score_thresh, nms_thresh=nms_thresh, detections_per_img=25)
    want = jax.jit(lambda b, p, m: jax_filter_detections(b, p, m, **kw))(boxes, probs, mask)
    got = filter_detections(torch.from_numpy(boxes), torch.from_numpy(probs), torch.from_numpy(mask), **kw)
    for f in ("boxes", "scores", "labels", "mask"):
        assert tuple(getattr(got, f).shape) == tuple(getattr(want, f).shape)
    for b in range(B):
        w = _det_rows(*(np.asarray(getattr(want, f)[b]) for f in ("boxes", "scores", "labels", "mask")))
        g = _det_rows(*(getattr(got, f)[b].numpy() for f in ("boxes", "scores", "labels", "mask")))
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
