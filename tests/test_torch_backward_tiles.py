"""The tile rules of the port's two tile-owned backward kernels, on the CPU.

The sampler's backward kernel owns tiles of the map's gradient: its samples
are first sorted stably by the tile of their window start
(cpm_tpu_torch/ops/deform_conv.py::window_tiles, the plain version of the
binning kernels, which the card's tests hold to it bit for bit), and each
tile then sums what reaches it from its own list and from the lists of the
tiles to its left, above and above-left. Here the binning is held against a
numpy reckoning of each sample's window, and a float64 sum that walks the
binned lists as the kernel does is held against the JAX package's
hand-written backward, `cpm_tpu/ops/deform_conv.py::_bilinear_gather_bwd`
(through `jax.vjp` of `_bilinear_gather`), at rtol 1e-4 / atol 1e-5 (f32 in
JAX, two orders of summation).

The RoIAlign backward kernels (multilevel and stacked, which share one tile
loop, csrc/roi_align_tiles.cuh) let a roi into a tile of its level when the
cells its first and last sample coordinates can reach meet the tile
(cpm_tpu_torch/ops/roi_align.py::roi_tile_reach, the plain version of the
kernels' `footprint`). Here a tile-owned sum built on that rule (per tile,
the rois in order, float32, one cast) is held against the plain stacked
backward and the JAX package's stacked Pallas backward in interpret mode.

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.ops import deform_conv as jdc
from cpm_tpu.ops.pallas.stacked_pallas import multilevel_roi_align_stacked

TILE = (8, 16)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function.
    torch registers custom ops at the first backward of a process and looks
    its caller up with `inspect.getmodule`, which walks `sys.modules` and
    fails on such a `__file__`. Whether that file ran earlier in this worker
    depends on the scheduling, so the stubs go before this file's first torch
    call; that file installs them again when it needs them."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


def _coords(seed, b, h, w, p):
    """Coordinates over the map and past its border, with samples pinned on
    the tiles' borders, on the map's last row and column, wholly outside,
    at +-1e6, at +-inf and NaN."""
    rng = np.random.RandomState(seed)
    ys = rng.uniform(-1.5, h + 0.5, (b, p)).astype(np.float32)
    xs = rng.uniform(-1.5, w + 0.5, (b, p)).astype(np.float32)
    pinned = np.array([
        [7.5, 15.5], [7.0, 16.0], [8.0, 15.0], [h - 1.0, w - 1.0], [h - 0.5, w - 0.5],
        [-0.5, 0.0], [-1.25, 1.0], [1.0, w + 0.25], [1e6, 2.0], [2.0, -1e6],
        [np.inf, 1.0], [1.0, -np.inf], [np.nan, 1.0], [1.0, np.nan], [-1e6, 1e6],
    ], np.float32)
    ys[:, : len(pinned)], xs[:, : len(pinned)] = pinned[:, 0], pinned[:, 1]
    return ys, xs


def _windows(coord, size):
    """numpy: each coordinate's window start and its two tent weights, as
    `_window_parts` makes them (a NaN starts at 0 and weighs nothing)."""
    with np.errstate(invalid="ignore"):
        f = np.floor(coord)
        start = np.where(f >= max(size - 2, 0), max(size - 2, 0), np.where(f > 0, f, 0))
        start = start.astype(np.int64)
        weights = []
        for i in (0, 1):
            d = (coord - (start + i).astype(np.float32)).astype(np.float32)
            wt = np.maximum(np.float32(1) - np.abs(d), 0).astype(np.float32)
            weights.append(np.where((start + i <= size - 1) & ~np.isnan(wt), wt, 0))
    return start, np.stack(weights, -1)


@pytest.mark.parametrize("shape", [(2, 21, 37), (1, 1, 40), (2, 30, 1), (1, 8, 16), (3, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_every_weighed_sample_is_in_its_window_start_tile_once_in_order(shape):
    import torch

    from cpm_tpu_torch.ops.deform_conv import window_tiles

    b, h, w = shape
    ys, xs = _coords(1, b, h, w, 300)
    order, offsets = window_tiles(torch.from_numpy(ys), torch.from_numpy(xs), (h, w), TILE)
    order, offsets = order.numpy(), offsets.numpy()
    tiles_x = -(-w // TILE[1])
    tiles = -(-h // TILE[0]) * tiles_x
    keys = tiles + 1                        # and one for the samples of no weight
    assert order.dtype == np.int32 and offsets.dtype == np.int32
    assert offsets.shape == (b * keys + 1,) and offsets[0] == 0 and offsets[-1] == b * 300
    assert sorted(order.tolist()) == list(range(b * 300))   # each sample once

    sy, wy = _windows(ys, h)
    sx, wx = _windows(xs, w)
    live = (wy.max(-1) > 0) & (wx.max(-1) > 0)
    image = np.arange(b)[:, None]
    key = image * keys + np.where(live, (sy // TILE[0]) * tiles_x + sx // TILE[1], tiles)
    key = key.reshape(-1)
    assert not live[:, 6:15].any()          # outside, +-1e6, +-inf, NaN: in no tile
    for k in range(b * keys):
        members = order[offsets[k]:offsets[k + 1]]
        np.testing.assert_array_equal(members, np.flatnonzero(key == k))   # stable
    for i in range(b):   # an image's samples fill its own stretch, those of no weight last
        np.testing.assert_array_equal(np.sort(order[i * 300:(i + 1) * 300]), np.arange(i * 300, (i + 1) * 300))
        assert offsets[i * keys] == i * 300


def _tile_gather(feat_shape, ys, xs, g, order, offsets):
    """float64: the map's gradient as the kernel forms it, each tile summing
    the shares that fall inside it from the binned lists of its own tile and
    of the tiles to its left, above and above-left."""
    b, h, w, c = feat_shape
    th, tw = TILE
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    sy, wy = _windows(ys.reshape(-1), h)
    sx, wx = _windows(xs.reshape(-1), w)
    flat_g = g.reshape(-1, c).astype(np.float64)
    out = np.zeros((b, h, w, c))
    for image in range(b):
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    if ty - dy < 0 or tx - dx < 0:
                        continue
                    k = image * (tiles_y * tiles_x + 1) + (ty - dy) * tiles_x + tx - dx
                    for s in order[offsets[k]:offsets[k + 1]]:
                        for i in (0, 1):
                            for j in (0, 1):
                                y, x = sy[s] + i, sx[s] + j
                                if y // th == ty and x // tw == tx and wy[s, i] * wx[s, j] > 0:
                                    out[image, y, x] += wy[s, i] * wx[s, j] * flat_g[s]
    return out


@pytest.mark.parametrize("shape", [(2, 19, 35, 4), (1, 9, 17, 8)], ids=lambda s: "x".join(map(str, s)))
def test_tile_owned_sum_over_the_bins_matches_the_custom_vjp(shape):
    """A plain scatter over the binned order (`index_add` in float64) and the
    tile-owned sum both give the JAX package's map gradient."""
    import torch

    from cpm_tpu_torch.ops.deform_conv import window_tiles

    b, h, w, c = shape
    p = 160
    ys, xs = _coords(2, b, h, w, p)
    ys[:, 10:15], xs[:, 10:15] = 3.5, 4.5       # finite, for JAX's gather
    rng = np.random.RandomState(3)
    feat = rng.randn(b, h, w, c).astype(np.float32)
    g = rng.randn(b, p, c).astype(np.float32)
    _, vjp = jax.vjp(jdc._bilinear_gather, jnp.asarray(feat), jnp.asarray(ys), jnp.asarray(xs))
    want = np.asarray(vjp(jnp.asarray(g))[0])

    order, offsets = window_tiles(torch.from_numpy(ys), torch.from_numpy(xs), (h, w), TILE)
    keys = -(-h // TILE[0]) * -(-w // TILE[1]) + 1
    live = torch.cat([order[offsets[i * keys]:offsets[(i + 1) * keys - 1]] for i in range(b)]).long()
    sy, wy = _windows(ys.reshape(-1), h)
    sx, wx = _windows(xs.reshape(-1), w)
    image = live // p
    flat_g = torch.from_numpy(g.reshape(-1, c)).double()[live]
    scattered = torch.zeros(b * h * w, c, dtype=torch.float64)
    for i in (0, 1):
        for j in (0, 1):
            cell = image * h * w + torch.from_numpy(np.minimum(sy + i, h - 1) * w
                                                    + np.minimum(sx + j, w - 1))[live]
            weight = torch.from_numpy((wy[:, i] * wx[:, j]).astype(np.float64))[live]
            scattered.index_add_(0, cell, flat_g * weight[:, None])
    np.testing.assert_allclose(scattered.reshape(b, h, w, c).numpy(), want, **GRAD_TOL)
    tiled = _tile_gather((b, h, w, c), ys, xs, g, order.numpy(), offsets.numpy())
    np.testing.assert_allclose(tiled, want, **GRAD_TOL)
    assert np.abs(want).sum() > 0


ROI_SHAPES = [(28, 40), (14, 20), (7, 10), (4, 5)]
ROI_SCALES = (0.25, 0.125, 0.0625, 0.03125)
ROI_TILE = (8, 8)   # the kernels' kTileH x kTileW
ROI_BWD_TOL = dict(rtol=1e-4, atol=1e-4)


def _roi_case(seed, pool, n=20, c=4):
    """Rois over a 2 x 112x160 batch: spread boxes, plus one past the
    border, one wholly outside, a degenerate one (x2 < x1), one of zero
    area and the whole image, and masked rois among them (one of them
    a wild box); `g` of the pooled shape."""
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(-10, 140, n), rng.uniform(-10, 95, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, 90, n), y1 + rng.uniform(4, 60, n)], 1)
    special = np.array([[-40, -30, 50, 40], [400, 300, 480, 380], [100, 80, 90, 70],
                        [60, 50, 60, 50], [0, 0, 159, 111], [-1e6, 3e5, 2e6, -4e5]])
    boxes = np.concatenate([boxes, special])
    rois = np.concatenate([rng.randint(0, 2, (len(boxes), 1)), boxes], 1).astype(np.float32)
    levels = rng.randint(0, 4, len(rois)).astype(np.int32)
    levels[-2] = 0                       # the whole image on the finest level
    valid = rng.rand(len(rois)) > 0.25
    valid[n:-1] = True
    valid[-1] = False                    # a masked wild box adds nothing
    g = rng.randn(len(rois), *pool, c).astype(np.float32)
    return rois, levels, valid, g


@pytest.mark.parametrize("pool", [(7, 7), (14, 14)], ids=["7x7", "14x14"])
def test_tile_owned_roi_sum_over_the_reach_rule_matches_the_stacked_backward(pool):
    import torch

    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import plain_multilevel_roi_align_backward
    from cpm_tpu_torch.ops.cuda.stacked_roi_align import plain_stacked_roi_align_backward
    from cpm_tpu_torch.ops.roi_align import roi_tile_reach

    rois, levels, valid, g = _roi_case(4, pool)
    shapes = [(2, h, w, g.shape[-1]) for h, w in ROI_SHAPES]
    r, lv, gt = torch.from_numpy(rois), torch.from_numpy(levels), torch.from_numpy(g)
    row_lo, row_hi, col_lo, col_hi, reaches = (t.numpy() for t in roi_tile_reach(
        r, lv, ROI_SHAPES, ROI_SCALES, pool, 2))
    one = torch.ones(1, dtype=torch.bool)
    per_roi = [[t.numpy() for t in plain_multilevel_roi_align_backward(
        shapes, r[i:i + 1], lv[i:i + 1], one, gt[i:i + 1], ROI_SCALES, 2)] for i in range(len(r))]
    # the rule is sound: a roi adds nothing outside its rectangle
    for i, grads in enumerate(per_roi):
        outside = np.ones(ROI_SHAPES[levels[i]], bool)
        if reaches[i]:
            outside[row_lo[i]:row_hi[i] + 1, col_lo[i]:col_hi[i] + 1] = False
        assert not grads[levels[i]][:, outside].any(), f"roi {i} reaches past its rectangle"
    assert not reaches[-5] and reaches[-2] and (row_hi - row_lo)[-2] == ROI_SHAPES[0][0] - 1

    th, tw = ROI_TILE
    tiled = [np.zeros(s, np.float32) for s in shapes]
    for level, (h, w) in enumerate(ROI_SHAPES):
        for image in range(2):
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    acc = np.zeros((min(th, h - y0), min(tw, w - x0), g.shape[-1]), np.float32)
                    for i in range(len(rois)):
                        if (valid[i] and levels[i] == level and int(rois[i, 0]) == image
                                and reaches[i] and row_lo[i] < y0 + th and row_hi[i] >= y0
                                and col_lo[i] < x0 + tw and col_hi[i] >= x0):
                            acc += per_roi[i][level][image, y0:y0 + th, x0:x0 + tw]
                    tiled[level][image, y0:y0 + th, x0:x0 + tw] = acc
    want = plain_stacked_roi_align_backward(shapes, r, lv, torch.from_numpy(valid), gt,
                                            ROI_SCALES, 2)
    _, vjp = jax.vjp(
        lambda fs: multilevel_roi_align_stacked(
            tuple(fs), (jnp.asarray(rois), jnp.asarray(levels), jnp.asarray(valid)), pool,
            ROI_SCALES, 2, False, True),
        [jnp.zeros(s, jnp.float32) for s in shapes])
    (pallas,) = vjp(jnp.asarray(g))
    for level in range(len(shapes)):
        np.testing.assert_allclose(tiled[level], want[level].numpy(), **ROI_BWD_TOL,
                                   err_msg=f"level {level} vs the plain stacked backward")
        np.testing.assert_allclose(tiled[level], np.asarray(pallas[level]), **ROI_BWD_TOL,
                                   err_msg=f"level {level} vs the Pallas backward")
    assert np.abs(tiled[0]).sum() > 0
