"""The binning of the deformable-conv sampler's backward, on the CPU.

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
