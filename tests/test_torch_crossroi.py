"""The cross-roi shared-window RoIAlign: the JAX package's probe against the
port's plain version, on the CPU.

tools/probe_pooler_crossroi.py::make_probe builds a Pallas kernel in which the
G rois of grid step i all pool from the 64x64 window of roi i;
cpm_tpu_torch/ops/roi_align.py::crossroi_roi_align_plain states the same rule
in torch and is what the CUDA kernel is held against on a card. Here the
probe runs under the Pallas interpreter, fed by the JAX package's own
`_prep_rois`, and the port by its `crossroi_prep_rois`, on the same seeded
maps and rois.

Tolerances (f32 on the CPU): the prepared positions 1e-5; pooled values atol
1e-5 at unit-scale maps (the probe contracts with matrix products, the plain
version gathers four cells a sample: the same terms in another order).
Against the gather RoIAlign, which keeps absolute positions, atol 5e-5: a
position relative to a window origin is rounded once more (half an ulp of a
position near 80 cells is 3.8e-6, times cell values of up to 4).

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import importlib.util
import pathlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.ops.pallas.multilevel_pallas import WIN, _prep_rois
from cpm_tpu.ops.roi_align import roi_align as jax_roi_align

ATOL = 1e-5
H, W, C = 72, 88, 8
SCALE = 0.25


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__file__` is a function; torch's lazy registrations walk `sys.modules`
    with `inspect.getmodule` and fail on them. They go before this file's
    first torch call; that file installs them again when it needs them."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


@pytest.fixture(scope="module")
def probe():
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "probe_pooler_crossroi.py"
    spec = importlib.util.spec_from_file_location("probe_pooler_crossroi", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, n=8):
    """A map and rois of 14 to 28 cells a side (the level mapper's range), so
    that every roi's samples fit its own window; some reach over the map's
    border."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(2, H, W, C).astype(np.float32)
    rois = np.zeros((n, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, n)
    side_w = rng.uniform(56, 110, n)
    side_h = rng.uniform(56, 110, n)
    rois[:, 1] = rng.uniform(-6, W / SCALE - side_w + 6, n)
    rois[:, 2] = rng.uniform(-6, H / SCALE - side_h + 6, n)
    rois[:, 3] = rois[:, 1] + side_w
    rois[:, 4] = rois[:, 2] + side_h
    return feat, rois


def _jax_prep(rois, pool):
    hw = ((H, W),)
    b, y0, x0, ys, xs, _, _ = _prep_rois(
        jnp.asarray(rois), jnp.zeros(len(rois), jnp.int32), (SCALE,), hw, hw, pool, 2, False)
    return b, y0, x0, ys, xs


@pytest.mark.parametrize("pool", [(7, 7), (14, 14)])
def test_prep_matches_the_jax_prep(pool):
    import torch

    from cpm_tpu_torch.ops.roi_align import CROSSROI_WINDOW, crossroi_prep_rois

    assert CROSSROI_WINDOW == WIN
    _, rois = _inputs(0, n=64)
    rois[0, 1:] = [-500, -500, -400, -400]   # every sample out of bounds
    want = _jax_prep(rois, pool)
    got = crossroi_prep_rois(torch.from_numpy(rois), SCALE, (H, W), pool, 2)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want[3]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want[4]), rtol=0, atol=ATOL)
    assert (got.ys[0] == -2).all() and (got.x0 % 8 == 0).all()
    with pytest.raises(ValueError):
        crossroi_prep_rois(torch.from_numpy(rois), SCALE, (40, W), pool, 2)


@pytest.mark.parametrize("pool", [(7, 7), (14, 14)])
def test_group_of_one_is_the_roi_align_of_the_jax_package(pool):
    """At G = 1 every roi pools from its own window, which holds all its
    samples: the plain version then equals the JAX package's gather RoIAlign."""
    import torch

    from cpm_tpu_torch.ops.cuda.crossroi_roi_align import KERNEL, crossroi_roi_align

    feat, rois = _inputs(1, n=24)
    want = jax_roi_align(jnp.asarray(feat), jnp.asarray(rois), pool, SCALE, 2)
    got = crossroi_roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 1, pool, SCALE, 2)
    assert tuple(got.shape) == (24, *pool, C) and KERNEL.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-5)


@pytest.mark.parametrize("group,pool", [(1, (7, 7)), (2, (7, 7)), (4, (7, 7)), (2, (14, 14))])
def test_plain_matches_the_probe_in_interpret_mode(probe, group, pool):
    import torch
    from jax.experimental.pallas import tpu as pltpu

    from cpm_tpu_torch.ops.roi_align import crossroi_prep_rois, crossroi_roi_align_plain

    feat, rois = _inputs(2 + group, n=8)
    run = probe.make_probe(group, pool[0], pool[1], 2, C, (H, W), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(run(jnp.asarray(feat), *_jax_prep(rois, pool), len(rois)))
    prep = crossroi_prep_rois(torch.from_numpy(rois), SCALE, (H, W), pool, 2)
    got = crossroi_roi_align_plain(torch.from_numpy(feat), prep, group, pool, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if group > 1:
        # the members do read the leader's window: not their own RoIAlign
        own = crossroi_roi_align_plain(torch.from_numpy(feat), prep, 1, pool, 2)
        assert (got - own).abs().max() > 0.1


def test_the_rule_restated_in_numpy():
    """Step i pools rois i*G .. i*G+G-1 from the window of roi i, positions
    relative to each roi's own origin, hat weights over the window's cells."""
    import torch

    from cpm_tpu_torch.ops.roi_align import crossroi_prep_rois, crossroi_roi_align_plain

    group, pool, sr = 4, (7, 7), 2
    feat, rois = _inputs(9, n=8)
    prep = crossroi_prep_rois(torch.from_numpy(rois), SCALE, (H, W), pool, sr)
    got = crossroi_roi_align_plain(torch.from_numpy(feat), prep, group, pool, sr).numpy()
    cells = np.arange(WIN, dtype=np.float32)
    for r in range(len(rois)):
        i = r // group
        b, y0, x0 = int(prep.batch[i]), int(prep.y0[i]), int(prep.x0[i])
        win = feat[b, y0:y0 + WIN, x0:x0 + WIN]
        wy = np.maximum(0, 1 - np.abs(prep.ys[r].numpy()[:, None] - cells))   # [Sy, WIN]
        wx = np.maximum(0, 1 - np.abs(prep.xs[r].numpy()[:, None] - cells))
        vals = np.einsum("yh,xw,hwc->yxc", wy, wx, win)
        want = vals.reshape(pool[0], sr, pool[1], sr, C).mean(axis=(1, 3))
        np.testing.assert_allclose(got[r], want, rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        crossroi_roi_align_plain(torch.from_numpy(feat), prep, 3, pool, sr)
