"""The stacked, clustered and single-level RoIAlign of the port against the JAX package.

The same numpy-seeded inputs (those of tests/test_pallas_clustered.py and of
the stacked cases of tests/test_pallas_multilevel.py) go through

(a) the JAX package: the Pallas kernels `multilevel_roi_align_stacked` and
    `multilevel_roi_align_clustered` in interpret mode, `roi_align_pallas_fwd`
    under `force_tpu_interpret_mode` (as tests/test_roi_align_pallas.py runs
    it) and the gather formulation, and
(b) the port's plain versions of the same formulations
    (cpm_tpu_torch/ops/roi_align.py), which are what its wrappers run on CPU
    tensors and what its CUDA kernels are held against on the card.

f32; forward rtol/atol 1e-5, backward 1e-4 (the JAX package's own tolerances
for these kernels). The CUDA kernels themselves run only on a card
(tests/test_torch_cuda_kernels.py, which imports no JAX, and chip_smoke.py).

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from cpm_tpu.ops.pallas.clustered_pallas import multilevel_roi_align_clustered
from cpm_tpu.ops.pallas.roi_align_pallas import roi_align_pallas_fwd
from cpm_tpu.ops.pallas.stacked_pallas import multilevel_roi_align_stacked
from cpm_tpu.ops.roi_align import multilevel_roi_align as jax_gather
from cpm_tpu.ops.roi_align import roi_align as jax_roi_align
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


SCALES = (0.25, 0.125, 0.0625, 0.03125)
SHAPES = [(56, 80), (28, 40), (14, 20), (7, 10)]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
POOLS = [(7, 7), (14, 14)]
BACKENDS = ("auto", "pallas", "stacked", "clustered", "gather")


def _setup(seed=0, R=48, B=2, C=8, dense=False):
    """Feature maps, rois and levels as tests/test_pallas_clustered.py makes
    them: spread over the image, or (dense) packed into a few neighbourhoods
    so that rois share cells."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, h, w, C).astype(np.float32) for h, w in SHAPES]
    rois = np.zeros((R, 5), np.float32)
    rois[:, 0] = rng.randint(0, B, R)
    if dense:
        cx = rng.choice([40.0, 90.0, 150.0], R)
        cy = rng.choice([30.0, 80.0], R)
        x1 = cx + rng.rand(R) * 20
        y1 = cy + rng.rand(R) * 16
    else:
        x1 = rng.rand(R) * 180
        y1 = rng.rand(R) * 120
    rois[:, 1], rois[:, 2] = x1, y1
    rois[:, 3] = x1 + rng.rand(R) * 130 + 4
    rois[:, 4] = y1 + rng.rand(R) * 90 + 4
    levels = rng.randint(0, 4, R).astype(np.int32)
    return feats, rois, levels


def _extreme_aspect(seed=5, R=12, C=8):
    """Very wide rois on the stride-8 level, as
    test_clustered_extreme_aspect_singleton_fallback makes them, plus a
    134:1 strip and a whole-image roi: supports beyond any shared tile."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, h, w, C).astype(np.float32) for h, w in SHAPES]
    rois = np.zeros((R, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, R)
    x1 = rng.rand(R) * 60
    y1 = rng.rand(R) * 120
    rois[:, 1], rois[:, 2] = x1, y1
    rois[:, 3] = x1 + 200 + rng.rand(R) * 30
    rois[:, 4] = y1 + 40 + rng.rand(R) * 10
    levels = np.full(R, 1, np.int32)
    rois[0, 1:] = [0, 100, 319, 102]
    rois[1, 1:] = [0, 0, 319, 223]
    levels[:2] = 0
    return feats, rois, levels


def _t(x):
    import torch

    return torch.from_numpy(np.asarray(x))


def _jnp(feats):
    return [jnp.asarray(f) for f in feats]


def _jax_kernel(fn, feats, rois, levels, valid, pool):
    rl = (jnp.asarray(rois), jnp.asarray(levels))
    if valid is not None:
        rl += (jnp.asarray(valid),)
    return np.asarray(fn(tuple(_jnp(feats)), rl, pool, SCALES, 2, False, True))


def _port(name):
    from cpm_tpu_torch.ops import roi_align as ra

    def stacked(feats, rois, levels, valid, pool):
        out = ra.multilevel_roi_align_stacked_plain(feats, rois, levels, pool, SCALES, 2)
        return out * valid.float()[:, None, None, None]

    def clustered(feats, rois, levels, valid, pool):
        return ra.multilevel_roi_align_clustered_plain(feats, rois, levels, valid, pool, SCALES, 2)

    return dict(stacked=stacked, clustered=clustered)[name]


JAX_KERNELS = dict(stacked=multilevel_roi_align_stacked, clustered=multilevel_roi_align_clustered)


@pytest.mark.parametrize("dense", [False, True], ids=["spread", "dense"])
@pytest.mark.parametrize("pool", POOLS, ids=["7x7", "14x14"])
@pytest.mark.parametrize("name", ["stacked", "clustered"])
def test_plain_forward_matches_pallas_interpret_and_gather(name, pool, dense):
    feats, rois, levels = _setup(dense=dense)
    valid = np.ones(len(rois), bool)
    got = _port(name)([_t(f) for f in feats], _t(rois), _t(levels), _t(valid), pool).numpy()
    kernel = _jax_kernel(JAX_KERNELS[name], feats, rois, levels, None, pool)
    gather = np.asarray(jax_gather(_jnp(feats), jnp.asarray(rois), jnp.asarray(levels),
                                   pool, SCALES, 2))
    np.testing.assert_allclose(got, kernel, **FWD_TOL)
    np.testing.assert_allclose(got, gather, **FWD_TOL)


@pytest.mark.parametrize("name", ["stacked", "clustered"])
def test_masked_rois_are_exactly_zero(name):
    feats, rois, levels = _setup(seed=5, R=32)
    valid = (np.arange(32) % 3) != 0
    # garbage boxes in the masked slots must not matter
    wild = rois.copy()
    wild[~valid, 1:] = [-1e6, 3e5, 2e6, -4e5]
    got = _port(name)([_t(f) for f in feats], _t(wild), _t(levels), _t(valid), (7, 7)).numpy()
    want = _jax_kernel(JAX_KERNELS[name], feats, rois, levels, valid, (7, 7))
    assert np.abs(got[~valid]).max() == 0.0
    assert not want[~valid].any()
    np.testing.assert_allclose(got[valid], want[valid], **FWD_TOL)


@pytest.mark.parametrize("name", ["stacked", "clustered"])
def test_extreme_aspect_rois_match_gather(name):
    """Supports far beyond a shared tile: the clustered formulation makes
    them singleton groups that read the level directly, and stays exact
    where the TPU kernel's 64-cell window would overflow."""
    from cpm_tpu_torch.ops.roi_align import TILE, cluster_rois

    feats, rois, levels = _extreme_aspect()
    valid = np.ones(len(rois), bool)
    got = _port(name)([_t(f) for f in feats], _t(rois), _t(levels), _t(valid), (7, 7)).numpy()
    want = np.asarray(jax_gather(_jnp(feats), jnp.asarray(rois), jnp.asarray(levels),
                                 (7, 7), SCALES, 2))
    np.testing.assert_allclose(got, want, **FWD_TOL)
    g = cluster_rois(_t(rois), _t(levels), _t(valid), SHAPES, 2, (7, 7), SCALES, 2).groups.numpy()
    beyond = (g[:, 6] > TILE) | (g[:, 7] > TILE)
    assert beyond.sum() >= 2 and (g[beyond, 1] == 1).all()


@pytest.mark.parametrize("name", ["stacked", "clustered"])
def test_plain_backward_matches_pallas_backward_interpret(name):
    import torch

    # stacked: the inputs of test_stacked_backward_matches_windowed;
    # clustered: those of test_clustered_backward_matches_gather
    feats, rois, levels = _setup(seed=6, R=24) if name == "stacked" else _setup(
        seed=3, R=24, dense=True)
    valid = np.ones(24, bool)
    pool = (7, 7)
    rl = (jnp.asarray(rois), jnp.asarray(levels))

    def loss(fn):
        return lambda fs: jnp.sum(fn(fs) ** 2)

    want_kernel = jax.grad(loss(
        lambda fs: JAX_KERNELS[name](tuple(fs), rl, pool, SCALES, 2, False, True)))(_jnp(feats))
    want_gather = jax.grad(loss(
        lambda fs: jax_gather(fs, *rl, pool, SCALES, 2)))(_jnp(feats))
    fs = [_t(f).requires_grad_() for f in feats]
    out = _port(name)(fs, _t(rois), _t(levels), _t(valid), pool)
    (out * out).sum().backward()
    for i, f in enumerate(fs):
        assert f.grad.shape == f.shape
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_kernel[i]), **BWD_TOL,
                                   err_msg=f"level {i} vs the Pallas backward")
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_gather[i]), **BWD_TOL,
                                   err_msg=f"level {i} vs the gather gradient")
    assert sum(float(f.grad.abs().sum()) for f in fs) > 0
    assert all(torch.isfinite(f.grad).all() for f in fs)


def test_named_stacked_backward_matches_autograd_and_masks():
    import torch

    from cpm_tpu_torch.ops.cuda.stacked_roi_align import plain_stacked_roi_align_backward
    from cpm_tpu_torch.ops.roi_align import multilevel_roi_align

    feats, rois, levels = _setup(seed=7, R=24)
    rng = np.random.RandomState(8)
    valid = rng.rand(24) < 0.5
    g = rng.randn(24, 7, 7, 8).astype(np.float32)
    got = plain_stacked_roi_align_backward(
        [f.shape for f in feats], _t(rois), _t(levels), _t(valid), _t(g), SCALES, 2)
    fs = [_t(f).requires_grad_() for f in feats]
    out = multilevel_roi_align(fs, _t(rois), _t(levels), (7, 7), SCALES, 2)
    (out * _t(valid).float()[:, None, None, None] * _t(g)).sum().backward()
    for a, f in zip(got, fs):
        assert a.shape == f.shape and a.is_contiguous()
        torch.testing.assert_close(a, f.grad, **BWD_TOL)
    none = plain_stacked_roi_align_backward(
        [f.shape for f in feats], _t(rois), _t(levels), _t(np.zeros(24, bool)), _t(g), SCALES, 2)
    assert not any(x.any() for x in none)


def test_stack_levels_geometry():
    import torch

    from cpm_tpu_torch.ops.roi_align import stack_geometry, stack_levels, unstack_levels

    feats, _, _ = _setup(R=1)
    offs, rows, wmax = stack_geometry(SHAPES)
    assert offs == (0, 56, 84, 98) and rows == 105 and wmax == 80
    # levels as NHWC views of channels_last NCHW maps, as the model hands them over
    views = [_t(f).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
             .permute(0, 2, 3, 1) for f in feats]
    stack = stack_levels(views)
    assert tuple(stack.shape) == (2, rows, wmax, 8) and stack.is_contiguous()
    for part, f in zip(unstack_levels(stack, SHAPES), feats):
        assert torch.equal(part, _t(f))
    assert not stack[:, 56:84, 40:, :].any()  # the padding right of level 1


@pytest.mark.parametrize("pool", POOLS, ids=["7x7", "14x14"])
def test_cluster_rois_forms_capped_groups(pool):
    from cpm_tpu_torch.ops.roi_align import TILE, cluster_rois, group_cap

    feats, rois, levels = _setup(R=64, dense=True)
    valid = np.arange(64) % 7 != 0
    cap = group_cap(pool)
    assert cap == (8 if pool == (7, 7) else 4)
    g = cluster_rois(_t(rois), _t(levels), _t(valid), SHAPES, 2, pool, SCALES, 2)
    order, groups = g.order.numpy(), g.groups.numpy()
    size = groups[:, 1]
    n = int(g.n_groups)
    assert sorted(order.tolist()) == list(range(64))
    assert size.sum() == valid.sum() and (size >= 2).any() and size.max() <= cap
    assert (size[:n] > 0).all() and not groups[n:].any()
    members = []
    for first, sz, lvl, image, y0, x0, rows, cols in groups[:n]:
        rs = order[first:first + sz]
        members.extend(rs.tolist())
        assert valid[rs].all()
        assert (levels[rs] == lvl).all() and (rois[rs, 0] == image).all()
        if sz > 1:
            assert rows <= TILE and cols <= TILE
        h, w = SHAPES[lvl]
        assert 0 <= y0 and y0 + rows <= h and 0 <= x0 and x0 + cols <= w
    # every valid roi in exactly one group, the masked ones last and in none
    assert sorted(members) == np.flatnonzero(valid).tolist()
    assert not valid[order[valid.sum():]].any()
    # a smaller cap cuts the same runs into more groups
    g2 = cluster_rois(_t(rois), _t(levels), _t(valid), SHAPES, 2, pool, SCALES, 2, group=2)
    assert g2.groups[:, 1].max() == 2 and int(g2.n_groups) > n


def test_clustered_plain_reads_its_groups_tiles():
    """A grouping whose tiles are copied from the other image gives other
    numbers: the rois really read the copied tiles, not the level."""
    from cpm_tpu_torch.ops.roi_align import cluster_rois, multilevel_roi_align_clustered_plain

    feats, rois, levels = _setup(R=32, dense=True)
    valid = np.ones(32, bool)
    args = ([_t(f) for f in feats], _t(rois), _t(levels), _t(valid), (7, 7), SCALES, 2)
    g = cluster_rois(*args[1:4], SHAPES, 2, (7, 7), SCALES, 2)
    want = multilevel_roi_align_clustered_plain(*args)
    same = multilevel_roi_align_clustered_plain(*args, grouping=g)
    assert (same == want).all()
    other = g.groups.clone()
    other[:, 3] = 1 - other[:, 3]
    moved = multilevel_roi_align_clustered_plain(*args, grouping=g._replace(groups=other))
    assert (moved - want).abs().max() > 1e-2


def test_pooler_under_each_backend_equals_gather():
    import torch

    from cpm_tpu_torch.ops import pooler as pooler_mod

    feats, rois, _ = _setup(seed=7, R=40, dense=True)
    valid = np.arange(40) % 4 != 1
    # through NHWC views of channels_last maps, with a gradient
    outs, grads = {}, {}
    try:
        for name in BACKENDS:
            pooler_mod.set_pooler_backend(name)
            assert pooler_mod.get_pooler_backend() == name
            nchw = [_t(f).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
                    .requires_grad_() for f in feats]
            out = pooler_mod.Pooler((7, 7), SCALES, 2)(
                [f.permute(0, 2, 3, 1) for f in nchw], _t(rois), _t(valid))
            (out * out).sum().backward()
            outs[name], grads[name] = out.detach(), [f.grad for f in nchw]
    finally:
        pooler_mod.set_pooler_backend("auto")
    assert pooler_mod._resolve_backend() == "multilevel"
    for name in BACKENDS:
        assert not outs[name][~valid].any()
        torch.testing.assert_close(outs[name], outs["gather"], **FWD_TOL)
        for a, b in zip(grads[name], grads["gather"]):
            torch.testing.assert_close(a, b, **BWD_TOL)
    with pytest.raises(ValueError):
        pooler_mod.set_pooler_backend("windowed")
    assert pooler_mod.get_pooler_backend() == "auto"


# --- the single-level op -----------------------------------------------------


def _single_level(seed=0, R=16, C=32):
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, 16, 24, C).astype(np.float32)
    rois = np.zeros((R, 5), np.float32)
    rois[:, 0] = rng.randint(0, 2, R)
    x1 = rng.rand(R) * 80 - 10
    y1 = rng.rand(R) * 50 - 10
    rois[:, 1], rois[:, 2] = x1, y1
    rois[:, 3] = x1 + rng.rand(R) * 60 + 1
    rois[:, 4] = y1 + rng.rand(R) * 40 + 1
    rois[0, 1:] = [60, 40, 50, 30]       # degenerate: roi_w = roi_h = 1 cell
    rois[1, 1:] = [0, 30, 95, 33]        # a strip across the map
    rois[2, 1:] = [200, 200, 260, 250]   # outside the map: zeros
    return feats, rois


@pytest.mark.parametrize("pool", POOLS, ids=["7x7", "14x14"])
def test_single_level_matches_pallas_interpret_and_gather(pool):
    import torch

    from cpm_tpu_torch.ops.cuda import roi_align as op

    feats, rois = _single_level()
    before = op.KERNEL.launches
    got = op.roi_align_cuda(_t(feats), _t(rois), pool, 0.25, 2)
    assert got.dtype == torch.float32 and op.KERNEL.launches == before
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(roi_align_pallas_fwd(jnp.asarray(feats), jnp.asarray(rois), pool, 0.25, 2))
    gather = np.asarray(jax_roi_align(jnp.asarray(feats), jnp.asarray(rois), pool, 0.25, 2))
    # the Pallas kernel interpolates by matmuls: the tolerance of its own test
    np.testing.assert_allclose(got.numpy(), kernel, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), gather, **FWD_TOL)
    assert not got[2].any()
    # a bf16 map is cast to f32, as the TPU wrapper casts it; the output is f32
    half = op.roi_align_cuda(_t(feats).bfloat16(), _t(rois), pool, 0.25, 2)
    assert half.dtype == torch.float32
    torch.testing.assert_close(
        half, op.roi_align_cuda(_t(feats).bfloat16().float(), _t(rois), pool, 0.25, 2))


def test_single_level_gradient_matches_jax_and_pooler_takes_this_branch(monkeypatch):
    import torch

    from cpm_tpu.ops.pooler import Pooler as JaxPooler
    from cpm_tpu_torch.ops import pooler as pooler_mod
    from cpm_tpu_torch.ops.cuda import roi_align as op

    feats, rois = _single_level(seed=1)
    valid = np.arange(len(rois)) % 3 != 0
    want = jax.grad(lambda f: jnp.sum(jax_roi_align(f, jnp.asarray(rois), (7, 7), 0.25, 2) ** 2))(
        jnp.asarray(feats))
    f = _t(feats).requires_grad_()
    (op.roi_align_cuda(f, _t(rois), (7, 7), 0.25, 2) ** 2).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want), **BWD_TOL)

    # the Pooler's one-level branch, under every backend name
    calls = []
    real = op.roi_align_cuda
    monkeypatch.setattr(op, "roi_align_cuda", lambda *a, **k: calls.append(1) or real(*a, **k))
    want_pooled = np.asarray(JaxPooler((7, 7), (0.25,), 2)(
        [jnp.asarray(feats)], jnp.asarray(rois), jnp.asarray(valid)))
    try:
        for name in BACKENDS:
            pooler_mod.set_pooler_backend(name)
            got = pooler_mod.Pooler((7, 7), (0.25,), 2)([_t(feats)], _t(rois), _t(valid))
            np.testing.assert_allclose(got.numpy(), want_pooled, **FWD_TOL)
            assert not got[~valid].any()
    finally:
        pooler_mod.set_pooler_backend("auto")
    assert len(calls) == len(BACKENDS)
    half = pooler_mod.Pooler((7, 7), (0.25,), 2)([_t(feats).bfloat16()], _t(rois), _t(valid))
    assert half.dtype == torch.bfloat16


def test_wrappers_on_cpu_count_nothing_and_refuse_what_the_kernels_do_not_take():
    import torch

    from cpm_tpu_torch.ops.cuda import clustered_roi_align as clustered_op
    from cpm_tpu_torch.ops.cuda import roi_align as single_op
    from cpm_tpu_torch.ops.cuda import stacked_roi_align as stacked_op
    from cpm_tpu_torch.ops.roi_align import stack_levels

    feats, rois, levels = _setup(seed=9, R=8)
    valid = np.ones(8, bool)
    fs = [_t(f) for f in feats]
    args = (_t(rois), _t(levels), _t(valid))
    counts = lambda: (stacked_op.KERNEL.launches, stacked_op.KERNEL.backward_launches,  # noqa: E731
                      clustered_op.KERNEL.launches, single_op.KERNEL.launches)
    before = counts()
    a = stacked_op.multilevel_roi_align_stacked(fs, *args, (7, 7), SCALES, 2)
    b = clustered_op.multilevel_roi_align_clustered(fs, *args, (7, 7), SCALES, 2)
    torch.testing.assert_close(a, b, **FWD_TOL)
    assert counts() == before
    # the kernel objects themselves take CUDA tensors only: nothing is built
    with pytest.raises(ValueError):
        stacked_op.KERNEL(stack_levels(fs), SHAPES, *args, (7, 7), SCALES, 2)
    with pytest.raises(ValueError):
        stacked_op.KERNEL.backward([f.shape for f in fs], *args, a, SCALES, 2)
    with pytest.raises(ValueError):
        clustered_op.KERNEL(fs, *args, (7, 7), SCALES, 2)
    with pytest.raises(ValueError):
        single_op.KERNEL(fs[0], _t(rois), (7, 7), 0.25, 2)
    for k in (stacked_op.KERNEL, clustered_op.KERNEL, single_op.KERNEL):
        assert k.built is None or torch.cuda.is_available()
    assert counts() == before
