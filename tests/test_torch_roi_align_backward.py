"""Gradients of the port's multilevel RoIAlign against the JAX package.

The same numpy inputs go through `jax.grad` of the JAX gather formulation, of
the Pallas kernel in interpret mode (as tests/test_pallas_multilevel.py runs
its backward) and through the port: autograd of the plain PyTorch forward,
the named plain backward, and the wrapper that pairs the CUDA kernels, which
on CPU tensors takes the plain path. f32, rtol 1e-4 / atol 1e-4 (the
tolerance of the JAX package's own backward test). The CUDA backward kernel
itself runs only on a card (the `cuda` test below, and chip_smoke.py).

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.ops.pallas.multilevel_pallas import multilevel_roi_align_pallas
from cpm_tpu.ops.roi_align import multilevel_roi_align as jax_multilevel_roi_align


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
RTOL, ATOL = 1e-4, 1e-4
POOLS = [(7, 7), (14, 14)]


def _inputs(seed=0, R=32, B=2, C=8, pool=(7, 7)):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, h, w, C).astype(np.float32) for h, w in SHAPES]
    rois = np.zeros((R, 5), np.float32)
    rois[:, 0] = rng.randint(0, B, R)
    x1 = rng.rand(R) * 300 - 20
    y1 = rng.rand(R) * 200 - 20
    rois[:, 1], rois[:, 2] = x1, y1
    rois[:, 3] = x1 + rng.rand(R) * 200 + 2
    rois[:, 4] = y1 + rng.rand(R) * 150 + 2
    # degenerate, zero-area, extreme-aspect and out-of-image rois
    rois[0, 1:] = [120, 90, 100, 70]
    rois[1, 1:] = [50, 50, 50, 50]
    rois[2, 1:] = [0, 100, 319, 104]
    rois[3, 1:] = [400, 300, 500, 400]
    levels = rng.randint(0, 4, R).astype(np.int32)
    valid = rng.rand(R) > 0.3
    valid[:4] = True
    g = rng.randn(R, *pool, C).astype(np.float32)
    return feats, rois, levels, valid, g


def _t(x):
    import torch

    return torch.from_numpy(np.asarray(x))


def _jax_grads(fn, feats, g):
    """d sum(fn(feats) * g) / d feats."""
    return jax.grad(lambda fs: jnp.sum(fn(fs) * jnp.asarray(g)))([jnp.asarray(f) for f in feats])


def _assert_levels_close(got, want):
    assert len(got) == len(want) == len(SHAPES)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=f"level {i}")


@pytest.mark.parametrize("pool", POOLS)
def test_plain_backward_matches_jax_gather(pool):
    import torch

    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import plain_multilevel_roi_align_backward
    from cpm_tpu_torch.ops.roi_align import multilevel_roi_align

    feats, rois, levels, valid, g = _inputs(pool=pool)
    mask = jnp.asarray(valid, jnp.float32)[:, None, None, None]
    want = _jax_grads(
        lambda fs: jax_multilevel_roi_align(
            fs, jnp.asarray(rois), jnp.asarray(levels), pool, SCALES, 2) * mask,
        feats, g,
    )
    # autograd through the plain forward
    fs = [_t(f).requires_grad_() for f in feats]
    out = multilevel_roi_align(fs, _t(rois), _t(levels), pool, SCALES, 2)
    (out * _t(valid).float()[:, None, None, None] * _t(g)).sum().backward()
    _assert_levels_close([f.grad for f in fs], want)
    # the named plain backward
    got = plain_multilevel_roi_align_backward(
        [f.shape for f in feats], _t(rois), _t(levels), _t(valid), _t(g), SCALES, 2)
    assert [tuple(x.shape) for x in got] == [f.shape for f in feats]
    assert all(x.dtype == torch.float32 for x in got)
    _assert_levels_close(got, want)


@pytest.mark.parametrize("pool", POOLS)
def test_plain_backward_matches_pallas_backward_interpret(pool):
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import plain_multilevel_roi_align_backward

    # the Pallas kernel's route needs C % 128 == 0 and rois inside its window
    feats, rois, levels, valid, g = _inputs(seed=1, R=24, C=128, pool=pool)
    rois[:, 3] = np.minimum(rois[:, 3], rois[:, 1] + 60)
    rois[:, 4] = np.minimum(rois[:, 4], rois[:, 2] + 60)
    want = _jax_grads(
        lambda fs: multilevel_roi_align_pallas(
            tuple(fs), (jnp.asarray(rois), jnp.asarray(levels), jnp.asarray(valid)),
            pool, SCALES, 2, False, True),
        feats, g,
    )
    got = plain_multilevel_roi_align_backward(
        [f.shape for f in feats], _t(rois), _t(levels), _t(valid), _t(g), SCALES, 2)
    _assert_levels_close(got, want)


def test_masked_rois_add_nothing():
    import torch

    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import plain_multilevel_roi_align_backward

    feats, rois, levels, valid, g = _inputs(seed=2)
    shapes = [f.shape for f in feats]
    # garbage in the masked slots must not matter
    wild = rois.copy()
    wild[~valid, 1:] = [-1e6, 3e5, 2e6, -4e5]
    got = plain_multilevel_roi_align_backward(
        shapes, _t(wild), _t(levels), _t(valid), _t(g), SCALES, 2)
    kept = plain_multilevel_roi_align_backward(
        shapes, _t(rois[valid]), _t(levels[valid]), _t(np.ones(valid.sum(), bool)),
        _t(g[valid]), SCALES, 2)
    for a, b in zip(got, kept):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    none = plain_multilevel_roi_align_backward(
        shapes, _t(rois), _t(levels), _t(np.zeros(len(rois), bool)), _t(g), SCALES, 2)
    assert not any(x.any() for x in none)


def test_degenerate_and_outside_rois_match_jax():
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import plain_multilevel_roi_align_backward

    feats, rois, levels, _, g = _inputs(seed=3, R=4)  # only the four special rois
    valid = np.ones(4, bool)
    want = _jax_grads(
        lambda fs: jax_multilevel_roi_align(
            fs, jnp.asarray(rois), jnp.asarray(levels), (7, 7), SCALES, 2),
        feats, g,
    )
    got = plain_multilevel_roi_align_backward(
        [f.shape for f in feats], _t(rois), _t(levels), _t(valid), _t(g), SCALES, 2)
    _assert_levels_close(got, want)
    # the roi outside every map adds nothing at its level
    only = plain_multilevel_roi_align_backward(
        [f.shape for f in feats], _t(rois[3:4]), _t(levels[3:4]), _t(valid[3:4]), _t(g[3:4]),
        SCALES, 2)
    assert not any(x.any() for x in only)


def test_wrapper_on_cpu_takes_the_plain_path_and_counts_nothing():
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op
    from cpm_tpu_torch.ops.pooler import Pooler

    feats, rois, levels, valid, g = _inputs(seed=4)
    before = (op.KERNEL.launches, op.KERNEL.backward_launches)
    fs = [_t(f).requires_grad_() for f in feats]
    out = op.multilevel_roi_align(fs, _t(rois), _t(levels), _t(valid), (7, 7), SCALES, 2)
    (out * _t(g)).sum().backward()
    want = op.plain_multilevel_roi_align_backward(
        [f.shape for f in feats], _t(rois), _t(levels), _t(valid), _t(g), SCALES, 2)
    for f, w in zip(fs, want):
        # the same autograd graph; its scatter-adds may run in another order
        torch.testing.assert_close(f.grad, w, rtol=1e-6, atol=1e-6)
    assert (op.KERNEL.launches, op.KERNEL.backward_launches) == before

    # the Pooler passes gradients to the levels, through NHWC views of NCHW maps
    nchw = [_t(f).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).requires_grad_()
            for f in feats]
    pooled = Pooler((7, 7), SCALES, 2)([f.permute(0, 2, 3, 1) for f in nchw], _t(rois), _t(valid))
    # a gradient with the strides of an NCHW view, as the heads hand it back
    pooled.permute(0, 3, 1, 2).mul(_t(g).permute(0, 3, 1, 2)).sum().backward()
    assert all(f.grad is not None and f.grad.shape == f.shape for f in nchw)
    assert sum(float(f.grad.abs().sum()) for f in nchw) > 0
    assert (op.KERNEL.launches, op.KERNEL.backward_launches) == before


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op

    feats, rois, levels, valid, g = _inputs(seed=5, R=4)
    shapes = [f.shape for f in feats]
    args = (_t(rois), _t(levels), _t(valid))
    with pytest.raises(TypeError):
        op.KERNEL.backward(shapes, *args, _t(g).double(), SCALES, 2)
    with pytest.raises(ValueError):
        op.KERNEL.backward(shapes, *args, _t(g).permute(0, 2, 1, 3), SCALES[:3], 2)
    with pytest.raises(ValueError):  # not contiguous
        op.KERNEL.backward(shapes, *args, _t(g).permute(0, 2, 1, 3), SCALES, 2)
    with pytest.raises(ValueError):  # C does not fill 16-byte vectors
        op.KERNEL.backward([(*s[:3], 6) for s in shapes], *args, _t(g)[..., :6].contiguous(), SCALES, 2)
    with pytest.raises(ValueError):
        op.KERNEL.backward(shapes, _t(rois), _t(levels).long(), _t(valid), _t(g), SCALES, 2)
    with pytest.raises(ValueError):  # CPU tensors never reach nvcc or a launch
        op.KERNEL.backward(shapes, *args, _t(g), SCALES, 2)
    assert op.KERNEL.built is None or torch.cuda.is_available()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_cuda_backward_kernel_matches_plain(dtype_name):
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dtype = getattr(torch, dtype_name)
    feats, rois, levels, valid, g = _inputs(seed=8, C=256)
    fs = [_t(f).cuda().to(dtype).requires_grad_() for f in feats]
    args = (_t(rois).cuda(), _t(levels).cuda(), _t(valid).cuda())
    gd = _t(g).cuda().to(dtype)
    before = (op.KERNEL.launches, op.KERNEL.backward_launches)
    out = op.multilevel_roi_align(fs, *args, (7, 7), SCALES, 2)
    # a permuted gradient: the Function makes it contiguous
    out.permute(0, 3, 1, 2).mul(gd.permute(0, 3, 1, 2)).sum().backward()
    assert (op.KERNEL.launches, op.KERNEL.backward_launches) == (before[0] + 1, before[1] + 1)
    want = op.plain_multilevel_roi_align_backward(
        [f.shape for f in feats], *args, gd.float(), SCALES, 2)
    for f, w in zip(fs, want):
        assert f.grad.dtype == dtype and f.grad.shape == f.shape
        if dtype == torch.float32:
            # both sum in f32 in another order, the atomics in a changing one
            torch.testing.assert_close(f.grad, w, rtol=RTOL, atol=ATOL)
        else:
            # one bf16 rounding of an f32 sum
            torch.testing.assert_close(f.grad.float(), w.to(dtype).float(), rtol=1.6e-2, atol=1e-2)
