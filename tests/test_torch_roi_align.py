"""The port's multilevel RoIAlign and Pooler against the JAX package.

Identical numpy inputs go through the JAX gather formulation, the Pallas
kernel in interpret mode (as tests/test_pallas_multilevel.py runs it) and
the port's plain PyTorch version, in f32 at atol 1e-5. The CUDA kernel
itself runs only on a card (the `cuda` test below, and chip_smoke.py).

torch and the port are imported inside the tests, as the repo's other tests
import torch, so that collecting this file loads no torch into a test worker:
with torch loaded, the 8-device XLA:CPU collectives of tests/test_multichip.py
can deadlock in the same worker process.
"""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.ops.pallas.multilevel_pallas import multilevel_roi_align_pallas
from cpm_tpu.ops.pooler import Pooler as JaxPooler
from cpm_tpu.ops.pooler import assign_fpn_levels as jax_assign_fpn_levels
from cpm_tpu.ops.roi_align import multilevel_roi_align as jax_multilevel_roi_align
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
ATOL = 1e-5
POOLS = [(7, 7), (14, 14)]


def _inputs(seed=0, R=40, B=2, C=8):
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
    return feats, rois, levels, valid


def _t(x):
    import torch

    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("pool", POOLS)
def test_plain_matches_jax_gather(pool):
    from cpm_tpu_torch.ops.roi_align import multilevel_roi_align

    feats, rois, levels, _ = _inputs()
    want = jax_multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(levels),
        pool, SCALES, 2,
    )
    got = multilevel_roi_align([_t(f) for f in feats], _t(rois), _t(levels), pool, SCALES, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pool", POOLS)
def test_plain_matches_pallas_interpret(pool):
    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op

    # the Pallas kernel's pooler route needs C % 128 == 0
    feats, rois, levels, valid = _inputs(seed=1, R=24, C=128)
    # keep the rois inside the TPU kernel's 64-cell window
    rois[:, 3] = np.minimum(rois[:, 3], rois[:, 1] + 60)
    rois[:, 4] = np.minimum(rois[:, 4], rois[:, 2] + 60)
    want = multilevel_roi_align_pallas(
        tuple(jnp.asarray(f) for f in feats),
        (jnp.asarray(rois), jnp.asarray(levels), jnp.asarray(valid)),
        pool, SCALES, 2, False, True,
    )
    got = op.multilevel_roi_align(
        [_t(f) for f in feats], _t(rois), _t(levels), _t(valid), pool, SCALES, 2
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pool", POOLS)
def test_single_level_roi_align_matches_jax(pool):
    from cpm_tpu_torch.ops.roi_align import roi_align

    feats, rois, _, _ = _inputs(seed=2)
    want = jax_roi_align(jnp.asarray(feats[1]), jnp.asarray(rois), pool, SCALES[1], 2)
    got = roi_align(_t(feats[1]), _t(rois), pool, SCALES[1], 2)
    # JAX jits roi_align, and XLA fuses its sample-coordinate multiply-adds,
    # which moves a coordinate by an ulp: rtol 1e-5 covers that rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=ATOL)


def test_assign_fpn_levels_matches_jax():
    import torch

    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    _, rois, _, _ = _inputs(seed=3, R=200)
    boxes = rois[:, 1:5]
    want = jax_assign_fpn_levels(jnp.asarray(boxes), 2, 5)
    got = assign_fpn_levels(_t(boxes), 2, 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pool", POOLS)
def test_pooler_matches_jax(pool):
    from cpm_tpu_torch.ops.pooler import Pooler

    feats, rois, _, valid = _inputs(seed=4, R=60)
    want = JaxPooler(pool, SCALES, 2)(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(valid)
    )
    got = Pooler(pool, SCALES, 2)([_t(f) for f in feats], _t(rois), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert not got[~_t(valid)].any()


def test_pooler_f32_scope_pools_bf16_features_in_f32():
    import torch

    from cpm_tpu_torch.ops.pooler import Pooler, pooler_force_f32_scope

    feats, rois, _, valid = _inputs(seed=5)
    bf = [_t(f).to(torch.bfloat16) for f in feats]
    pooler = Pooler((7, 7), SCALES, 2)
    with pooler_force_f32_scope(True):
        got = pooler(bf, _t(rois), _t(valid))
    want = pooler([f.float() for f in bf], _t(rois), _t(valid)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op
    from cpm_tpu_torch.ops.roi_align import multilevel_roi_align

    feats, rois, levels, valid = _inputs(seed=6)
    before = op.KERNEL.launches
    got = op.multilevel_roi_align(
        [_t(f) for f in feats], _t(rois), _t(levels), _t(valid), (7, 7), SCALES, 2
    )
    want = multilevel_roi_align([_t(f) for f in feats], _t(rois), _t(levels), (7, 7), SCALES, 2)
    want = want * _t(valid).float()[:, None, None, None]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert op.KERNEL.launches == before


def test_wrapper_raises_for_other_devices():
    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op

    feats, rois, levels, valid = _inputs(seed=7, R=4)
    with pytest.raises(ValueError):
        op.multilevel_roi_align(
            [_t(f).to("meta") for f in feats], _t(rois).to("meta"),
            _t(levels).to("meta"), _t(valid).to("meta"), (7, 7), SCALES, 2,
        )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype_name):
    import torch

    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op
    from cpm_tpu_torch.ops.roi_align import multilevel_roi_align

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dtype = getattr(torch, dtype_name)
    torch.backends.cudnn.allow_tf32 = False
    feats, rois, levels, valid = _inputs(seed=8, C=256)
    fs = [_t(f).cuda().to(dtype) for f in feats]
    args = (_t(rois).cuda(), _t(levels).cuda(), _t(valid).cuda())
    before = op.KERNEL.launches
    got = op.multilevel_roi_align(fs, *args, (7, 7), SCALES, 2).float()
    assert op.KERNEL.launches == before + 1
    want = multilevel_roi_align([f.float() for f in fs], args[0], args[1], (7, 7), SCALES, 2)
    want = (want * args[2].float()[:, None, None, None]).to(dtype).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    else:
        torch.testing.assert_close(got, want, rtol=1.6e-2, atol=1e-2)
