"""Deformable convolution: the JAX package's sampler, core and packs against
the port's, on the CPU.

The same inputs, made from a seed with numpy, go through
cpm_tpu/ops/deform_conv.py and cpm_tpu_torch/ops/deform_conv.py. On the CPU
the port's sampler runs its plain version (`deform_sample_plain`), the one
the CUDA kernels are held against on a card.

Tolerances (f32 on the CPU, two frameworks summing in different orders):
sampler forward atol 1e-5; its gradients to the map and to the coordinates
against the JAX package's hand-written `custom_vjp`, rtol 1e-4 / atol 1e-5;
`deform_conv2d` and the packs rtol 1e-4 / atol 1e-5 (a contraction over up to
9 * 16 terms).

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
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

FWD_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-5)


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


def _sampler_inputs(seed, b, h, w, c, p):
    """A map and coordinates spread over (-1.5, size + 0.5): inside, on the
    border and wholly outside; a few pinned to the cases that matter."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(b, h, w, c).astype(np.float32)
    ys = rng.uniform(-1.5, h + 0.5, (b, p)).astype(np.float32)
    xs = rng.uniform(-1.5, w + 0.5, (b, p)).astype(np.float32)
    pinned = np.array([
        [-0.5, 0.0], [h - 0.5, w - 0.5],      # half a cell over the border
        [-1.25, 1.0], [1.0, w + 0.25],        # wholly outside
        [h - 1.0, w - 1.0], [0.0, 0.0],       # on the last and the first cell
        [h - 1.5, 0.25], [0.75, w - 1.25],
    ], np.float32)
    ys[:, : len(pinned)], xs[:, : len(pinned)] = pinned[:, 0], pinned[:, 1]
    return feat, ys, xs


@pytest.mark.parametrize("shape", [(2, 9, 11, 8), (1, 2, 2, 4), (2, 5, 3, 16)])
def test_sample_plain_matches_bilinear_gather(shape):
    import torch

    from cpm_tpu_torch.ops.deform_conv import deform_sample_plain

    b, h, w, c = shape
    feat, ys, xs = _sampler_inputs(1, b, h, w, c, 200)
    got = deform_sample_plain(torch.from_numpy(feat), torch.from_numpy(ys), torch.from_numpy(xs))
    want = jdc._bilinear_gather(jnp.asarray(feat), jnp.asarray(ys), jnp.asarray(xs))
    corner = jdc._bilinear_gather_corner4(jnp.asarray(feat), jnp.asarray(ys), jnp.asarray(xs))
    assert tuple(got.shape) == (b, 200, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(corner), rtol=0, atol=FWD_ATOL)
    # the pinned samples: outside gives zero, the border a partial sum
    assert not got[:, 2].any() and not got[:, 3].any()
    np.testing.assert_allclose(got[:, 0].numpy(), 0.5 * feat[:, 0, 0], atol=FWD_ATOL)
    np.testing.assert_allclose(got[:, 1].numpy(), 0.25 * feat[:, h - 1, w - 1], atol=FWD_ATOL)
    np.testing.assert_allclose(got[:, 4].numpy(), feat[:, h - 1, w - 1], atol=FWD_ATOL)
    np.testing.assert_allclose(got[:, 5].numpy(), feat[:, 0, 0], atol=FWD_ATOL)


@pytest.mark.parametrize("shape", [(2, 1, 7, 4), (2, 6, 1, 4), (1, 1, 1, 8)])
def test_sample_plain_on_one_row_and_one_column_maps(shape):
    """Maps with H < 2 or W < 2: the JAX package samples them with the
    four-corner form, and so does the plain version."""
    import torch

    from cpm_tpu_torch.ops.deform_conv import deform_sample_plain

    b, h, w, c = shape
    feat, ys, xs = _sampler_inputs(2, b, h, w, c, 64)
    ys[:, 8:], xs[:, 8:] = ys[:, 8:] * 0.8, xs[:, 8:] * 0.8   # more of them inside
    tf = torch.from_numpy(feat).requires_grad_()
    ty, tx = torch.from_numpy(ys).requires_grad_(), torch.from_numpy(xs).requires_grad_()
    got = deform_sample_plain(tf, ty, tx)
    want = jdc._bilinear_gather_corner4(jnp.asarray(feat), jnp.asarray(ys), jnp.asarray(xs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    assert got.detach().abs().sum() > 0
    g = np.random.RandomState(3).randn(b, 64, c).astype(np.float32)
    got.backward(torch.from_numpy(g))
    # coordinates off the integers: there both forms have the same derivative
    off = (np.abs(ys - np.round(ys)) > 1e-3) & (np.abs(xs - np.round(xs)) > 1e-3)
    wf, wy, wx = jax.grad(
        lambda f, y, x: jnp.sum(jdc._bilinear_gather_corner4(f, y, x) * g), argnums=(0, 1, 2)
    )(jnp.asarray(feat), jnp.asarray(ys), jnp.asarray(xs))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(wf), **GRAD_TOL)
    np.testing.assert_allclose(ty.grad.numpy()[off], np.asarray(wy)[off], **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy()[off], np.asarray(wx)[off], **GRAD_TOL)


def test_sample_plain_gradients_match_the_custom_vjp():
    import torch

    from cpm_tpu_torch.ops.deform_conv import deform_sample_plain

    b, h, w, c, p = 2, 7, 9, 8, 300
    feat, ys, xs = _sampler_inputs(4, b, h, w, c, p)
    # integer coordinates too: the tent's derivative is zero there on both sides
    ys[:, 8:12], xs[:, 8:12] = [[2.0, 3.0, 2.5, 0.0]], [[4.0, 1.5, 5.0, 8.0]]
    g = np.random.RandomState(5).randn(b, p, c).astype(np.float32)
    tf = torch.from_numpy(feat).requires_grad_()
    ty, tx = torch.from_numpy(ys).requires_grad_(), torch.from_numpy(xs).requires_grad_()
    deform_sample_plain(tf, ty, tx).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jdc._bilinear_gather, jnp.asarray(feat), jnp.asarray(ys), jnp.asarray(xs))
    wf, wy, wx = vjp(jnp.asarray(g))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(wf), **GRAD_TOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(wy), **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wx), **GRAD_TOL)
    assert np.abs(np.asarray(wy)).max() > 0.1 and not ty.grad[:, 2].any()


def test_sample_plain_takes_f32_coordinates_whatever_the_map_dtype():
    import torch

    from cpm_tpu_torch.ops.deform_conv import deform_sample_plain

    feat, ys, xs = _sampler_inputs(6, 1, 300, 4, 8, 32)
    ys[0, 8:] = 257.3   # bf16 holds 256 and 258 here, nothing between
    half = torch.from_numpy(feat).to(torch.bfloat16)
    got = deform_sample_plain(half, torch.from_numpy(ys), torch.from_numpy(xs))
    want = deform_sample_plain(half.float(), torch.from_numpy(ys), torch.from_numpy(xs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=1.6e-2, atol=2e-2)


CONV_CASES = [
    # (v2, groups, stride, dilation)
    (False, 1, 1, 1), (True, 1, 1, 1), (False, 4, 1, 1), (True, 4, 2, 1),
    (False, 1, 2, 1), (True, 1, 1, 2), (False, 4, 2, 2),
]


def _conv_inputs(seed, v2, groups, stride, dilation, b=2, h=9, w=10, cin=8, cout=12):
    rng = np.random.RandomState(seed)
    ho = (h + 2 * dilation - dilation * 2 - 1) // stride + 1
    wo = (w + 2 * dilation - dilation * 2 - 1) // stride + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    weight = (rng.randn(3, 3, cin // groups, cout) * 0.2).astype(np.float32)   # HWIO
    offset = (rng.randn(b, ho, wo, 18) * 1.5).astype(np.float32)   # some samples leave the map
    mask = rng.rand(b, ho, wo, 9).astype(np.float32) if v2 else None
    return x, weight, offset, mask


@pytest.mark.parametrize("v2,groups,stride,dilation", CONV_CASES)
def test_deform_conv2d_matches_jax(v2, groups, stride, dilation):
    import torch

    from cpm_tpu_torch.ops.deform_conv import deform_conv2d

    x, weight, offset, mask = _conv_inputs(7, v2, groups, stride, dilation)
    want = jdc.deform_conv2d(
        jnp.asarray(x), jnp.asarray(weight), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask), stride, dilation, dilation, groups)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()).requires_grad_()   # OIHW
    to = torch.from_numpy(offset).requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask).requires_grad_()
    got = deform_conv2d(tx, tw, to, tm, stride, dilation, dilation, groups)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **CONV_TOL)

    g = np.random.RandomState(8).randn(*want.shape).astype(np.float32)
    got.backward(torch.from_numpy(g))

    def loss(x_, w_, o_, m_):
        return jnp.sum(jdc.deform_conv2d(x_, w_, o_, m_, stride, dilation, dilation, groups) * g)

    argnums = (0, 1, 2, 3) if v2 else (0, 1, 2)
    grads = jax.grad(loss, argnums=argnums)(
        jnp.asarray(x), jnp.asarray(weight), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(grads[0]), **CONV_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(grads[1]).transpose(3, 2, 0, 1),
                               **CONV_TOL)
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(grads[2]), rtol=1e-4, atol=5e-5)
    if v2:
        np.testing.assert_allclose(tm.grad.numpy(), np.asarray(grads[3]), **CONV_TOL)


@pytest.mark.parametrize("groups,stride,dilation", [(1, 1, 1), (4, 1, 1), (4, 2, 1), (2, 1, 2)])
def test_zero_offsets_equal_a_grouped_conv2d(groups, stride, dilation):
    """With zero offsets (and a mask of ones) a deformable conv is the plain
    conv of the same weight: this pins the grouping order of the output
    channels, which a comparison at non-zero offsets against the JAX function
    alone would not tell from a consistent mistake in the bridge."""
    import torch
    import torch.nn.functional as F

    from cpm_tpu_torch.ops.deform_conv import deform_conv2d

    x, weight, offset, _ = _conv_inputs(9, False, groups, stride, dilation)
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(weight.transpose(3, 2, 0, 1).copy())
    zero = torch.zeros(offset.shape)
    want = F.conv2d(tx.permute(0, 3, 1, 2), tw, stride=stride, padding=dilation,
                    dilation=dilation, groups=groups).permute(0, 2, 3, 1)
    for mask in (None, torch.ones(offset.shape[:3] + (9,))):
        got = deform_conv2d(tx, tw, zero, mask, stride, dilation, dilation, groups)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **CONV_TOL)
    # and the JAX function agrees with the same conv
    jwant = jdc.deform_conv2d(jnp.asarray(x), jnp.asarray(weight), jnp.zeros(offset.shape),
                              None, stride, dilation, dilation, groups)
    np.testing.assert_allclose(np.asarray(jwant), want.numpy(), **CONV_TOL)


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("groups,stride", [(1, 1), (4, 2)])
def test_packs_match_jax_through_the_bridge(v2, groups, stride):
    import torch

    from cpm_tpu_torch.ops.deform_conv import DeformConvPack, ModulatedDeformConvPack
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named, state_dict_to_flax

    rng = np.random.RandomState(10)
    x = rng.randn(2, 10, 9, 8).astype(np.float32)
    jcls = jdc.ModulatedDeformConvPack if v2 else jdc.DeformConvPack
    jpack = jcls(features=12, stride=stride, groups=groups, use_bias=True)
    params = jax.device_get(jpack.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    conv_name = "conv_offset_mask" if v2 else "conv_offset"
    # fresh offset convs are zero, which would leave every sample on a cell
    assert not params[conv_name]["kernel"].any() and not params[conv_name]["bias"].any()
    assert params["weight"].shape == (3, 3, 8 // groups, 12)
    params = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    params[conv_name]["kernel"] = (rng.randn(*params[conv_name]["kernel"].shape) * 0.15).astype(np.float32)
    params[conv_name]["bias"] = (rng.randn(*params[conv_name]["bias"].shape) * 0.5).astype(np.float32)
    params["bias"] = rng.randn(12).astype(np.float32)
    want = jpack.apply({"params": params}, jnp.asarray(x))

    cls = ModulatedDeformConvPack if v2 else DeformConvPack
    pack = cls(8, 12, stride=stride, groups=groups, use_bias=True,
               generator=torch.Generator().manual_seed(0))
    fresh = getattr(pack, conv_name)
    assert not fresh.weight.any() and not fresh.bias.any()
    assert tuple(pack.weight.shape) == (12, 8 // groups, 3, 3)
    shapes = {k: tuple(v.shape) for k, v in pack.state_dict().items()}
    assert set(shapes) == {"weight", "bias", f"{conv_name}.weight", f"{conv_name}.bias"}
    named = flax_tree_to_named(params, shapes)
    pack.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in named.items()})
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = pack(tx).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **CONV_TOL)
    # and back: the port's parameters as a flax tree
    back = state_dict_to_flax(pack.state_dict(), params)
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(back[k], params[k])
    np.testing.assert_array_equal(back[conv_name]["kernel"], params[conv_name]["kernel"])


@pytest.mark.slow
def test_sample_plain_matches_the_pallas_probe_in_interpret_mode():
    """The TPU kernel itself (tools/probe_dcn_pallas_sampler.py::pallas_sample)
    under the Pallas interpreter, at its least input: one block of 1024
    samples. Minutes on the CPU, hence `slow`; the tier-1 tests above hold the
    plain version against `_bilinear_gather`, the reference the probe checks
    itself against."""
    import importlib.util
    import pathlib

    import torch
    from jax.experimental.pallas import tpu as pltpu

    from cpm_tpu_torch.ops.deform_conv import deform_sample_plain

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "probe_dcn_pallas_sampler.py"
    spec = importlib.util.spec_from_file_location("probe_dcn_pallas_sampler", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)

    b, h, w, c = 1, 12, 20, 8
    feat, ys, xs = _sampler_inputs(11, b, h, w, c, probe.BLOCK)
    sy, sx, wy, wx = probe.prepare(feat.shape, ys.reshape(-1), xs.reshape(-1))
    wp = ((w - 2) // 8) * 8 + probe.XWIN
    feat_p = np.pad(feat, ((0, 0), (0, 0), (0, wp - w), (0, 0)))
    with pltpu.force_tpu_interpret_mode():
        want = probe.pallas_sample(
            jnp.asarray(feat_p), jnp.zeros(probe.BLOCK, jnp.int32), jnp.asarray(sy),
            jnp.asarray(sx), jnp.asarray(wy), jnp.asarray(wx))
    got = deform_sample_plain(torch.from_numpy(feat), torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
