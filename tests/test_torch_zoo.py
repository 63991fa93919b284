"""The trunk and neck zoo: weight standardisation, context blocks, the
block types, stems and norms of the trunk, the FPN's norms and levels and the
other necks, the JAX package against the port on the CPU, in f32.

* `ws_standardize` against `ws_standardize_kernel` (a 1x1 conv on one input
  channel too), to 1e-6; a WS deformable conv (v1 and v2), whose offset conv
  is standardised and whose main weight is not, and a WS trunk with
  deformable stages converted by that rule;
* `GlobalContextBlock` and `SeBlock` from `make_context`;
* each block type under GN, AVG_DOWN and context options, and the 3x3x3
  stem, as a whole trunk;
* the FPN under GN, frozen BN with WS, extra conv levels from C5 and from
  P5, and starting at P3; HRFPN (AVG, and MAX with GN), NAS-FPN and BiFPN
  (one stack; BiFPN also under GN);
* one tiny twin of each model of `chip_smoke.py`'s phase 17 (gn_ws,
  faster_gn_ws_convfc, nasfpn, bifpn, hrfpn, r50d_gcb, aligned, r18): eval
  detections, the training losses and every gradient on the same recorded
  draws, the bridge both ways, and `classify_params` against
  `param_label_tree`;
* every trunk and neck option that the JAX builders take builds in the port
  on the meta device.

Tolerances: modules' outputs rtol 1e-4 with atol 1e-5 of the output's
largest magnitude, their parameter gradients rtol 1e-3 with atol 1e-5 of
the module's largest gradient; whole models as tests/test_torch_box_head.py
holds them (losses 1e-5 relative; gradients rtol 1e-3 / atol 1e-5;
detections: labels and counts exactly, boxes 1e-3 px), but scores to 5e-5,
not 1e-5: under GN over WS-standardised weights the two packages'
statistics, summed in different orders, move a score by up to 1.1e-5; and
a model with WS convs has its gradients held to rtol 1e-3 with atol 5e-3
of each parameter's largest gradient, or 1e-5 of the model's largest
(`_ws_losses_and_gradients_match` says why); the HRFPN twin's port side is
held in f64, since one of its ReLUs has its input within f32 rounding of 0
(`FLOAT64_TWINS`). Weights are the port's,
drawn from a seed (norm scales and biases redrawn, so that none is 1 or 0),
and reach the JAX side through the bridge; each JAX side is one compiled
program over an abstract init, compiled at XLA's backend optimisation level
0 (`FAST_COMPILE`: the program is the same, its compile cheaper). The
twins' fg IoU bias is 0.5 (`_fold`), so that their detections score above
0 and are held by their scores. The JAX `GroupNorm` takes 32 groups whatever
the width, so a GN model here is at least 32 wide.

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import contextlib
import itertools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as flax_nn

from __graft_entry__ import _flagship_cfg
from cpm_tpu.config import get_default_cfg as jax_default_cfg
from cpm_tpu.modeling import registry as jax_registry
from cpm_tpu.modeling.backbone.resnet import ResNetBody as JaxResNetBody
from cpm_tpu.modeling.context import make_context as jax_make_context
from cpm_tpu.modeling.ws import maybe_ws as jax_maybe_ws
from cpm_tpu.modeling.ws import ws_standardize_kernel
from cpm_tpu.ops.deform_conv import DeformConvPack, ModulatedDeformConvPack
from cpm_tpu.solver.optimizer import param_label_tree
from tests.test_torch_box_head import (
    TINY as FAST_TINY,
    _rows,
    assert_bridge_round_trip,
    assert_losses_and_gradients_match,
    model_outputs,
    tiny_cfg,
)
from tests.test_torch_model import assert_same_detection_sets
from tests.test_torch_train import _flat
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

GRID_LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_grid_1",
               "loss_grid_2", "loss_grid_3", "loss_iou_3", "loss_rescore")
FAST_LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")
FAST_COMPILE = {"xla_backend_optimization_level": "0"}


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__file__` is a function; torch registers custom ops at the first backward
    or optimizer of a process and looks its caller up with
    `inspect.getmodule`, which walks `sys.modules` and fails on them. They go
    before this file's first torch call; that file installs them again when
    it needs them."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


def _close(got, want, rtol, atol_share, what):
    want = np.asarray(want)
    atol = atol_share * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _redraw_norms(module, seed):
    """Every norm's scale and bias (AffineChannel, GroupNorm, LayerNorm) and
    every fusion weight redrawn from a seed, in [0.5, 1.5)."""
    import torch

    from cpm_tpu_torch.modeling.necks_extra import Fusion
    from cpm_tpu_torch.modeling.norm import AffineChannel

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (AffineChannel, torch.nn.GroupNorm, torch.nn.LayerNorm, Fusion)):
                for p in m.parameters(recurse=False):
                    p.copy_(0.5 + torch.rand(p.shape, generator=g))


def _check_module(jax_module, port_module, prefix, inputs, seed=0):
    """The port module's seeded weights (norms redrawn) bridged into the JAX
    module under `prefix`; outputs, and the gradients of sum(out * cot) over
    every parameter, compared. Returns the named JAX gradients."""
    import torch

    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named, state_dict_to_flax

    _redraw_norms(port_module, seed + 1)
    inputs = ([jnp.asarray(x) for x in inputs] if isinstance(inputs, (list, tuple))
              else jnp.asarray(inputs))
    holder = torch.nn.Module()
    holder.add_module(prefix, port_module)
    like = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), inputs))["params"]
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), {prefix: like})
    params = state_dict_to_flax(holder.state_dict(), like)[prefix]
    rng = np.random.RandomState(seed + 2)
    want_out = jax.eval_shape(lambda p: jax_module.apply({"params": p}, inputs), params)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in want_out]

    @jax.jit
    def run(p, x):
        def f(p):
            outs = jax_module.apply({"params": p}, x)
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs
        (_, outs), grads = jax.value_and_grad(f, has_aux=True)(p)
        return outs, grads

    run = run.lower(params, inputs).compile(compiler_options=FAST_COMPILE)
    want, grads = jax.device_get(run(params, inputs))
    xs = ([torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2) for x in inputs]
          if isinstance(inputs, (list, tuple)) else torch.from_numpy(np.asarray(inputs)).permute(0, 3, 1, 2))
    got = port_module(xs)
    assert len(got) == len(want)
    for i, (o, w) in enumerate(zip(got, want)):
        _close(o.detach().permute(0, 2, 3, 1).numpy(), w, 1e-4, 1e-5, f"output {i}")
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(c)).sum() for o, c in zip(got, cots)).backward()
    shapes = {k: tuple(p.shape) for k, p in holder.named_parameters()}
    want_grads = flax_tree_to_named({prefix: grads}, shapes)
    # atol against the largest gradient of the module: some are zero up to
    # rounding (a conv bias under a one-channel-a-group GroupNorm, the GC
    # block's attention bias under its softmax)
    scale = max(float(np.abs(g).max()) for g in want_grads.values())
    for name, p in holder.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name], rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)
    return want_grads


# --- weight standardisation and context blocks ------------------------------


def test_ws_standardize_matches_jax():
    import torch

    from cpm_tpu_torch.modeling.ws import WSConv2d, convert_to_ws, ws_standardize

    rng = np.random.RandomState(0)
    for shape in ((3, 3, 16, 8), (1, 1, 1, 4), (7, 7, 3, 16), (3, 3, 4, 32)):
        k = (rng.randn(*shape) * 0.3 + 0.1).astype(np.float32)
        want = np.asarray(ws_standardize_kernel(jnp.asarray(k)))
        got = ws_standardize(torch.from_numpy(k.transpose(3, 2, 0, 1).copy())).numpy()
        np.testing.assert_allclose(got.transpose(2, 3, 1, 0), want, rtol=1e-6, atol=1e-6)
    # the conversion keeps the parameters and their names; Linear is left alone
    seq = torch.nn.Sequential(torch.nn.Conv2d(4, 8, 3), torch.nn.Linear(8, 2))
    weight = seq[0].weight
    seq = convert_to_ws(seq)
    assert type(seq[0]) is WSConv2d and seq[0].weight is weight
    assert type(seq[1]) is torch.nn.Linear
    assert set(seq.state_dict()) == {"0.weight", "0.bias", "1.weight", "1.bias"}


class _JaxPack(flax_nn.Module):
    """One deformable conv pack of the JAX package, its output as a list."""

    v2: bool

    @flax_nn.compact
    def __call__(self, x):
        cls = ModulatedDeformConvPack if self.v2 else DeformConvPack
        return [cls(16, 3, name="pack")(x)]


@pytest.mark.parametrize("v2", [False, True], ids=["deform", "deformv2"])
def test_ws_standardises_a_deformable_conv_s_offset_conv_only(v2):
    """The rule of tests/test_ws.py::test_ws_skips_deform_main_weight: every
    4-D conv weight, the offset conv's too, but not the deformable conv's own
    weight; a WS trunk with deformable stages converts its offset convs and
    leaves the packs. The offset conv is drawn from a seed and the input is
    small, so that the standardised offsets move the samples off the cells
    without sending them off the map."""
    import torch

    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.modeling.backbone.resnet import build_resnet
    from cpm_tpu_torch.modeling.ws import WSConv2d, maybe_ws
    from cpm_tpu_torch.ops import deform_conv as pd

    cls = pd.ModulatedDeformConvPack if v2 else pd.DeformConvPack

    class PortPack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.pack = cls(16, 16, 3, generator=torch.Generator().manual_seed(0))

        def forward(self, x):
            return [self.pack(x)]

    port = maybe_ws(PortPack(), True)
    conv = getattr(port.pack, port.pack.offset_conv_name)
    assert type(conv) is WSConv2d and not isinstance(port.pack, torch.nn.Conv2d)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=g) * 0.7)
    # the main weight is far from standardised (he-normal at std
    # sqrt(2 / fan_in)): standardising it would move the outputs
    assert (port.pack.weight.detach().std(dim=(1, 2, 3)) < 0.5).all()
    x = (np.random.RandomState(1).randn(2, 12, 10, 16) * 0.02).astype(np.float32)
    grads = _check_module(jax_maybe_ws(_JaxPack, True)(v2=v2), port, "m", x)
    assert np.abs(grads[f"m.pack.{port.pack.offset_conv_name}.weight"]).max() > 0
    cfg = flagship_cfg(tiny=True)
    cfg.BACKBONE.RESNET.USE_WS = True
    cfg.BACKBONE.RESNET.STAGE_WITH_CONV = ("normal", "deform", "deformv2", "normal")
    body = build_resnet(cfg, torch.Generator().manual_seed(0))
    packs = [m for m in body.modules() if isinstance(m, (pd.DeformConvPack,
                                                          pd.ModulatedDeformConvPack))]
    assert len(packs) == 2
    assert all(type(getattr(p, p.offset_conv_name)) is WSConv2d for p in packs)
    assert type(body.layer2[0].conv1) is WSConv2d


@pytest.mark.parametrize("context", ["gcb", "se"])
def test_context_blocks_match_jax(context):
    import torch

    from cpm_tpu_torch.modeling.context import GlobalContextBlock, make_context

    rng = np.random.RandomState(0)
    x = (rng.randn(2, 6, 5, 64) * 2).astype(np.float32)
    port = make_context(64, context, 0.0625, torch.Generator().manual_seed(0))
    jmod = jax_make_context(64, context, 0.0625)
    if context == "gcb":
        assert isinstance(port, GlobalContextBlock) and port.transform_ln.eps == 1e-6
        assert port.transform_reduce.out_channels == 4

    _redraw_norms(port, 3)
    with torch.no_grad():   # nonzero conv biases too
        for name, p in port.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(4)))
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(_context_params(port),
                                                              jnp.asarray(x))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    _close(got, np.asarray(want), 1e-4, 1e-5, context)


def _context_params(port, dtype=np.float32):
    """A context block's parameters bridged by hand (the block is the only
    module): OIHW -> HWIO, the LayerNorm's weight -> scale; in `dtype`."""
    params = {}
    for name, p in port.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        v = jnp.asarray(p.detach().float().numpy(), dtype)
        if v.ndim == 4:
            params.setdefault(mod, {})["kernel"] = v.transpose(2, 3, 1, 0)
        else:
            params.setdefault(mod, {})["scale" if (leaf == "weight" and "ln" in mod) else leaf] = v
    return params


def test_the_gc_blocks_layer_norm_takes_float32_statistics_in_bfloat16():
    """Under TPU.COMPUTE_DTYPE bfloat16 the parameters are cast to bf16
    (cpm_tpu_torch/utils/amp.py) and flax's LayerNorm still takes its mean
    and variance in float32, rounding once at the end. The inputs here are
    channels dominated by their mean (40 plus a spread of about 1), where
    mean(x^2) - mean^2 taken in bf16 (a step of 8 at 1600) would lose the
    variance. Held: the LayerNorm alone to one bf16 step (rtol 2^-7), and
    the whole GC block in bf16 to 2^-6 relative with an atol of 2^-6 of the
    output's largest magnitude (bf16 convs in two summation orders; the
    block is not shifted so: a bf16 conv output of 40 is rounded to a step
    of 0.25, as large as the spread the norm divides by)."""
    import torch

    from cpm_tpu_torch.modeling.context import FlaxLayerNorm, make_context

    bf = jnp.bfloat16
    rng = np.random.RandomState(0)
    x = (40 + rng.randn(6, 16)).astype(np.float32)
    scale, bias = (0.5 + rng.rand(16)).astype(np.float32), rng.randn(16).astype(np.float32)
    want = flax_nn.LayerNorm(epsilon=1e-6).apply(
        {"params": {"scale": jnp.asarray(scale, bf), "bias": jnp.asarray(bias, bf)}},
        jnp.asarray(x, bf))
    ln = FlaxLayerNorm(16, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    got = ln.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == bf
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=2.0**-7, atol=2.0**-7)

    port = make_context(64, "gcb", 0.25, torch.Generator().manual_seed(0))
    _redraw_norms(port, 3)
    jmod = jax_make_context(64, "gcb", 0.25)
    xb = (rng.randn(2, 6, 5, 64) * 0.5).astype(np.float32)
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(
        _context_params(port, bf), jnp.asarray(xb, bf))
    port = port.to(torch.bfloat16)
    got = port(torch.from_numpy(xb).to(torch.bfloat16).permute(0, 3, 1, 2)).detach()
    assert got.dtype == torch.bfloat16 and want.dtype == bf
    _close(got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want, np.float32), 2.0**-6,
           2.0**-6, "gcb in bf16")


# --- trunks ------------------------------------------------------------------

TRUNKS = {
    "bottleneck_gn_avg_down": dict(norm="gn", avg_down=True, base_planes=32),
    "aligned_gn_gcb": dict(aligned=True, norm="gn", base_planes=64,
                           stage_with_context=("none", "gcb", "none", "gcb")),
    "aligned_resnext_avg_down_se": dict(aligned=True, groups=4, width=16, stride_3x3=True,
                                        avg_down=True, base_planes=16,
                                        stage_with_context=("se",) * 4),
    "basic_gcb_avg_down": dict(bottleneck=False, avg_down=True, layers=(2, 1, 1, 1),
                               stage_with_context=("gcb", "se", "gcb", "gcb")),
    "stem_3x3x3_gn": dict(use_3x3x3stem=True, norm="gn", base_planes=64),
    "resnext_3x3x3_gcb": dict(use_3x3x3stem=True, groups=4, width=16, stride_3x3=True,
                              avg_down=True, stage_with_context=("none", "gcb", "gcb", "gcb")),
}


@pytest.mark.parametrize("case", list(TRUNKS))
def test_trunk_options_match_jax(case):
    import torch

    from cpm_tpu_torch.modeling.backbone.resnet import ResNetBody

    kw = dict(dict(layers=(1, 1, 1, 1), base_planes=8, width=64), **TRUNKS[case])
    port = ResNetBody(generator=torch.Generator().manual_seed(0), **kw)
    x = np.random.RandomState(1).randn(2, 64, 48, 3).astype(np.float32)
    grads = _check_module(JaxResNetBody(**kw), port, "backbone", x)
    assert len(grads) > 20 and sum(np.abs(g).max() > 0 for g in grads.values()) > 20


# --- necks -------------------------------------------------------------------

NECK_CASES = {
    "fpn_gn": {"FPN.USE_GN": True},
    "fpn_bn_ws": {"FPN.USE_BN": True, "FPN.USE_WS": True},
    "fpn_extra_levels_from_c5": {"FPN.EXTRA_CONV_LEVELS": True, "FPN.RPN_MAX_LEVEL": 7},
    "fpn_extra_levels_from_p5_gn": {"FPN.EXTRA_CONV_LEVELS": True, "FPN.USE_C5": False,
                                    "FPN.RPN_MAX_LEVEL": 7, "FPN.USE_GN": True},
    "fpn_from_p3": {"FPN.RPN_MIN_LEVEL": 3, "FPN.ROI_MIN_LEVEL": 3},
    "hrfpn_avg": {"FPN.BODY": "hrfpn"},
    "hrfpn_max_gn": {"FPN.BODY": "hrfpn", "FPN.HRFPN.POOLING_TYPE": "MAX",
                     "FPN.HRFPN.USE_GN": True},
    "nasfpn": {"FPN.BODY": "nasfpn"},
    "bifpn": {"FPN.BODY": "bifpn"},
    "bifpn_gn": {"FPN.BODY": "bifpn", "FPN.BIFPN.USE_GN": True},
}


def _set(cfg, overrides):
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


def _neck_cfg(overrides):
    cfg = jax_default_cfg()
    cfg.FPN.DIM = 32
    for neck in ("HRFPN", "NASFPN", "BIFPN"):
        cfg.FPN[neck].DIM = 32
        if "NUM_STACK" in cfg.FPN[neck]:
            cfg.FPN[neck].NUM_STACK = 1
    return _set(cfg, overrides)


@pytest.mark.parametrize("case", list(NECK_CASES))
def test_neck_options_match_jax(case):
    import torch

    from cpm_tpu_torch.modeling.necks_extra import NECKS, BiFPN

    cfg = _neck_cfg(NECK_CASES[case])
    dims = (32, 64, 128, 256)
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, 48 // 2 ** i, 40 // 2 ** i, d).astype(np.float32)
             for i, d in enumerate(dims)]
    port = NECKS[cfg.FPN.BODY](cfg, dims, torch.Generator().manual_seed(0))
    grads = _check_module(jax_registry.FPN_BODY[cfg.FPN.BODY](cfg), port, "fpn", feats)
    if isinstance(port, BiFPN):
        assert np.abs(grads["fpn.stage0_p4_out_fusion.w3"]).max() > 0


# --- tiny whole models ------------------------------------------------------

ZOO = {
    "gn_ws": {"BACKBONE.RESNET.USE_GN": True, "BACKBONE.RESNET.USE_WS": True,
              "BACKBONE.RESNET.BASE_PLANES": 32, "FPN.USE_GN": True, "FPN.USE_WS": True},
    "faster_gn_ws_convfc": {"BACKBONE.RESNET.USE_GN": True, "BACKBONE.RESNET.USE_WS": True,
                            "BACKBONE.RESNET.WIDTH": 32, "FPN.USE_GN": True, "FPN.USE_WS": True,
                            "FAST_RCNN.ROI_BOX_HEAD": "roi_xconv1fc_head",
                            "FAST_RCNN.CONVFC_HEAD.USE_WS": True,
                            "FAST_RCNN.CONVFC_HEAD.CONV_DIM": 32,
                            "FAST_RCNN.CONVFC_HEAD.NUM_STACKED_CONVS": 2,
                            "FAST_RCNN.CONVFC_HEAD.MLP_DIM": 64},
    "nasfpn": {"FPN.BODY": "nasfpn", "FPN.NASFPN.DIM": 32, "FPN.NASFPN.NUM_STACK": 2},
    "bifpn": {"FPN.BODY": "bifpn", "FPN.BIFPN.DIM": 32, "FPN.BIFPN.NUM_STACK": 2},
    "hrfpn": {"FPN.BODY": "hrfpn", "FPN.HRFPN.DIM": 32},
    "r50d_gcb": {"BACKBONE.RESNET.USE_3x3x3HEAD": True, "BACKBONE.RESNET.AVG_DOWN": True,
                 "BACKBONE.RESNET.STAGE_WITH_CONTEXT": ("none", "gcb", "gcb", "gcb"),
                 "BACKBONE.RESNET.CTX_RATIO": 0.0625, "FPN.EXTRA_CONV_LEVELS": True},
    "aligned": {"BACKBONE.RESNET.USE_ALIGN": True},
    "r18": {"BACKBONE.RESNET.BOTTLENECK": False, "BACKBONE.RESNET.LAYERS": (2, 1, 1, 1)},
}


def zoo_cfg(name):
    """The tiny twin of a phase-17 model on the JAX package's config, in
    f32: the tiny flagship (tests/test_torch_train.py's widths) or the tiny
    Fast R-CNN YAML, with the model's keys."""
    if name.startswith("faster"):
        return tiny_cfg(FAST_TINY, **ZOO[name])
    cfg = _flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return _set(cfg, ZOO[name])


def _fold(model):
    """The frozen affines folded from a seeded batch (chip_smoke.py's
    `fold_images`), as a pretrained trunk's: with unit affines a random
    trunk's activations grow by orders of magnitude block by block. Then the
    ISM branch's fg IoU bias at 0.5: seeded weights give IoU logits near 0,
    of either sign, and ISM merged with RSM scores a detection by
    max(score x IoU, 0), so that without it most detections score 0 and
    tie (as tests/test_torch_cascade.py::_positive_iou)."""
    import torch

    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics

    fold_batch_statistics(
        model, np.random.RandomState(9).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8))
    if model.cfg.MODEL.GRID_ON:
        with torch.no_grad():
            model.roi_head.grid_outputs[-1].iou_pred.bias.copy_(torch.tensor([0.0, 0.5]))


def _fold_in_float64(model):
    """`_fold`, then the port's twin in f64 (its weights the same f32
    values, so the JAX side is handed the same weights)."""
    _fold(model)
    model.double()


@contextlib.contextmanager
def _port_computes_in_float64():
    """The port's compute dtype f64 (its CLI accepts only bfloat16 and
    float32), for a twin whose port side is held in f64."""
    import torch

    import cpm_tpu_torch.engine.test as port_test
    import cpm_tpu_torch.modeling.model as port_model

    mp = pytest.MonkeyPatch()
    try:
        for module in (port_model, port_test):
            mp.setattr(module, "compute_dtype", lambda cfg: torch.float64)
        yield
    finally:
        mp.undo()


# Twins whose port side is held in f64 against the JAX package's f32, as a
# layer is where a ReLU kink lies within f32 rounding of 0. In the tiny
# HRFPN model's third grid stage one GroupNorm output before the output
# tower's ReLU (roi 17, channel 27, cell (1, 2) of `norm1`) is -2.1e-6 in
# f64 against a largest |x| of 4.5; the port's f32 rounds it to +4.5e-7,
# the JAX package's keeps it below 0, so the ReLU passes its gradient in
# the port alone and 45 parameters' gradients differ by up to 8.6e-4. With
# that one ReLU's mask flipped, or the port's weights each moved by a
# relative 2^-24, or the port in f64, every gradient agrees within 3e-6.
FLOAT64_TWINS = ("hrfpn",)


def _ws_losses_and_gradients_match(out, names):
    """assert_losses_and_gradients_match for a model with WS convs: losses
    1e-5 relative; gradients rtol 1e-3 with atol 5e-3 of the parameter's
    largest gradient, or 1e-5 of the model's largest where that is more (a
    conv bias under a one-channel-a-group GroupNorm has a gradient of 0 up
    to rounding). A WS conv's gradient is the standardised weight's
    divided by each output channel's std, less its projections on the mean
    and the weight, which cancel most of it; and at 64x64 the twins' GN
    normalises C5's 32 channels one a group over 2x2 cells. The two
    packages' rounding reaches 2e-3 of the largest gradient of the Faster
    twin's second head conv (std 0.083: a 12-fold scaling) and 3.5e-4 of
    its stem's (std 0.025). The modules themselves are held to 1e-5 of their
    largest gradient (test_trunk_options_match_jax,
    test_neck_options_match_jax)."""
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named

    assert set(out["losses"]) == set(names) == set(out["got_losses"])
    for k in names:
        assert out["got_losses"][k] == pytest.approx(float(out["losses"][k]), rel=1e-5), k
    model = out["model"]
    want = flax_tree_to_named(out["grads"], {k: tuple(p.shape) for k, p in model.named_parameters()})
    top = max(float(np.abs(w).max()) for w in want.values())
    n = 0
    for k, p in model.named_parameters():
        got = np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got, want[k], rtol=1e-3, atol=max(5e-3 * scale, 1e-5 * top),
                                   err_msg=k)
        n += int(scale > 1e-5 * top)
    return n


@pytest.mark.parametrize("name", list(ZOO))
def test_tiny_zoo_model_matches_jax(name):
    """Eval detections, losses and gradients, the bridge both ways and the
    optimizer's labels, in one test so that a worker builds each model
    once."""
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.utils.param_bridge import name_map

    if name in FLOAT64_TWINS:
        with _port_computes_in_float64():
            out = model_outputs(zoo_cfg(name), prepare=_fold_in_float64,
                                compiler_options=FAST_COMPILE)
    else:
        out = model_outputs(zoo_cfg(name), prepare=_fold, compiler_options=FAST_COMPILE)
    got, want = out["got_dets"], out["dets"]
    for f in ("boxes", "scores", "labels", "mask"):
        assert tuple(getattr(got, f).shape) == np.asarray(getattr(want, f)).shape, f
    for b in range(want.mask.shape[0]):
        assert (np.asarray(want.scores[b])[np.asarray(want.mask[b])] > 0).any(), b
        assert_same_detection_sets(_rows(got, b), _rows(want, b), box_atol=1e-3,
                                   score_atol=5e-5)
    losses = FAST_LOSSES if name.startswith("faster") else GRID_LOSSES
    if "USE_WS" in str(ZOO[name]):
        assert _ws_losses_and_gradients_match(out, losses) > 30
    else:
        assert assert_losses_and_gradients_match(out, losses) > 30
    assert_bridge_round_trip(out)
    model, params = out["model"], out["params"]
    names = name_map(params)
    for freeze_at in (0, 2):
        want = _flat(param_label_tree(params, freeze_at))
        got = classify_params(model, freeze_at)
        assert set(got) == set(names.values())
        for path, key in names.items():
            assert got[key] == want[path], (freeze_at, key)
    labels = classify_params(model, 2)
    if "USE_GN" in str(ZOO[name]):
        assert any(v == "gn" for v in labels.values())
        assert labels["backbone.layer1.0.bn1.weight"] == "frozen"


# --- every option builds -----------------------------------------------------


def _trunk_option_cfgs():
    """(label, JAX cfg) for every combination of the trunk's options that the
    JAX builders take: GN, WS, aligned, the 3x3x3 stem, AVG_DOWN, a context
    per stage, on RESNET (bottleneck and basic) and RESNEXT."""
    contexts = itertools.cycle([("none",) * 4, ("se",) * 4, ("none", "gcb", "gcb", "gcb"),
                                ("gcb", "none", "se", "none")])
    for section in ("RESNET", "RESNEXT"):
        for gn, ws, align, stem, avg, bottleneck in itertools.product((False, True), repeat=6):
            if section == "RESNEXT" and not bottleneck:
                continue
            if not bottleneck and align:
                continue
            cfg = _flagship_cfg(tiny=True)
            cfg.BACKBONE.CONV_BODY = section.lower()
            r = cfg.BACKBONE[section]
            r.USE_GN, r.USE_WS, r.USE_ALIGN, r.USE_3x3x3HEAD, r.AVG_DOWN = gn, ws, align, stem, avg
            r.STAGE_WITH_CONTEXT = next(contexts)
            if section == "RESNET":
                r.BOTTLENECK = bottleneck
                r.BASE_PLANES = 64
            else:
                r.C, r.WIDTH = 8, 8
            yield f"{section} gn={gn} ws={ws} align={align} stem={stem} avg={avg}", cfg


def _neck_option_cfgs():
    for body, norm, extra, ws in itertools.product(("fpn", "hrfpn", "nasfpn", "bifpn"),
                                                   ("none", "gn", "bn"), (False, True),
                                                   (False, True)):
        cfg = _flagship_cfg(tiny=True)
        cfg.FPN.BODY = body
        if body == "fpn":
            cfg.FPN.USE_GN, cfg.FPN.USE_BN = norm == "gn", norm == "bn"
            cfg.FPN.EXTRA_CONV_LEVELS, cfg.FPN.USE_WS = extra, ws
        else:
            section = cfg.FPN[body.upper()]
            section.USE_GN, section.USE_BN, section.USE_LITE = norm == "gn", norm == "bn", ws
            if body == "hrfpn":
                section.POOLING_TYPE = "MAX" if extra else "AVG"
        yield f"{body} norm={norm} extra={extra} ws/lite={ws}", cfg


def test_every_trunk_and_neck_option_builds_on_the_meta_device():
    """The port builds every combination on the meta device, where the JAX
    builders take it too; the C4 heads' stage 5 and the ConvFC head with
    their options as well."""
    import torch

    from cpm_tpu_torch.modeling.model import GeneralizedRCNN

    n = 0
    cfgs = list(_trunk_option_cfgs()) + list(_neck_option_cfgs())
    for head, ctx in (("resnet_c5_head", "se"), ("resnet_2mlp_head", "gcb")):
        cfg = tiny_cfg(FAST_TINY.replace("tiny_fast_rcnn", "tiny_fast_rcnn_c4"))
        r = cfg.BACKBONE.RESNET
        cfg.FAST_RCNN.ROI_BOX_HEAD = head
        r.STAGE_WITH_CONTEXT, r.USE_GN, r.USE_WS, r.AVG_DOWN, r.WIDTH = ("none",) * 3 + (ctx,), True, True, True, 32
        cfgs.append((f"c4 {head}", cfg))
    cfgs.append(("convfc ws", tiny_cfg(FAST_TINY, **{"FAST_RCNN.ROI_BOX_HEAD": "roi_xconv1fc_head",
                                                     "FAST_RCNN.CONVFC_HEAD.USE_WS": True})))
    for label, cfg in cfgs:
        jax_registry.BACKBONES[cfg.BACKBONE.CONV_BODY](cfg)
        if cfg.MODEL.FPN_ON:
            jax_registry.FPN_BODY[cfg.FPN.BODY](cfg)
        with torch.device("meta"):
            model = GeneralizedRCNN(cfg)
        assert all(p.is_meta for p in model.parameters()), label
        n += 1
    assert n > 100
