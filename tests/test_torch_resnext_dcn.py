"""The ResNeXt and deformable-conv trunks and the whole CPM model on them: the
JAX package against the port, on the CPU.

* the trunk alone, both packages' `ResNetBody` built directly at a small
  width (ResNeXt blocks with 4 groups, a plain, a deform, a deformv2 and a
  deform stage), outputs and every parameter gradient;
* a tiny whole model on a ResNeXt-DCN trunk (`x101_dcn_cfg(tiny=True)`): eval
  detections, the eight training losses, every gradient and one SGD step;
* a tiny whole model on a ResNet trunk with BASE_PLANES and deform / deformv2
  stages: eval detections and training losses;
* the optimizer's parameter groups against `param_label_tree`, and
  `x101_dcn_cfg()` against the shipped YAML.

A fresh deformable conv predicts zero offsets, which would leave every sample
on a cell; the offset convs are therefore drawn from a numpy seed (kernels
and biases), in the flax tree, and reach the port through the bridge. The
samplers' uniform draws are made equal as tests/test_torch_train.py does.

Tolerances (f32 on the CPU), those of tests/test_torch_train.py and
tests/test_torch_model.py: detections labels and mask exactly, boxes 1e-2 px,
scores 1e-5; losses 1e-5 relative; gradients rtol 1e-3 / atol 1e-5;
parameters after one SGD step rtol 1e-4 / atol 1e-6; the trunk's outputs rtol
1e-4 / atol 1e-4 of activations that reach the hundreds.

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.config import get_default_cfg as jax_default_cfg
from cpm_tpu.config import merge_cfg_from_file as jax_merge_cfg_from_file
from cpm_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from cpm_tpu.engine.train import batch_gt as jax_batch_gt
from cpm_tpu.modeling import registry as jax_registry
from cpm_tpu.modeling.backbone.resnet import ResNetBody as JaxResNetBody
from cpm_tpu.modeling.model import build_model as jax_build_model
from cpm_tpu.solver import build_optimizer as jax_build_optimizer
from cpm_tpu.solver import make_lr_fn as jax_make_lr_fn
from cpm_tpu.solver.optimizer import param_label_tree
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)
from tests.torch_support import memo, shared

YAML = ("cfgs/rcnn/mscoco/grid_cascade/iou_helper/rescore/backbone/"
        "e2e_grid_cascade@567_rcnn_X-101-32x4d-FPN-DCN_2x.yaml")
LOSS_NAMES = (
    "loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_grid_1",
    "loss_grid_2", "loss_grid_3", "loss_iou_3", "loss_rescore",
)
STAGES = ("normal", "deform", "deformv2", "deform")


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


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflat(flat):
    out = {}
    for path, leaf in flat.items():
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = leaf
    return out


def _with_seeded_offset_convs(params, seed, kernel_std, bias_std=0.7):
    """The params tree with every offset conv (`conv_offset`,
    `conv_offset_mask`; fresh ones are zero) drawn from a numpy seed. Works on
    traced leaves too, so that it can run inside a jitted function."""
    rng = np.random.RandomState(seed)
    flat = dict(_flat(params))
    n = 0
    for path in sorted(flat):
        if path[-2] in ("conv_offset", "conv_offset_mask"):
            std = kernel_std if path[-1] == "kernel" else bias_std
            flat[path] = jnp.asarray((rng.randn(*flat[path].shape) * std).astype(np.float32))
            n += 1
    assert n > 0
    return _unflat(flat)


def _offset_spread(model, run):
    """Largest |offset| that each offset conv of `model` predicts during run()."""
    peaks, hooks = {}, []
    for name, mod in model.named_modules():
        if name.endswith(("conv_offset", "conv_offset_mask")):
            taps = 18   # the offsets; a v2 conv's last 9 channels are masks
            hooks.append(mod.register_forward_hook(
                lambda m, a, out, name=name: peaks.__setitem__(
                    name, float(out[:, :taps].detach().abs().max()))))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return peaks


# --- the trunk alone ---------------------------------------------------------


@pytest.fixture(scope="module")
def trunk():
    return memo("trunk", _trunk)


def _trunk():
    import torch

    from cpm_tpu_torch.modeling.backbone.resnet import ResNetBody
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named

    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 48, 3).astype(np.float32)
    jbody = JaxResNetBody(layers=(1, 1, 1, 1), width=16, groups=4, stride_3x3=True,
                          base_planes=8, stage_with_conv=STAGES)
    params = jax.device_get(jax.jit(lambda key, x: _with_seeded_offset_convs(
        jbody.init(key, x)["params"], 1, kernel_std=0.02))(jax.random.PRNGKey(0), jnp.asarray(x)))
    gs = [rng.randn(2, 64 // s, 48 // s, 32 * m).astype(np.float32)
          for s, m in ((4, 1), (8, 2), (16, 4), (32, 8))]

    def loss(p):
        feats = jbody.apply({"params": p}, jnp.asarray(x))
        return sum(jnp.sum(f * g) for f, g in zip(feats, gs)), feats

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    body = ResNetBody(layers=(1, 1, 1, 1), width=16, groups=4, stride_3x3=True, base_planes=8,
                      stage_with_conv=STAGES, generator=torch.Generator().manual_seed(0))
    # the bridge names the trunk's leaves under `backbone/`
    shapes = {f"backbone.{k}": tuple(v.shape) for k, v in body.state_dict().items()}
    named = flax_tree_to_named({"backbone": params}, shapes)
    body.load_state_dict({k[len("backbone."):]: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in named.items()})
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = None

    def run():
        nonlocal got
        got = body(tx)

    peaks = _offset_spread(body, run)
    sum((f.permute(0, 2, 3, 1) * torch.from_numpy(g)).sum() for f, g in zip(got, gs)).backward()
    want_named = flax_tree_to_named({"backbone": jax.device_get(want_grads)}, shapes)
    return body, got, jax.device_get(want), want_named, peaks


def test_trunk_is_a_resnext_with_deform_stages(trunk):
    from cpm_tpu_torch.ops.deform_conv import DeformConvPack, ModulatedDeformConvPack

    body, *_ = trunk
    kinds = [type(getattr(body, f"layer{i}")[0].conv2).__name__ for i in (1, 2, 3, 4)]
    assert kinds == ["Conv2d", "DeformConvPack", "ModulatedDeformConvPack", "DeformConvPack"]
    # width rule floor(planes * 16 / 64) * 4, four groups, the stride on the 3x3
    assert body.layer1[0].conv2.groups == 4 and body.layer1[0].conv2.weight.shape == (8, 2, 3, 3)
    assert isinstance(body.layer2[0].conv2, DeformConvPack)
    assert body.layer2[0].conv2.weight.shape == (16, 4, 3, 3) and body.layer2[0].conv2.stride == 2
    assert body.layer2[0].conv1.stride == (1, 1)
    assert isinstance(body.layer3[0].conv2, ModulatedDeformConvPack)
    assert body.layer3[0].conv2.conv_offset_mask.weight.shape == (27, 32, 3, 3)
    assert body.dim_out == (32, 64, 128, 256)


def test_trunk_outputs_match_jax_with_offsets_that_leave_the_cells(trunk):
    body, got, want, _, peaks = trunk
    assert len(peaks) == 3 and all(0.5 < p < 60 for p in peaks.values()), peaks
    for f, w in zip(got, want):
        assert tuple(f.shape) == (w.shape[0], w.shape[3], w.shape[1], w.shape[2])
        np.testing.assert_allclose(f.detach().permute(0, 2, 3, 1).numpy(), w, rtol=1e-4, atol=1e-4)


def test_trunk_gradients_match_jax(trunk):
    body, _, _, want, _ = trunk
    n = 0
    for name, p in body.named_parameters():
        w = want[f"backbone.{name}"]
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale, rtol=1e-3, atol=1e-5,
                                   err_msg=name)
        n += int(np.abs(w).max() > 0)
    assert n == len(want)
    assert np.abs(want["backbone.layer3.0.conv2.conv_offset_mask.weight"]).max() > 0


# --- whole models ------------------------------------------------------------

_REAL_UNIFORM = jax.random.uniform


class RecordedUniform:
    """Stands in for jax.random.uniform while a JAX function is traced: for
    the calls of the JAX package's sampler, the next array of a seeded numpy
    stream, recorded for the port; other callers get the real function."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.arrays = []

    def __call__(self, key, shape=(), *args, **kwargs):
        if sys._getframe(1).f_globals["__name__"] != "cpm_tpu.utils.sampler":
            return _REAL_UNIFORM(key, shape, *args, **kwargs)
        a = self.rng.rand(*shape).astype(np.float32)
        self.arrays.append(a)
        return jnp.asarray(a)


def _resnext_cfgs():
    from cpm_tpu_torch.config import x101_dcn_cfg

    jcfg = jax_default_cfg()
    jax_merge_cfg_from_file(YAML, jcfg)
    port = x101_dcn_cfg(tiny=True)
    # the same cuts on the JAX side, key by key
    for section, key in (
        ("MODEL", "NUM_CLASSES"), ("FPN", "DIM"), ("RPN", "PRE_NMS_TOP_N_TRAIN"),
        ("RPN", "POST_NMS_TOP_N_TRAIN"), ("RPN", "FPN_POST_NMS_TOP_N_TRAIN"),
        ("RPN", "PRE_NMS_TOP_N_TEST"), ("RPN", "POST_NMS_TOP_N_TEST"),
        ("RPN", "FPN_POST_NMS_TOP_N_TEST"),
    ):
        jcfg[section][key] = port[section][key]
    jcfg.BACKBONE.RESNEXT.LAYERS = port.BACKBONE.RESNEXT.LAYERS
    jcfg.BACKBONE.RESNEXT.C = port.BACKBONE.RESNEXT.C
    g, pg = jcfg.GRID_RCNN, port.GRID_RCNN
    g.MLP_HEAD.MLP_DIM = pg.MLP_HEAD.MLP_DIM
    for key in ("BATCH_SIZE_PER_IMAGE", "MAX_SAMPLE_NUM_GRID", "TEST_MAX_DETECTIONS"):
        g[key] = pg[key]
    g.GRID_HEAD.NUM_CONVS = pg.GRID_HEAD.NUM_CONVS
    g.GRID_HEAD.POINT_FEAT_CHANNELS = pg.GRID_HEAD.POINT_FEAT_CHANNELS
    return jcfg, port


def _resnet_cfgs():
    from __graft_entry__ import _flagship_cfg
    from cpm_tpu_torch.config import flagship_cfg

    jcfg, port = _flagship_cfg(tiny=True), flagship_cfg(tiny=True)
    for c in (jcfg, port):
        c.BACKBONE.RESNET.STAGE_WITH_CONV = ("normal", "deformv2", "deform", "deformv2")
    return jcfg, port


def _jax_whole_model(jcfg, batch, images, sizes, with_step):
    """The JAX side of `_whole_model`, with the draws its samplers made."""
    jmodel = jax_build_model(jcfg)

    # one program: fresh params, the offset convs seeded, the eval forward
    @jax.jit
    def init_and_detect(images, sizes):
        p = jmodel.init({"params": jax.random.PRNGKey(0)}, images, sizes, train=False)["params"]
        p = _with_seeded_offset_convs(p, 2, kernel_std=0.05)
        return p, jmodel.apply({"params": p}, images, sizes, train=False)

    params, want_dets = jax.device_get(init_and_detect(images, sizes))

    def loss_fn(p):
        losses = jmodel.apply(
            {"params": p}, batch["images"], batch["image_sizes"], gt=jax_batch_gt(batch),
            train=True, rngs={"sample": jax.random.PRNGKey(1)})
        return sum(losses.values()), losses

    jx = dict(params=params, dets=want_dets)
    mp = pytest.MonkeyPatch()
    try:
        draws = RecordedUniform(7)
        mp.setattr(jax.random, "uniform", draws)
        if with_step:
            (_, jx["losses"]), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
            # the update of cpm_tpu/engine/train.py::make_train_step at step 0
            tx = jax_build_optimizer(jcfg, params, jax_make_lr_fn(jcfg.SOLVER))
            updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
            jx["grads"] = jax.device_get(grads)
            jx["params1"] = jax.device_get(jax.tree_util.tree_map(lambda p, u: p + u, params, updates))
        else:
            jx["losses"] = jax.jit(lambda p: loss_fn(p)[1])(params)
        jx["losses"] = jax.device_get(jx["losses"])
    finally:
        mp.undo()
    jx["draws"] = draws.arrays
    return jx


def _whole_model(cfgs, with_step, share):
    """Both packages on one tiny config: eval detections and training losses;
    with_step, also every gradient and the parameters after one SGD step.
    The JAX side is computed once a session (`share`: tmp_path_factory and
    a name)."""
    import torch

    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.utils.param_bridge import load_flax_params
    from cpm_tpu_torch.utils.sampler import Draws

    jcfg, cfg = cfgs
    for c in (jcfg, cfg):
        c.TPU.COMPUTE_DTYPE = "float32"
        c.GRID_RCNN.SCORE_THRESH = 0.0   # random weights score near 1/9
    batch = jax_synthetic_batch(2, 64, 64, max_gt=4, num_classes=9)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[64, 64], [56, 48]], np.int32)
    jx = shared(*share, lambda: _jax_whole_model(jcfg, batch, images, sizes, with_step))
    params = jx["params"]

    model, optimizer, state = create_train_state(cfg, "cpu", seed=0)
    load_flax_params(model, params)
    pt = dict(model=model, optimizer=optimizer)
    pt["dets"] = make_forward_fn(cfg, model)(images, sizes)
    port_draws = Draws(jx["draws"])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    def train_forward():
        pt["losses"] = model(
            tb["images"], tb["image_sizes"], train=True, draws=port_draws,
            gt=dict(boxes=tb["gt_boxes"], labels=tb["gt_labels"], mask=tb["gt_mask"]))

    pt["offset_peaks"] = _offset_spread(model, train_forward)
    pt["draw_shapes"] = port_draws.shapes
    if with_step:
        sum(pt["losses"].values()).backward()
        pt["grads"] = {k: None if p.grad is None else p.grad.clone()
                       for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        state.draws = Draws(jx["draws"])
        state, pt["metrics"] = make_train_step(cfg, model, optimizer)(state, batch)
    pt["losses"] = {k: float(v.detach()) for k, v in pt["losses"].items()}
    return cfg, jx, pt


@pytest.fixture(scope="module")
def resnext_model(tmp_path_factory):
    return memo("resnext_model", lambda: _whole_model(
        _resnext_cfgs(), with_step=True, share=(tmp_path_factory, "resnext_model")))


@pytest.fixture(scope="module")
def resnet_dcn_model(tmp_path_factory):
    return memo("resnet_dcn_model", lambda: _whole_model(
        _resnet_cfgs(), with_step=False, share=(tmp_path_factory, "resnet_dcn_model")))


def _rows(boxes, scores, labels, mask):
    return np.concatenate(
        [labels[mask][:, None].astype(np.float64), boxes[mask], scores[mask][:, None]], 1)


def _assert_same_detections(got, want):
    """Rows (label, box, score) match one to one: labels exactly, boxes to
    1e-2 px, scores to 1e-5."""
    fields = ("boxes", "scores", "labels", "mask")
    for i in range(np.asarray(want.mask).shape[0]):
        w = _rows(*(np.asarray(getattr(want, f)[i]) for f in fields))
        g = _rows(*(getattr(got, f)[i].numpy() for f in fields))
        assert len(g) == len(w) > 0
        unused = list(range(len(g)))
        for row in w:
            for j in unused:
                if (g[j][0] == row[0] and np.abs(g[j][1:5] - row[1:5]).max() <= 1e-2
                        and abs(g[j][5] - row[5]) <= 1e-5):
                    unused.remove(j)
                    break
            else:
                raise AssertionError(f"image {i}: no detection matches {row}")


def _assert_losses(jx, pt):
    assert [tuple(s) for s in pt["draw_shapes"]] == [a.shape for a in jx["draws"]]
    assert len(jx["draws"]) == 7
    assert set(jx["losses"]) == set(LOSS_NAMES) == set(pt["losses"])
    for name in LOSS_NAMES:
        want = float(jx["losses"][name])
        assert np.isfinite(want) and want > 0
        assert pt["losses"][name] == pytest.approx(want, rel=1e-5), name


@pytest.mark.parametrize("which", ["resnext_model", "resnet_dcn_model"])
def test_eval_detections_match_jax(which, request):
    _, jx, pt = request.getfixturevalue(which)
    _assert_same_detections(pt["dets"], jx["dets"])


@pytest.mark.parametrize("which", ["resnext_model", "resnet_dcn_model"])
def test_training_losses_match_jax_with_offsets_that_leave_the_cells(which, request):
    _, jx, pt = request.getfixturevalue(which)
    peaks = pt["offset_peaks"]
    assert len(peaks) == 3 and all(0.5 < p < 60 for p in peaks.values()), peaks
    _assert_losses(jx, pt)


def test_resnext_model_is_built_as_configured(resnext_model):
    from cpm_tpu_torch.ops.deform_conv import DeformConvPack

    cfg, jx, pt = resnext_model
    body = pt["model"].backbone
    assert cfg.BACKBONE.CONV_BODY == "resnext" and body.dim_out == (256, 512, 1024, 2048)
    assert body.layer1[0].conv2.groups == 2 and body.layer1[0].conv2.stride == (1, 1)
    for i in (2, 3, 4):
        conv2 = getattr(body, f"layer{i}")[0].conv2
        assert isinstance(conv2, DeformConvPack) and conv2.groups == 2 and conv2.stride == 2
    assert "layer2_0" in jx["params"]["backbone"]
    assert set(jx["params"]["backbone"]["layer2_0"]["conv2"]) == {"conv_offset", "weight"}


def test_resnext_gradients_match_jax_and_frozen_have_none(resnext_model):
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named

    cfg, jx, pt = resnext_model
    model = pt["model"]
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    want = flax_tree_to_named(jx["grads"], shapes)
    labels = classify_params(model, int(cfg.BACKBONE.RESNET.FREEZE_AT))
    n_nonzero = 0
    for name, g in pt["grads"].items():
        if labels[name] == "frozen":
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-3, atol=1e-5, err_msg=name)
        n_nonzero += int(np.abs(want[name]).max() > 0)
    assert n_nonzero > 60
    for i in (2, 3, 4):
        for leaf in ("weight", "conv_offset.weight", "conv_offset.bias"):
            assert np.abs(want[f"backbone.layer{i}.0.conv2.{leaf}"]).max() > 0, (i, leaf)


def test_resnext_one_sgd_step_matches_jax(resnext_model):
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named, state_dict_to_flax

    _, jx, pt = resnext_model
    for name in LOSS_NAMES:
        assert float(pt["metrics"][name]) == pytest.approx(float(jx["losses"][name]), rel=2e-5), name
    model = pt["model"]
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    want = flax_tree_to_named(jx["params1"], shapes)
    start = flax_tree_to_named(jx["params"], shapes)
    moved = set()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        if not np.array_equal(want[name], start[name]):
            moved.add(name)
    assert len(moved) > 60
    assert {"backbone.layer2.0.conv2.conv_offset.weight", "backbone.layer4.0.conv2.conv_offset.bias",
            "backbone.layer3.0.conv2.weight"} <= moved
    assert not any(k.startswith(("backbone.conv1", "backbone.layer1.")) for k in moved)
    back = _flat(state_dict_to_flax(model.state_dict(), jx["params1"]))
    for path, leaf in _flat(jx["params1"]).items():
        np.testing.assert_allclose(back[path], leaf, rtol=1e-4, atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("which", ["resnext_model", "resnet_dcn_model"])
def test_optimizer_labels_match_jax(which, request):
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.utils.param_bridge import name_map

    cfg, jx, pt = request.getfixturevalue(which)
    model = pt["model"]
    names = name_map(jx["params"])
    for freeze_at in (0, 2, 3):
        want = _flat(param_label_tree(jx["params"], freeze_at))
        got = classify_params(model, freeze_at)
        assert set(names.values()) == set(got)
        for path, key in names.items():
            assert got[key] == want[path], (freeze_at, key)
    groups = {g["name"]: {id(p) for p in g["params"]} for g in pt["optimizer"].param_groups}
    by_name = dict(model.named_parameters())
    offset_conv = next(k for k in by_name if k.startswith("backbone.layer2.0.conv2.conv_offset"))
    stem = offset_conv.rsplit(".", 1)[0]
    assert id(by_name[f"{stem}.bias"]) in groups["bias"]
    assert id(by_name[f"{stem}.weight"]) in groups["nonbias"]
    assert id(by_name["backbone.layer2.0.conv2.weight"]) in groups["nonbias"]
    # FREEZE_AT is read from BACKBONE.RESNET whatever the trunk
    assert not by_name["backbone.layer1.0.conv2.weight"].requires_grad
    assert int(cfg.BACKBONE.RESNET.FREEZE_AT) == 2


def test_x101_dcn_cfg_equals_the_yaml():
    from cpm_tpu_torch.config import get_default_cfg, merge_cfg_from_file, x101_dcn_cfg

    got = _flat(x101_dcn_cfg())
    want = get_default_cfg()
    merge_cfg_from_file(YAML, want)
    want = _flat(want)
    jwant = jax_default_cfg()
    jax_merge_cfg_from_file(YAML, jwant)
    jwant = _flat(jwant)
    assert set(got) == set(want) == set(jwant)
    for key in want:
        assert got[key] == want[key] == jwant[key], key
    assert got[("BACKBONE", "RESNEXT", "LAYERS")] == (3, 4, 23, 3)
    assert got[("BACKBONE", "RESNEXT", "STAGE_WITH_CONV")] == ("normal", "deform", "deform", "deform")


def test_unported_trunk_options_go_on_raising():
    """Each trunk option that the JAX package builds builds in the port, on
    RESNET and RESNEXT, with the JAX trunk's parameter shapes (its abstract
    init, through the bridge); what the JAX package refuses too, a deformv3
    stage and a mobilenet_v2 body, goes on raising. (The options' numbers
    are held in tests/test_torch_zoo.py.)"""
    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.modeling.backbone.resnet import BACKBONES
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named

    image = jnp.zeros((1, 64, 64, 3), jnp.float32)
    n = 0
    for section, make in (("RESNET", _resnet_cfgs), ("RESNEXT", _resnext_cfgs)):
        for key, value in (("USE_ALIGN", True), ("USE_GN", True), ("USE_WS", True),
                           ("USE_3x3x3HEAD", True), ("AVG_DOWN", True),
                           ("STAGE_WITH_CONTEXT", ("none", "gcb", "none", "none"))):
            jcfg, cfg = make()
            for c in (jcfg, cfg):
                c.BACKBONE[section][key] = value
                if key == "USE_GN":   # the JAX GroupNorm's 32 groups
                    if section == "RESNET":
                        c.BACKBONE.RESNET.BASE_PLANES = 32
                    else:
                        c.BACKBONE.RESNEXT.C = 8
            body = cfg.BACKBONE.CONV_BODY
            jbody = jax_registry.BACKBONES[body](jcfg)
            like = jax.eval_shape(lambda: jbody.init(jax.random.PRNGKey(0), image))["params"]
            like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), like)
            trunk = BACKBONES[body](cfg, None)
            shapes = {f"backbone.{k}": tuple(p.shape) for k, p in trunk.named_parameters()}
            named = flax_tree_to_named({"backbone": like}, shapes)
            assert set(named) == set(shapes), (section, key)
            n += len(named)
        jcfg, cfg = make()
        cfg.BACKBONE[section].STAGE_WITH_CONV = ("normal", "deformv3", "normal", "normal")
        with pytest.raises(NotImplementedError, match="deformv3"):
            build_model(cfg, "cpu")
    assert n > 500
    cfg = flagship_cfg(tiny=True)
    cfg.BACKBONE.CONV_BODY = "mobilenet_v2"
    with pytest.raises(NotImplementedError):
        build_model(cfg, "cpu")
