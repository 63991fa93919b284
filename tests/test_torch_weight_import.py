"""The port's importer of reference PyTorch checkpoints against the JAX
package's, on the CPU, bit for bit.

A reference-layout state_dict is built inside each test from seeded weights:
the JAX tiny model's flax tree (every leaf drawn from a numpy seed) goes
through the port's bridge (`utils/param_bridge.py::flax_to_state_dict`) and
then `chip_smoke.py::reference_state_dict`, the inverse of the importers'
name maps. First that writer is held against cpm_tpu: its
`import_cpm_checkpoint` must give the flax tree back exactly. Then the
port's `import_cpm_checkpoint` must give the bridged state_dict exactly. The
cases: ResNet (cfgs/debug/tiny_cpm.yaml, CONV1_RGB2BGR on) and a tiny
ResNeXt trunk with deform and deformv2 stages (`conv_offset` and
`conv_offset_mask` packs); trunks with BatchNorm running statistics (folded
in float64) and in caffe's affine form; a `torch.save`d file wrapped as
{"model": sd} or {"state_dict": sd} with `module.` keys; the strict VGG
rename; missing and unknown keys, which raise. Then the CLIs: `train_net`
with TRAIN.WEIGHTS and `test_net` with TEST.WEIGHTS load those weights.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import os
import sys
import types

import jax
import numpy as np
import pytest

from cpm_tpu.config import assert_and_infer_cfg as jax_infer_cfg
from cpm_tpu.config import get_default_cfg as jax_default_cfg
from cpm_tpu.config import merge_cfg_from_file as jax_merge_file
from cpm_tpu.config import merge_cfg_from_list as jax_merge_list
from cpm_tpu.modeling.model import build_model as jax_build_model
from cpm_tpu.utils import weight_import as jax_import

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "debug", "tiny_cpm.yaml")
DATA_DIR = os.path.join(REPO, "data")
X101 = os.path.join(REPO, "cfgs", "rcnn", "mscoco", "grid_cascade", "iou_helper", "rescore",
                    "backbone", "e2e_grid_cascade@567_rcnn_X-101-32x4d-FPN-DCN_2x.yaml")
# the X-101-DCN YAML narrowed: one block a stage, two groups, a deform and a
# deformv2 stage
X101_TINY = ("BACKBONE.RESNEXT.LAYERS", "(1, 1, 1, 1)", "BACKBONE.RESNEXT.C", "2",
             "BACKBONE.RESNEXT.STAGE_WITH_CONV", "('normal', 'deform', 'deformv2', 'deform')",
             "MODEL.NUM_CLASSES", "9", "FPN.DIM", "32", "GRID_RCNN.MLP_HEAD.MLP_DIM", "64",
             "GRID_RCNN.GRID_HEAD.NUM_CONVS", "2", "GRID_RCNN.GRID_HEAD.POINT_FEAT_CHANNELS", "8")
CONFIGS = {"resnet": (TINY, ()), "resnext_dcn": (X101, X101_TINY)}


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


def _cfgs(which):
    """Both packages' configs: the YAML, then the overrides."""
    from cpm_tpu_torch.config import assert_and_infer_cfg, get_default_cfg
    from cpm_tpu_torch.config import merge_cfg_from_file, merge_cfg_from_list

    yaml, opts = CONFIGS[which]
    want, got = jax_default_cfg(), get_default_cfg()
    jax_merge_file(yaml, want)
    merge_cfg_from_file(yaml, got)
    if opts:
        jax_merge_list(list(opts), want)
        merge_cfg_from_list(list(opts), got)
    return (jax_infer_cfg(want, make_immutable=False), assert_and_infer_cfg(got, make_immutable=False))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _seeded_flax_params(jcfg, seed=0):
    """The JAX model's flax tree with every leaf drawn from a numpy seed (so
    that every placement of every tensor is seen)."""
    model = jax_build_model(jcfg)
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, np.zeros((1, 64, 128, 3), np.uint8),
                           np.array([[64, 128]], np.int32), train=False)["params"])
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.1, shapes)


def _port_state(which, seed=0):
    """(jax cfg, port cfg, flax tree, the port's state_dict of that tree)."""
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import flax_to_state_dict

    jcfg, cfg = _cfgs(which)
    params = _seeded_flax_params(jcfg, seed)
    return jcfg, cfg, params, flax_to_state_dict(params, build_model(cfg, "cpu"))


def _assert_equal_state(got, want):
    import torch

    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("which", list(CONFIGS))
def test_cpm_checkpoint_import_matches_jax(which):
    import chip_smoke

    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.weight_import import import_cpm_checkpoint

    jcfg, cfg, params, port_sd = _port_state(which)
    assert cfg.MODEL.CONV1_RGB2BGR == (which == "resnet")
    ref = chip_smoke.reference_state_dict(port_sd, cfg.MODEL.CONV1_RGB2BGR)
    if which == "resnext_dcn":
        assert any(k.endswith("conv2.conv_offset.weight") for k in ref)
        assert any(k.endswith("conv2.conv_offset_mask.weight") for k in ref)
    # the writer: cpm_tpu's importer gives the flax tree back
    rebuilt = _flat(jax_import.import_cpm_checkpoint({k: v.numpy() for k, v in ref.items()}, jcfg))
    want = _flat(params)
    assert sorted(rebuilt) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(rebuilt[path], leaf, err_msg="/".join(path))
    # the port
    got = import_cpm_checkpoint(ref, cfg)
    _assert_equal_state(got, port_sd)
    build_model(cfg, "cpu").load_state_dict(got, strict=True)


def _bn_prefixes(trunk):
    return sorted({k.rsplit(".", 1)[0] for k in trunk
                   if k.startswith("bn") or ".bn" in k or ".downsample.1." in k})


@pytest.mark.parametrize("case", ["bn_statistics", "caffe_affine_rgb2bgr", "resnext_dcn_packs"])
def test_trunk_import_matches_jax(case):
    import chip_smoke
    import torch

    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import flax_tree_to_named
    from cpm_tpu_torch.utils.weight_import import (
        import_resnet_backbone_sd,
        merge_backbone_into_model,
        trunk_layers,
    )

    which = "resnext_dcn" if case == "resnext_dcn_packs" else "resnet"
    _, cfg, _, port_sd = _port_state(which, seed=1)
    rgb2bgr = case == "caffe_affine_rgb2bgr"
    trunk = chip_smoke.reference_trunk(port_sd, rgb2bgr)
    if case != "caffe_affine_rgb2bgr":
        # torchvision's BatchNorm: weight, bias and running statistics
        g = torch.Generator().manual_seed(2)
        for p in _bn_prefixes(trunk):
            n = trunk[f"{p}.weight"].numel()
            trunk[f"{p}.running_mean"] = torch.randn(n, generator=g)
            trunk[f"{p}.running_var"] = torch.rand(n, generator=g) * 2 + 0.01
            trunk[f"{p}.num_batches_tracked"] = torch.tensor(7)
        trunk["fc.weight"] = torch.randn(10, 2048, generator=g)  # the classifier, not imported
    layers = trunk_layers(cfg)
    want_tree = jax_import.import_resnet_backbone_sd(
        {k: v.numpy() for k, v in trunk.items()}, layers, rgb2bgr)
    model = build_model(cfg, "cpu")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items() if k.startswith("backbone.")}
    want = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            flax_tree_to_named({"backbone": want_tree}, shapes).items()}
    got = import_resnet_backbone_sd(trunk, layers, rgb2bgr)
    _assert_equal_state(got, want)
    if case == "caffe_affine_rgb2bgr":
        _assert_equal_state(got, {k: v for k, v in port_sd.items() if k.startswith("backbone.")})
    merge_backbone_into_model(model, got)
    _assert_equal_state({k: v for k, v in model.state_dict().items() if k in got}, got)


@pytest.mark.parametrize("wrapper", ["model", "state_dict", None])
def test_load_torch_state_dict_unwraps_and_strips_module(tmp_path, wrapper):
    import chip_smoke
    import torch

    from cpm_tpu_torch.utils.weight_import import import_cpm_checkpoint, load_torch_state_dict

    _, cfg, _, port_sd = _port_state("resnet")
    ref = chip_smoke.reference_state_dict(port_sd, cfg.MODEL.CONV1_RGB2BGR)
    saved = {f"module.{k}": v for k, v in ref.items()}
    path = str(tmp_path / "model_final.pth")
    torch.save({wrapper: saved, "iteration": 3} if wrapper else saved, path)
    got = load_torch_state_dict(path)
    _assert_equal_state(got, ref)
    jax_got = jax_import.load_torch_state_dict(path)
    assert sorted(jax_got) == sorted(got)
    for k, v in got.items():
        np.testing.assert_array_equal(jax_got[k], v.numpy())
    _assert_equal_state(import_cpm_checkpoint(path, cfg), port_sd)


def test_vgg16_reducedfc_mapping_is_strict(tmp_path):
    import torch

    from cpm_tpu_torch.utils.weight_import import (
        apply_pretrain_name_mapping,
        load_torch_state_dict,
        vgg16_reducedfc_name_mapping,
    )

    mapping = vgg16_reducedfc_name_mapping()
    assert mapping == jax_import.vgg16_reducedfc_name_mapping() and len(mapping) == 30
    donor = {k: torch.full((2,), float(i)) for i, k in enumerate(sorted(mapping))}
    path = str(tmp_path / "vgg16_reducedfc.pth")
    torch.save(donor, path)
    got = load_torch_state_dict(path)
    assert sorted(got) == sorted(mapping.values())
    assert torch.equal(got["features2.1.weight"], donor["24.weight"])
    assert torch.equal(got["conv7.bias"], donor["33.bias"])
    assert sorted(jax_import.load_torch_state_dict(path)) == sorted(got)
    torch.save({**donor, "99.weight": torch.zeros(1)}, path)
    for load in (load_torch_state_dict, jax_import.load_torch_state_dict):
        with pytest.raises(KeyError, match="99.weight"):
            load(path)
    # another file name keeps its keys
    assert apply_pretrain_name_mapping(donor, str(tmp_path / "resnet50.pth")) is donor


def test_missing_or_unknown_keys_raise():
    import chip_smoke
    import torch

    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.weight_import import (
        import_cpm_checkpoint,
        import_resnet_backbone_sd,
        merge_backbone_into_model,
        trunk_layers,
    )

    jcfg, cfg, _, port_sd = _port_state("resnet")
    ref = chip_smoke.reference_state_dict(port_sd, cfg.MODEL.CONV1_RGB2BGR)
    for key in ("Grid_Cascade_RCNN.Head_cls.fc7.weight", "Conv_Body.layer3.0.bn2.bias"):
        short = {k: v for k, v in ref.items() if k != key}
        name = key.replace("Conv_Body.", "")  # the trunk is read under its own names
        with pytest.raises(KeyError, match=name):
            import_cpm_checkpoint(short, cfg)
        with pytest.raises(KeyError, match=name):
            jax_import.import_cpm_checkpoint({k: v.numpy() for k, v in short.items()}, jcfg)
    # a whole checkpoint without its rescore branch imports, and the model refuses it
    partial = import_cpm_checkpoint(
        {k: v for k, v in ref.items() if "rescore" not in k}, cfg)
    with pytest.raises(RuntimeError, match="rescore"):
        build_model(cfg, "cpu").load_state_dict(partial, strict=True)

    trunk = import_resnet_backbone_sd(chip_smoke.reference_trunk(port_sd), trunk_layers(cfg))
    model = build_model(cfg, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bad = [
        (KeyError, "unknown", {**trunk, "backbone.layer5.0.conv1.weight": torch.zeros(1)}),
        (KeyError, "missing", {k: v for k, v in trunk.items() if k != "backbone.layer2.0.bn1.bias"}),
        (ValueError, "shape", {**trunk, "backbone.bn1.bias": torch.zeros(3)}),
    ]
    for error, match, imported in bad:
        with pytest.raises(error, match=match):
            merge_backbone_into_model(model, imported)
    _assert_equal_state(model.state_dict(), before)  # nothing loaded


def test_train_net_starts_from_train_weights(tmp_path, capsys):
    import chip_smoke
    import torch

    from cpm_tpu_torch.engine.train import create_train_state
    from cpm_tpu_torch.tools import train_net
    from cpm_tpu_torch.utils.weight_import import import_resnet_backbone_sd, trunk_layers

    _, cfg, _, port_sd = _port_state("resnet", seed=3)
    trunk = chip_smoke.reference_trunk(port_sd, cfg.MODEL.CONV1_RGB2BGR)
    path = tmp_path / "resnet50_caffe.pth"
    torch.save(trunk, path)
    ckpt = tmp_path / "ckpt"
    history = train_net.main(["--cfg", TINY, "--device", "cpu", "DATA_DIR", DATA_DIR, "CKPT",
                              str(ckpt), "TRAIN.WEIGHTS", str(path), "SOLVER.MAX_ITER", "1"])
    assert len(history) == 1 and np.isfinite(history[0]["total_loss"])
    assert f"loaded pretrained backbone from {path}" in capsys.readouterr().out
    imported = import_resnet_backbone_sd(trunk, trunk_layers(cfg), cfg.MODEL.CONV1_RGB2BGR)
    _assert_equal_state(imported, {k: v for k, v in port_sd.items() if k.startswith("backbone.")})
    after = torch.load(ckpt / "model_latest", map_location="cpu", weights_only=True)["model"]
    model, _, _ = create_train_state(cfg, "cpu", cfg.SEED)
    seeded = model.state_dict()
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert len(frozen) == 39
    for k, v in imported.items():
        if k in frozen:
            assert torch.equal(after[k], v), k  # the frozen trunk: the import, to the bit
        else:  # one step from the import, not from the seeded init
            assert (after[k] - v).abs().max() < 0.1 * (seeded[k] - v).abs().max(), k


def test_test_net_evaluates_test_weights(tmp_path, capsys):
    import chip_smoke
    import torch

    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.engine.test import run_inference_on_dataset
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools import test_net, train_net

    _, cfg, _, port_sd = _port_state("resnet", seed=4)
    path = tmp_path / "model_final.pth"
    torch.save({"model": chip_smoke.reference_state_dict(port_sd, cfg.MODEL.CONV1_RGB2BGR)}, path)
    common = ["--cfg", TINY, "--device", "cpu", "DATA_DIR", DATA_DIR, "CKPT", str(tmp_path)]
    train_net.main(common + ["SOLVER.MAX_ITER", "1"])
    capsys.readouterr()
    out = test_net.main(common + ["TEST.WEIGHTS", str(path)])
    # an existing TEST.WEIGHTS file wins over CKPT's checkpoint
    assert f"loaded torch weights from TEST.WEIGHTS: {path}" in capsys.readouterr().out
    _assert_equal_state(out["model"].state_dict(), port_sd)
    model = build_model(cfg, "cpu")
    model.load_state_dict(port_sd)
    cfg = train_net.load_config(TINY, ["DATA_DIR", DATA_DIR])
    (dataset,) = build_dataset(cfg, cfg.TEST.DATASETS, is_train=False)
    assert out["results"] == run_inference_on_dataset(cfg, model, dataset, progress_every=0)
    assert len(out["results"]) > 0 and "AP" in out["stats"]
