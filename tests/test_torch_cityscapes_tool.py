"""The port's COCO -> Cityscapes checkpoint converter
(cpm_tpu_torch/tools/coco_model_to_cityscapes.py) against the JAX package's
tool (tools/scripts/coco_model_to_cityscapes.py), on the CPU.

A tiny CPM model with 81 classes (cfgs/debug/tiny_cpm.yaml) is checkpointed
by the port; its weights are bridged into the JAX model's flax tree (its
structure from an abstract init) and remapped there by the JAX tool, whose
output comes back through the bridge onto a 9-class port model. The port's
tool on the checkpoint must give the same tensors bit for bit (every
Cityscapes class maps to a COCO one, so each is a copied row), with the
class axis at dim 0; the optimizer's per-parameter state goes and the step
stays. With classes mapped to no COCO class, those rows are drawn from the
source tensor's mean and std.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import os
import sys
import types

import jax
import numpy as np
import pytest

from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "cfgs", "debug", "tiny_cpm.yaml")
sys.path.insert(0, REPO)


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included, with a function;
    torch's first optimizer call in the worker fails on them
    (tests/test_torch_checkpoint_cli.py says more)."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


def _cfgs(num_classes):
    from cpm_tpu.config import get_default_cfg as jax_default_cfg
    from cpm_tpu.config import merge_cfg_from_file as jax_merge_file
    from cpm_tpu.config import merge_cfg_from_list as jax_merge_list

    from cpm_tpu_torch.config import get_default_cfg, merge_cfg_from_file, merge_cfg_from_list

    opts = ["MODEL.NUM_CLASSES", str(num_classes), "TPU.COMPUTE_DTYPE", "float32"]
    want, got = jax_default_cfg(), get_default_cfg()
    jax_merge_file(TINY, want)
    jax_merge_list(opts, want)
    merge_cfg_from_file(TINY, got)
    merge_cfg_from_list(opts, got)
    return want, got


def test_the_port_tool_remaps_as_the_jax_tool_does(tmp_path, capsys):
    import torch

    from cpm_tpu.modeling.model import build_model as jax_build_model
    from tools.scripts.coco_model_to_cityscapes import convert_tree

    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.train import create_train_state
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools import coco_model_to_cityscapes as tool
    from cpm_tpu_torch.utils.param_bridge import flax_to_state_dict, state_dict_to_flax

    want_cfg, cfg = _cfgs(81)
    model, optimizer, state = create_train_state(cfg, "cpu", seed=3)
    # a momentum buffer for every parameter, as a trained checkpoint has
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.full_like(p, 1e-3)
    optimizer.step()
    state.step = 7
    CheckPointer(str(tmp_path / "coco")).save(state, 7)

    payload = tool.main(["--ckpt", str(tmp_path / "coco"), "--out", str(tmp_path / "cs")])
    got = torch.load(tmp_path / "cs" / "model_latest", weights_only=True)
    assert got["step"] == 7 and got["optimizer"]["state"] == {}
    assert got["optimizer"]["param_groups"] == payload["optimizer"]["param_groups"]
    assert "remapping class blob" in capsys.readouterr().out

    images = np.zeros((1, 64, 64, 3), np.uint8)
    sizes = np.array([[64, 64]], np.int32)
    jm = jax_build_model(want_cfg)
    like = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, images, sizes, train=False))["params"]
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), like)
    remapped = convert_tree(state_dict_to_flax(model.state_dict(), like))
    _, cs_cfg = _cfgs(9)
    want = flax_to_state_dict(remapped, build_model(cs_cfg, "cpu", seed=0))
    assert set(got["model"]) == set(want)
    moved = 0
    for k, w in want.items():
        g = got["model"][k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k
        moved += g.shape != model.state_dict()[k].shape
    assert moved >= 2  # the classifier's weight and bias at least
    # the copied rows are the source's rows, class axis first
    cls = next(k for k, v in model.state_dict().items() if v.dim() == 2 and v.shape[0] == 81)
    for cs_id, coco_id in tool.CITYSCAPES_TO_COCO.items():
        assert torch.equal(got["model"][cls][cs_id], model.state_dict()[cls][coco_id])


def test_rows_with_no_coco_class_are_drawn_from_the_sources_statistics():
    from cpm_tpu_torch.tools import coco_model_to_cityscapes as tool

    src = np.random.RandomState(1).normal(0.3, 0.05, (4 * 81, 1024)).astype(np.float32)
    mapping = {**tool.CITYSCAPES_TO_COCO, 4: -1, 5: -1, 6: -1}
    out = tool.remap_class_axis(src, 4, mapping)
    assert out.shape == (4 * 9, 1024) and out.dtype == np.float32
    np.testing.assert_array_equal(out[4:8], src[4:8])  # person
    drawn = out[16:28]  # classes 4-6, 4 rows each
    assert abs(float(drawn.mean()) - float(src.mean())) < 0.01 * float(src.std())
    assert float(drawn.std()) == pytest.approx(float(src.std()), rel=0.02)
