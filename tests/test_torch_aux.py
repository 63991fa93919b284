"""The port's box structures, image batches, FPN scales, proposal recall,
measurement and testing logger against the JAX package's, on the CPU.

* `structures/boxes.py` (`Boxes`, `nonempty_boxes_mask`,
  `flip_boxes_horizontal`, `resize_boxes`, the two converts, `pad_boxes_to`,
  `concat_boxes`) and `structures/image_batch.py` exactly, on seeded arrays;
* `modeling/fpn.py::fpn_spatial_scales` over the level rules;
* `evaluation/proposal_eval.py::evaluate_box_proposals` (every area range,
  two limits) exactly, on seeded proposals around seeded ground truth;
* `utils/measure.py`: `count_params` and `param_breakdown` equal the JAX
  package's on the tiny CPM model (its flax tree from
  tests/test_torch_layers.py's shared init), the flagship's count equals
  the pinned JAX count; `flops_of` equals XLA's cost analysis on a lone
  unpadded conv and a lone dense layer (XLA leaves out a padded conv's taps
  on the padding), and on the tiny model the port's count (products and
  convolutions, padded taps included) over XLA's (every op, the JAX side
  compiled at XLA's backend optimisation level 0) lies in [0.95, 1.05]
  (1.0142 when written);
  `tools/compute_flops.py` on the CPU;
* `utils/logger.py::TestingLogger`'s lines equal the JAX package's.

torch and the port's modules are imported inside the tests, so that
collecting this file loads no torch into a test worker.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpm_tpu.config import get_default_cfg as jax_default_cfg
from cpm_tpu.config import merge_cfg_from_file
from cpm_tpu.evaluation import proposal_eval as jpe
from cpm_tpu.modeling.fpn import fpn_spatial_scales as jax_fpn_scales
from cpm_tpu.modeling.model import build_model as jax_build_model
from cpm_tpu.structures import boxes as jb
from cpm_tpu.structures import image_batch as jib
from cpm_tpu.utils import measure as jm
from tests.test_torch_layers import TINY_CPM, jax_tiny_tpu_params
from tests.torch_support import _one_torch_thread  # noqa: F401  (autouse)

FAST_COMPILE = {"xla_backend_optimization_level": 0}


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


def _t(a):
    import torch

    return torch.tensor(np.asarray(a))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _boxes(rng, shape):
    xy = rng.uniform(0, 50, shape + (2,))
    wh = rng.uniform(-2, 30, shape + (2,))  # some empty
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("legacy_plus1", [True, False])
def test_box_functions(legacy_plus1):
    from cpm_tpu_torch.structures import boxes as tb

    rng = np.random.RandomState(0)
    b = _boxes(rng, (3, 7))
    kw = dict(legacy_plus1=legacy_plus1)
    _same(tb.nonempty_boxes_mask(_t(b)), jb.nonempty_boxes_mask(jnp.asarray(b)))
    _same(tb.flip_boxes_horizontal(_t(b), 64.0, **kw), jb.flip_boxes_horizontal(b, 64.0, **kw))
    widths = np.array([64.0, 80.0, 50.0], np.float32)[:, None]
    _same(tb.flip_boxes_horizontal(_t(b), _t(widths), **kw),
          jb.flip_boxes_horizontal(b, widths, **kw))
    _same(tb.resize_boxes(_t(b), (1.5, 0.5)), jb.resize_boxes(b, (1.5, 0.5)))
    scale = rng.uniform(0.5, 2, (3, 1)).astype(np.float32)
    _same(tb.resize_boxes(_t(b), (_t(scale), _t(scale * 2))),
          jb.resize_boxes(b, (jnp.asarray(scale), jnp.asarray(scale * 2))))
    _same(tb.convert_xywh_to_xyxy(_t(b), **kw), jb.convert_xywh_to_xyxy(b, **kw))
    _same(tb.convert_xyxy_to_xywh(_t(b), **kw), jb.convert_xyxy_to_xywh(b, **kw))


def test_boxes_container_pad_and_concat():
    import torch

    from cpm_tpu_torch.structures import boxes as tb

    rng = np.random.RandomState(1)
    b = _boxes(rng, (9,))
    mask = rng.rand(9) > 0.3
    for n in (12, 5):
        got, want = tb.pad_boxes_to(_t(b), n, _t(mask)), jb.pad_boxes_to(b, n, jnp.asarray(mask))
        _same(got[0], want[0])
        _same(got[1], want[1])
    _same(tb.pad_boxes_to(_t(b), 12)[1], jb.pad_boxes_to(b, 12)[1])

    def pair(lib, arr, scores, labels, extra):
        a = lib.Boxes(arr(b[:4]), arr(mask[:4]), {"scores": arr(scores[:4]),
                                                 "labels": arr(labels[:4])})
        c = lib.Boxes(arr(b[4:]), arr(mask[4:]), {"scores": arr(scores[4:]), "x": arr(extra)})
        return a, c

    scores, labels, extra = rng.rand(9).astype(np.float32), np.arange(9), np.zeros(5)
    ta, tc = pair(tb, _t, scores, labels, extra)
    ja, jc = pair(jb, jnp.asarray, scores, labels, extra)
    got, want = tb.concat_boxes(ta, tc), jb.concat_boxes(ja, jc)
    _same(got.boxes, want.boxes)
    _same(got.mask, want.mask)
    assert set(got.fields) == set(want.fields) == {"scores"}
    _same(got.field("scores"), want.field("scores"))
    assert got.num_slots == want.num_slots == 9
    _same(got.num_valid(), want.num_valid())
    assert got.num_valid().dtype == torch.int32
    assert set(ta.with_fields(y=_t(extra)).fields) == {"scores", "labels", "y"}
    assert set(ta.fields) == {"scores", "labels"}
    e, je = tb.Boxes.empty(3, (2,), device="cpu"), jb.Boxes.empty(3, (2,))
    _same(e.boxes, je.boxes)
    _same(e.mask, je.mask)


def test_image_batch():
    from cpm_tpu_torch.structures import image_batch as tib

    rng = np.random.RandomState(2)
    images = [rng.rand(h, w, 3).astype(np.float32) for h, w in ((30, 41), (33, 20))]
    for target in (None, (64, 96)):
        got = tib.pad_to_divisibility(images, 32, target, device="cpu")
        want = jib.pad_to_divisibility(images, 32, target)
        _same(got.images, want.images)
        _same(got.sizes, want.sizes)
        assert got.padded_hw == want.padded_hw
    assert [tib.round_up(x, 32) for x in (1, 32, 33)] == [jib.round_up(x, 32) for x in (1, 32, 33)]


@pytest.mark.parametrize("keys", [{}, {"FPN.HIGHEST_BACKBONE_LVL": 6},
                                  {"FPN.MULTILEVEL_RPN": True, "FPN.MULTILEVEL_ROIS": True,
                                   "FPN.RPN_MAX_LEVEL": 7}])
def test_fpn_spatial_scales(keys):
    from cpm_tpu_torch.config import get_default_cfg
    from cpm_tpu_torch.modeling.fpn import fpn_spatial_scales

    jcfg, tcfg = jax_default_cfg(), get_default_cfg()
    for cfg in (jcfg, tcfg):
        for key, value in keys.items():
            section, leaf = key.split(".")
            cfg[section][leaf] = value
    trunk = (0.25, 0.125, 0.0625, 0.03125)
    assert fpn_spatial_scales(tcfg, trunk) == jax_fpn_scales(jcfg, trunk)


def test_evaluate_box_proposals():
    from cpm_tpu_torch.evaluation import proposal_eval as tpe

    rng = np.random.RandomState(3)
    recs = []
    for n_gt in (5, 0, 8):
        gt = _boxes(rng, (n_gt,)) * np.array([4, 4, 4, 4], np.float32)
        gt[..., 2:] = np.maximum(gt[..., 2:], gt[..., :2] + 1)
        near = np.repeat(gt, 30, axis=0) + rng.normal(0, 6, (30 * n_gt, 4)).astype(np.float32)
        boxes = np.concatenate([near, _boxes(rng, (40,)) * 4])
        recs.append(dict(boxes=boxes, scores=rng.rand(len(boxes)), gt_boxes=gt))
    assert set(tpe.AREA_RANGES) == set(jpe.AREA_RANGES)
    for area in tpe.AREA_RANGES:
        for limit in (20, 1000):
            got = tpe.evaluate_box_proposals(recs, area, limit)
            want = jpe.evaluate_box_proposals(recs, area, limit)
            assert got["ar"] == want["ar"] and got["num_pos"] == want["num_pos"]
            np.testing.assert_array_equal(got["recalls"], want["recalls"])
    assert 0 < tpe.evaluate_box_proposals(recs)["ar"] < 1


def test_params_against_jax(tmp_path_factory):
    """The tiny model's count and breakdown equal the JAX package's; the
    full-width flagship, built on the meta device, has the pinned JAX count."""
    import torch

    from cpm_tpu_torch.config import flagship_cfg, get_default_cfg
    from cpm_tpu_torch.config import merge_cfg_from_file as port_merge
    from cpm_tpu_torch.modeling.model import GeneralizedRCNN
    from cpm_tpu_torch.utils import measure

    params = jax_tiny_tpu_params(tmp_path_factory)
    cfg = get_default_cfg()
    port_merge(TINY_CPM, cfg)
    with torch.device("meta"):
        tiny = GeneralizedRCNN(cfg)
        flagship = GeneralizedRCNN(flagship_cfg())
    assert measure.count_params(tiny) == jm.count_params(params)
    assert measure.param_breakdown(tiny) == jm.param_breakdown(params)
    assert measure.count_params(flagship) == measure.FLAGSHIP_JAX_PARAMS


def test_flops_of_a_conv_and_a_dense_equal_xla_s():
    import torch
    import torch.nn.functional as F

    from cpm_tpu_torch.utils.measure import flops_of

    rng = np.random.RandomState(4)
    x, w = rng.randn(2, 9, 11, 6).astype(np.float32), rng.randn(3, 3, 6, 8).astype(np.float32)
    xt, wt = torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w).permute(3, 2, 0, 1)
    for pad in (0, 1):
        want = jm.flops_of(lambda a, k: jax.lax.conv_general_dilated(
            a, k, (2, 1), [(pad, pad)] * 2, dimension_numbers=("NHWC", "HWIO", "NHWC")), x, w)
        got = flops_of(lambda a, k: F.conv2d(a, k, stride=(2, 1), padding=pad), xt, wt)
        # XLA leaves out the taps that fall on the padding; torch counts them
        assert got == want > 0 if pad == 0 else got > want > 0
    a, k = rng.randn(5, 7).astype(np.float32), rng.randn(7, 3).astype(np.float32)
    assert flops_of(torch.matmul, torch.tensor(a), torch.tensor(k)) == jm.flops_of(jnp.dot, a, k)


def test_flops_of_the_tiny_model(tmp_path_factory):
    """The port's eval forward FLOPs (products and convolutions) over XLA's
    cost analysis of the JAX eval forward (every op), both in f32 on the
    same batch. The JAX side compiles at backend optimisation level 0."""
    from cpm_tpu_torch.config import get_default_cfg
    from cpm_tpu_torch.config import merge_cfg_from_file as port_merge
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.measure import flops_and_params

    images = np.random.RandomState(5).randint(0, 256, (1, 64, 96, 3)).astype(np.uint8)
    sizes = np.array([[60, 90]], np.int32)
    params = jax_tiny_tpu_params(tmp_path_factory)
    jcfg = merge_cfg_from_file(TINY_CPM, jax_default_cfg())
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel = jax_build_model(jcfg)
    lowered = jax.jit(lambda p, im, sz: jmodel.apply({"params": p}, im, sz, train=False)).lower(
        params, images, sizes)
    cost = lowered.compile(compiler_options=FAST_COMPILE).cost_analysis()
    want = float((cost[0] if isinstance(cost, list) else cost)["flops"])

    cfg = get_default_cfg()
    port_merge(TINY_CPM, cfg)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    stats = flops_and_params(cfg, build_model(cfg, "cpu"), images, sizes)
    assert stats["input_hw"] == [64, 96] and stats["params"] == jm.count_params(params)
    ratio = stats["eval_forward_flops"] / want
    assert 0.95 <= ratio <= 1.05, (stats["eval_forward_flops"], want)


def test_compute_flops_cli(capsys):
    import json

    from cpm_tpu_torch.tools import compute_flops

    stats = compute_flops.main(["--cfg", TINY_CPM, "--height", "64", "--width", "64",
                                "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == stats
    assert set(stats) == {"input_hw", "params", "params_by_module", "eval_forward_flops"}
    assert stats["eval_forward_flops"] > 0


def test_testing_logger(monkeypatch, capsys):
    """The same tics and tocs on the same clock print the same lines."""
    import cpm_tpu.utils.logger as jlog

    import cpm_tpu_torch.utils.logger as tlog

    lines = []
    for mod in (jlog, tlog):
        clock = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.75, 3.0, 3.125])
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        log = mod.TestingLogger("tiny", log_period=2)
        log.log(0, 10)
        for stage in ("infer", "post", "infer", "post"):
            log.tic(stage)
            log.toc(stage)
        log.toc("never")
        log.log(2, 10)
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] and "eta" in lines[1]
