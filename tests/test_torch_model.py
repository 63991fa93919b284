"""The whole eval slice: the JAX package's CPM model against the port.

The JAX tiny flagship config (`__graft_entry__._flagship_cfg(tiny=True)`) in
f32 is initialised in JAX, its params go through the bridge, and both test
forwards run on the same uint8 images. Detections are compared as masked
sets: labels and mask exactly, boxes to 1e-2 px, scores to 1e-5.

torch and the port's model are imported inside the tests, so that collecting
this file loads no torch into a test worker (see tests/test_torch_roi_align.py).
"""

import sys
import types

import jax
import numpy as np
import pytest

from __graft_entry__ import _flagship_cfg
from cpm_tpu.engine.test import detections_to_coco as jax_detections_to_coco
from cpm_tpu.modeling.model import build_model as jax_build_model
from cpm_tpu_torch.config import flagship_cfg


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


def _tiny_cfg():
    cfg = _flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


@pytest.fixture(scope="module")
def slice_outputs():
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    # a padded 64x64 batch holding a 64x64 and a 56x48 image
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.array([[64, 64], [56, 48]], np.int32)
    cfg = _tiny_cfg()
    jm = jax_build_model(cfg)

    @jax.jit
    def run(images, sizes):
        params = jm.init({"params": jax.random.PRNGKey(0)}, images, sizes, train=False)["params"]
        return params, jm.apply({"params": params}, images, sizes, train=False)

    params, want = run(images, sizes)
    params = jax.device_get(params)
    model = load_flax_params(build_model(cfg, "cpu"), params)
    got = make_forward_fn(cfg, model)(images, sizes)
    return cfg, params, sizes, jax.device_get(want), got


def _rows(boxes, scores, labels, mask):
    return np.concatenate(
        [labels[mask][:, None].astype(np.float64), boxes[mask], scores[mask][:, None]], 1
    )


def assert_same_detection_sets(got, want, box_atol=1e-2, score_atol=1e-5):
    """Rows (label, x1, y1, x2, y2, score) match one to one: each wanted
    row pairs with an unused row of the same label within the tolerances."""
    assert len(got) == len(want) > 0
    unused = list(range(len(got)))
    for w in want:
        for j in unused:
            g = got[j]
            if (g[0] == w[0] and np.abs(g[1:5] - w[1:5]).max() <= box_atol
                    and abs(g[5] - w[5]) <= score_atol):
                unused.remove(j)
                break
        else:
            raise AssertionError(f"no detection matches {w}; unmatched: {got[unused]}")


def test_whole_slice_matches_jax(slice_outputs):
    import torch

    cfg, _, sizes, want, got = slice_outputs
    for f in ("boxes", "scores", "labels", "mask"):
        assert tuple(getattr(got, f).shape) == tuple(np.asarray(getattr(want, f)).shape)
    assert got.boxes.dtype == torch.float32 and got.mask.dtype == torch.bool
    for i in range(sizes.shape[0]):
        w = _rows(*(np.asarray(getattr(want, f)[i]) for f in ("boxes", "scores", "labels", "mask")))
        g = _rows(*(getattr(got, f)[i].numpy() for f in ("boxes", "scores", "labels", "mask")))
        assert_same_detection_sets(g, w)


def test_bridge_round_trip_consumes_every_leaf(slice_outputs):
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.param_bridge import flax_to_state_dict

    cfg, params, *_ = slice_outputs
    model = build_model(cfg, "cpu")
    sd = flax_to_state_dict(params, model)
    assert set(sd) == set(model.state_dict())
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(sd)
    np.testing.assert_array_equal(
        sd["backbone.conv1.weight"].numpy(),
        np.asarray(params["backbone"]["conv1"]["kernel"]).transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        sd["roi_head.cls_head.fc6.weight"].numpy(),
        np.asarray(params["roi_head"]["cls_head"]["fc6"]["kernel"]).T,
    )

    extra = jax.tree_util.tree_map(lambda x: x, params)
    extra["roi_head"]["cls_head"]["fc8"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        flax_to_state_dict(extra, model)
    missing = jax.tree_util.tree_map(lambda x: x, params)
    del missing["fpn"]["p5_out"]
    with pytest.raises(KeyError):
        flax_to_state_dict(missing, model)
    wrong = jax.tree_util.tree_map(lambda x: x, params)
    wrong["rpn_head"]["conv"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        flax_to_state_dict(wrong, model)


def test_detections_to_coco_matches_jax(slice_outputs):
    from cpm_tpu_torch.engine.test import detections_to_coco

    _, _, sizes, want, got = slice_outputs
    cat_map = {i: 100 + i for i in range(1, 7)}  # labels 7 and 8 are dropped
    for i in range(sizes.shape[0]):
        dets = {f: getattr(got, f)[i].numpy() for f in ("boxes", "scores", "labels", "mask")}
        w = jax_detections_to_coco(dets, 7, (0.5, 0.8), cat_map)
        g = detections_to_coco(dets, 7, (0.5, 0.8), cat_map)
        assert g == w


def test_bf16_forward_runs_on_cpu():
    import torch

    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model

    cfg = _flagship_cfg(tiny=True)  # TPU.COMPUTE_DTYPE stays bfloat16
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    dets = make_forward_fn(cfg, build_model(cfg, "cpu", seed=3))(images, np.array([[64, 60]]))
    max_dets = cfg.GRID_RCNN.TEST_MAX_DETECTIONS
    assert tuple(dets.boxes.shape) == (1, max_dets, 4)
    assert dets.boxes.dtype == torch.float32 and dets.scores.dtype == torch.float32
    assert torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all()
    m = dets.mask[0]
    assert m.any()
    assert ((dets.labels[0][m] >= 1) & (dets.labels[0][m] < cfg.MODEL.NUM_CLASSES)).all()


@pytest.mark.parametrize("tiny", [False, True])
def test_flagship_cfg_matches_graft_entry(tiny):
    assert flagship_cfg(tiny) == _flagship_cfg(tiny)


POOLER_KERNELS = ("auto", "pallas", "stacked", "clustered", "gather")


def test_build_model_pooler_kernel_values():
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.ops import pooler as pooler_mod

    cfg = _tiny_cfg()
    try:
        # build_model hands TPU.POOLER_KERNEL to the pooler, as the JAX build_model does
        for name in POOLER_KERNELS:
            cfg.TPU.POOLER_KERNEL = name
            build_model(cfg, "cpu")
            assert pooler_mod.get_pooler_backend() == name
        cfg.TPU.POOLER_KERNEL = "windowed"
        with pytest.raises(ValueError):
            build_model(cfg, "cpu")
        assert pooler_mod.get_pooler_backend() == POOLER_KERNELS[-1]
    finally:
        pooler_mod.set_pooler_backend("auto")


@pytest.mark.parametrize("name", POOLER_KERNELS)
def test_whole_slice_under_each_pooler_kernel(slice_outputs, name, monkeypatch):
    """The eval slice under every TPU.POOLER_KERNEL value: on the CPU each
    runs the plain version of its own formulation (stacked buffer, grouped
    tiles, gather), and all give the JAX package's detections and the
    `auto` path's."""
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.ops import pooler as pooler_mod
    from cpm_tpu_torch.ops import roi_align as plain
    from cpm_tpu_torch.utils.param_bridge import load_flax_params

    _, params, sizes, want, auto = slice_outputs
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    calls = {"stacked": 0, "clustered": 0}
    for key, fn in (("stacked", "roi_align_from_stack"), ("clustered", "cluster_rois")):
        real = getattr(plain, fn)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(plain, fn, counted)
    cfg = _tiny_cfg()
    cfg.TPU.POOLER_KERNEL = name
    try:
        model = load_flax_params(build_model(cfg, "cpu"), params)
        got = make_forward_fn(cfg, model)(images, sizes)
    finally:
        pooler_mod.set_pooler_backend("auto")
    # cls, three grid stages and rescore pool through the named formulation
    assert calls == {"stacked": 5 * (name == "stacked"), "clustered": 5 * (name == "clustered")}
    fields = ("boxes", "scores", "labels", "mask")
    for i in range(sizes.shape[0]):
        g = _rows(*(getattr(got, f)[i].numpy() for f in fields))
        assert_same_detection_sets(g, _rows(*(np.asarray(getattr(want, f)[i]) for f in fields)))
        assert_same_detection_sets(g, _rows(*(getattr(auto, f)[i].numpy() for f in fields)))


def test_same_seed_same_weights():
    import torch

    from cpm_tpu_torch.modeling.model import build_model

    cfg = _tiny_cfg()
    a = build_model(cfg, "cpu", seed=5).state_dict()
    b = build_model(cfg, "cpu", seed=5).state_dict()
    c = build_model(cfg, "cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.conv1.weight"], c["backbone.conv1.weight"])
