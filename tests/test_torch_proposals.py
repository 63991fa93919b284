"""Proposal selection as one batched pass (`modeling/rpn.py::select_proposals`
on the CPU path: every level's candidates in one padded batch, one NMS over
its rows) against the per-level loop it replaced
(`tools/probe_nms.py::per_level_select`), bit for bit, on awkward inputs.
tests/test_torch_cuda_kernels.py holds the CUDA path to the same loop on a
card.

torch and the port are imported inside the tests, so that collecting this
file loads no torch into a test worker.
"""

import sys
import types

import numpy as np
import pytest

from tests.torch_support import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _drop_stub_modules_that_answer_every_name():
    """tests/test_weight_parity.py leaves stub modules in `sys.modules` whose
    `__getattr__` answers every name, `__file__` included; torch's first
    backward of a process fails on such a `__file__`. They go before this
    file's first torch call."""
    for name, mod in list(sys.modules.items()):
        if isinstance(mod, types.ModuleType) and callable(getattr(mod, "__file__", None)):
            del sys.modules[name]


FPN = dict(strides=(4, 8, 16, 32, 64), sizes=(32, 64, 128, 256, 512))
# name -> (layout, batch, image sizes, select_proposals' keywords, how the
# objectness logits are drawn)
CASES = {
    # P6 holds 6 anchors and P5 18, under pre_nms_top_n
    "levels under pre_nms_top_n": (dict(shapes=[(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)], **FPN),
                                   2, [[32, 48], [28, 41]], dict(pre=40, post=20, fpn=30), "normal"),
    # the second image is one pixel: every clipped box is 1 px wide, under min_size 2
    "an image with no valid box": (dict(shapes=[(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)], **FPN),
                                   2, [[32, 48], [1, 1]],
                                   dict(pre=30, post=20, fpn=40, min_size=2), "normal"),
    # logits from four values, and 30 where sigmoid rounds to 1: ties everywhere
    "score ties": (dict(shapes=[(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)], **FPN),
                   2, [[32, 48], [30, 44]], dict(pre=50, post=25, fpn=60), "ties"),
    # the C4 layout: one level of 15 anchors a cell
    "one level": (dict(shapes=[(6, 9)], strides=(16,), sizes=(32, 64, 128, 256, 512)),
                  2, [[96, 144], [80, 120]], dict(pre=100, post=40, fpn=50), "normal"),
    "training": (dict(shapes=[(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)], **FPN),
                 2, [[32, 48], [28, 41]], dict(pre=40, post=20, fpn=30, train=True), "ties"),
}


def _case(name, device="cpu", dtype_name="float32", seed=0):
    import torch

    from cpm_tpu_torch.modeling.rpn import AnchorLayout

    spec, b, sizes, opts, draw = CASES[name]
    layout = AnchorLayout(spec["shapes"], spec["strides"], spec["sizes"], (0.5, 1.0, 2.0))
    a = len(spec["sizes"]) * 3 if len(spec["strides"]) == 1 else 3
    rng = np.random.RandomState(seed)
    dtype = getattr(torch, dtype_name)
    obj, reg = [], []
    for h, w in spec["shapes"]:
        if draw == "ties":
            logits = rng.choice([-1.0, 0.0, 1.0, 30.0], (b, h, w, a))
        else:
            logits = rng.randn(b, h, w, a)
        obj.append(torch.tensor(logits, dtype=dtype, device=device))
        reg.append(torch.tensor(0.4 * rng.randn(b, h, w, 4 * a), dtype=dtype, device=device))
    kw = dict(pre_nms_top_n=opts["pre"], post_nms_top_n=opts["post"], nms_thresh=0.7,
              min_size=opts.get("min_size", 0), fpn_post_nms_top_n=opts["fpn"])
    if opts.get("train"):
        kw.update(is_train=True, gt_boxes=torch.tensor(rng.rand(b, 3, 4) * 20, device=device,
                                                       dtype=torch.float32).sort(-1).values,
                  gt_mask=torch.tensor([[True, True, False]] * b, device=device))
    return layout, obj, reg, torch.tensor(sizes, dtype=torch.int32, device=device), kw


def _assert_same_bits(got, want):
    import torch

    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_padded_batch_equals_the_per_level_loop(name):
    from cpm_tpu_torch.modeling.rpn import select_proposals
    from cpm_tpu_torch.tools.probe_nms import per_level_select

    layout, obj, reg, sizes, kw = _case(name)
    got = select_proposals(layout, obj, reg, sizes, **kw)
    _assert_same_bits(got, per_level_select(layout, obj, reg, sizes, **kw))
    if name == "an image with no valid box":
        assert got[2][0].any() and not got[2][1].any()


def test_level_candidates_pad_each_level_past_its_k():
    from cpm_tpu_torch.modeling.rpn import level_candidates
    from cpm_tpu_torch.ops.box_coder import BoxCoder

    layout, obj, reg, sizes, kw = _case("levels under pre_nms_top_n")
    boxes, scores, valid = level_candidates(layout, obj, reg, sizes, 40, 0, BoxCoder((1, 1, 1, 1)))
    assert boxes.shape == (2, 5, 40, 4) and scores.shape == valid.shape == (2, 5, 40)
    for level, n in enumerate(layout.level_sizes):
        k = min(40, n)
        assert valid[:, level, :k].all() and not valid[:, level, k:].any()
        assert not boxes[:, level, k:].any() and not scores[:, level, k:].any()
        # descending scores within the level's top-k
        assert (scores[:, level, 1:k] <= scores[:, level, :k - 1]).all()
