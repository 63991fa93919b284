"""The yardstick's arithmetic on hand-worked shapes."""

import math

import pytest
import torch

from benchmark import bounds


def test_bound_is_the_slower_of_bytes_and_operations():
    assert bounds.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert bounds.bound_s(0, 67e12) == pytest.approx(1.0)
    assert bounds.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_roi_align_bounds_one_roi():
    # one roi (0, 0)-(4, 4) on an 8x8 map at scale 1, 2x2 bins of 2x2
    # samples at 0.5, 1.5, 2.5, 3.5 on each axis: cells 0..4, 25 touched
    shapes = [(1, 8, 8, 2)]
    rois = torch.tensor([[0.0, 0.0, 0.0, 4.0, 4.0]])
    levels = torch.zeros(1, dtype=torch.int32)
    valid = torch.ones(1, dtype=torch.bool)
    assert bounds.touched_cells(shapes, rois, levels, valid, (2, 2), (1.0,)) == 25
    fwd, bwd, fb, bb, flops = bounds.roi_align_bounds(shapes, rois, levels, valid, (2, 2), 4, (1.0,))
    assert fb == 25 * 2 * 4 + 25 + 4 * 2 * 4
    assert bb == 4 * 2 * 4 + 25 + 64 * 2 * 4
    assert flops == 4 * 4 * 4 * 2 * 2
    assert fwd == pytest.approx(max(fb / 3.35e12, flops / 67e12))
    assert bwd == pytest.approx(max(bb / 3.35e12, flops / 67e12))
    # a masked roi reads nothing and writes its zero row
    none = torch.zeros(1, dtype=torch.bool)
    assert bounds.touched_cells(shapes, rois, levels, none, (2, 2), (1.0,)) == 0


def test_sampler_bounds_two_samples():
    # (1.5, 1.5) weighs four cells, (1, 1) one of them alone
    ys = torch.tensor([[1.5, 1.0]])
    xs = torch.tensor([[1.5, 1.0]])
    fwd, bwd, fb, bb, flops = bounds.sampler_bounds((1, 4, 4, 3), 4, ys, xs)
    assert fb == 4 * 3 * 4 + 2 * 8 + 2 * 3 * 4
    assert bb == 2 * 3 * 4 + 4 * 3 * 4 + 2 * 8 + 16 * 3 * 4 + 2 * 8
    assert flops == 5 * 3 * 2
    assert fwd == pytest.approx(fb / 3.35e12) and bwd == pytest.approx(bb / 3.35e12)


def test_mfu_and_roofline_readers_say_nothing_without_a_trace():
    from benchmark.registry import metric_reader
    from benchmark.trace import TraceSummary

    class Ctx:
        host, bounds, trace = {}, {}, None
        flops_per_image = 0.0
        traced_units = captured_units = 0
        traced_window_s = 0.0

    for name in ("mfu.serve", "roi_align_roofline.serve", "idle.serve", "load_ms.serve",
                 "dcn_sampler_roofline.train", "fwd_span_ms.train"):
        assert metric_reader(name).read(Ctx()) is None
    ctx = Ctx()
    ctx.trace = TraceSummary(window_s=2.0, busy_s=0.5, kernels={"roi_align_fwd_kernel<x>": (0.01, 10)})
    ctx.bounds = {"roi_calls": 10, "roi_fwd_s": 0.001}
    ctx.traced_units, ctx.captured_units = 4, 2
    assert metric_reader("idle.serve").read(ctx) == pytest.approx(75.0)
    # 0.0005 s of bound a request against 0.0025 s of kernel time a request
    assert metric_reader("roi_align_roofline.serve").read(ctx) == pytest.approx(20.0)
    ctx.flops_per_image, ctx.traced_window_s = 989e12, 4.0
    assert metric_reader("mfu.serve").read(ctx) == pytest.approx(100.0)
    assert math.isfinite(metric_reader("mfu.serve").read(ctx))
