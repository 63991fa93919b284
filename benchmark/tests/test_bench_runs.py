"""Whole harness runs of the tiny cells on the CPU: a sound run is correct,
and `correct` comes out false under each fault the cells can have and under
the control (reference/precision.py, put in the port's place)."""

import math

import pytest

from benchmark import calibrate, faults
from benchmark.run import run_cell
from conftest import load_tiny

SEED = 2 ** 31 + 11


def _run(root, name, trace=False, hooks=None):
    return run_cell(load_tiny(root, name), SEED, 1.5, trace, device="cpu",
                    roots=[root / "benchmark"], hooks=hooks, t_start=0.0)


@pytest.mark.parametrize("name", ["tiny.serve", "tiny.train"])
def test_a_sound_run_is_correct(tiny_root, pil_decode, name):
    res = _run(tiny_root, name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0 and res["failed"] == 0
    e2e = {"tiny.serve": {"serve_img_s", "serve_p95_ms", "setup_s"},
           "tiny.train": {"train_img_s", "setup_s"}}[name]
    assert set(res["metrics"]) == e2e
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("name,host_metrics", [
    ("tiny.serve", {"load_ms.serve", "forward_ms.serve", "mfu.serve"}),
    ("tiny.train", {"loader_wait_ms.train", "fwd_span_ms.train", "bwd_span_ms.train", "mfu.train"}),
])
def test_a_traced_run_reports_what_the_cpu_can_read(tiny_root, pil_decode, name, host_metrics):
    res = _run(tiny_root, name, trace=True)
    assert res["correct"]
    # no device on the CPU: the device's readers say nothing, never 0
    assert set(res["metrics"]) == host_metrics
    assert "busy_s" not in res["device"] or res["device"]["busy_s"] == 0.0


@pytest.mark.parametrize("name,fault,caught", [
    ("tiny.serve", {"forward": faults.altered_answer}, "score_gap"),
    ("tiny.serve", {"forward": faults.shifted_boxes}, "box_p25"),
    ("tiny.serve", {"forward": faults.cut_count}, "count_gap"),
    ("tiny.train", {"step": faults.unchanged_state}, "delta_gap"),
    ("tiny.train", {"step": faults.half_batch}, "loss_gap"),
], ids=["answer_altered", "boxes_shifted", "count_cut", "state_unchanged", "half_batch"])
def test_a_fault_under_the_timed_path_is_not_correct(tiny_root, pil_decode, name, fault, caught):
    res = _run(tiny_root, name, hooks=fault)
    assert not res["correct"], res["checks"]
    assert res["checks"][caught]["value"] > res["checks"][caught]["limit"], res["checks"]


def test_the_sampler_check_catches_a_coordinate_gradient_fault(tiny_root, pil_decode,
                                                               monkeypatch):
    from cpm_tpu_torch.ops import deform_conv

    res = _run(tiny_root, "tiny_dcn.train")
    assert res["correct"] and res["checks"]["sampler_stage"]["value"] == 0.0, res["checks"]
    monkeypatch.setattr(deform_conv, "deform_sample",
                        faults.coordinate_gradient(deform_conv.deform_sample))
    res = _run(tiny_root, "tiny_dcn.train")
    assert not res["correct"] and res["checks"]["sampler_stage"]["value"] > 0.3, res["checks"]


def test_a_request_that_serves_nothing_reads_infinite(tiny_root, pil_decode):
    def serve_nothing(forward):
        return lambda images, sizes: (lambda d: d._replace(mask=d.mask & False))(
            forward(images, sizes))

    res = _run(tiny_root, "tiny.serve", hooks={"forward": serve_nothing})
    assert not res["correct"]
    assert all(math.isinf(res["checks"][k]["value"]) for k in ("score_gap", "box_p25", "count_gap"))


@pytest.mark.parametrize("name", ["tiny.serve", "tiny.train", "tiny_dcn.train"])
def test_the_control_is_not_correct(tiny_root, name):
    from benchmark.check import judge

    cell = load_tiny(tiny_root, name)
    numbers = calibrate.readings(cell, SEED, "cpu", ["control"])["control"]
    assert not all(r["ok"] for r in judge(numbers, cell.limits)), numbers
