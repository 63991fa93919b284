"""Whole harness runs of a tiny evaluation cell on the CPU (the `evaluate`
mode: the port's `run_inference_on_dataset` with TTA passes and a soft-NMS
merge): a sound run is correct, a traced run reports the new mode's
metrics that the CPU can read, and `correct` comes out false under each of
the mode's faults and under the control."""

import json
import math

import pytest

from benchmark import calibrate, evaluate
from benchmark.check import judge
from benchmark.run import run_cell
from conftest import LIMITS, MIX, REPO, TINY_CONFIG, _dump, load_tiny

SEED = 2 ** 31 + 11
CELL = "tiny_tta.eval"
# the tiny ResNeXt-DCN under the flip and two more scales (six passes) and
# soft-NMS; FAST_RCNN.NMS 0.2, since at this size no two candidates of one
# label overlap by the YAML's 0.5, where soft-NMS and hard NMS keep the
# same set
TINY_TTA = dict(TINY_CONFIG, name="tiny_tta", builder="x101_dcn_cfg")
TINY_TTA["set"] = dict(TINY_CONFIG["set"], **{
    "FAST_RCNN.SCORE_THRESH": 0.0, "FAST_RCNN.NMS": 0.2, "TEST.BBOX_AUG.ENABLED": True,
    "TEST.BBOX_AUG.H_FLIP": True, "TEST.BBOX_AUG.SCALES": [48, 80], "TEST.BBOX_AUG.MAX_SIZE": 120,
    "TEST.SOFT_NMS.ENABLED": True})
# the port in float32 on the PIL decode path computes what the reference
# does, to round-off; the merge of the same per-pass sets bit for bit
NUMBERS = {k: v for k, v in LIMITS["tiny.serve"].items() if k not in ("select_miss", "box_p25")}
NUMBERS.update(box_p10={"limit": 1e-4}, merge_gap={"limit": 0.0}, soft_nms_gap={"limit": 0.0},
               sampler_stage={"limit": 1e-5})
# the number each fault must send over its limit
CAUGHT = {"pass_dropped": ("merge_gap", "soft_nms_gap"), "flip_undone": ("merge_gap",),
          "hard_nms": ("merge_gap", "soft_nms_gap")}
NEW_METRICS = {"tta_merge_ms.eval", "tta_load_ms.eval", "dcn_sampler_roofline.eval"}


@pytest.fixture
def eval_root(tmp_path):
    """A directory holding BENCHMARK.json and the tiny evaluation cell's
    configuration, mix and limits."""
    root = tmp_path / "bench"
    _dump(root / "benchmark" / "configs" / "tiny_tta.json", TINY_TTA)
    _dump(root / "benchmark" / "traffic" / "tiny_eval.json",
          {"mode": "evaluate", "images": 6, "slice_images": 4, "check_images": 2, **MIX})
    _dump(root / "benchmark" / "limits" / f"{CELL}.json",
          {"numbers": NUMBERS})
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny_tta", "source": "test", "why": "test", "reduced": [],
                         "file": "benchmark/configs/tiny_tta.json"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny_tta", "traffic": "tiny_eval", "chips": 1,
                           "why": "t"}]
    real = "cpm_x101_64x4d_dcn_ms.eval_b1"
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if real in m["workloads"] else []
    _dump(root / "BENCHMARK.json", bench)
    return root


def _run(root, trace=False, hooks=None):
    return run_cell(load_tiny(root, CELL), SEED, 1.0, trace, device="cpu",
                    roots=[root / "benchmark"], hooks=hooks, t_start=0.0)


def test_a_sound_evaluation_run_is_correct(eval_root, pil_decode):
    res = _run(eval_root)
    assert res["correct"], res["checks"]
    assert res["checks"]["merge_gap"]["value"] == 0.0
    assert set(res["checks"]) == set(NUMBERS)
    # a whole first slice at least
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_img_s", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in res["metrics"].values())


def test_a_traced_evaluation_run_reports_what_the_cpu_can_read(eval_root, pil_decode):
    res = _run(eval_root, trace=True)
    assert res["correct"], res["checks"]
    # no device on the CPU: the device's readers, the sampler's roofline
    # among them, say nothing
    assert set(res["metrics"]) == {"tta_merge_ms.eval", "tta_load_ms.eval", "mfu.serve"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_the_new_metrics_say_nothing_in_a_run_of_another_mode(tiny_root, pil_decode):
    cell = load_tiny(tiny_root, "tiny.serve")
    assert NEW_METRICS <= {m["name"] for m in cell.per_layer}
    res = run_cell(cell, SEED, 0.5, True, device="cpu", roots=[tiny_root / "benchmark"],
                   t_start=0.0)
    assert not NEW_METRICS & set(res["metrics"]), res["metrics"]


@pytest.mark.parametrize("fault", sorted(evaluate.FAULTS))
def test_each_fault_of_the_evaluation_is_not_correct(eval_root, pil_decode, fault):
    res = _run(eval_root, hooks=evaluate.FAULTS[fault])
    assert not res["correct"], res["checks"]
    for name in CAUGHT[fault]:
        assert res["checks"][name]["value"] > NUMBERS[name]["limit"], (name, res["checks"])


def test_the_evaluation_control_is_not_correct(eval_root):
    cell = load_tiny(eval_root, CELL)
    numbers = calibrate.readings(cell, SEED, "cpu", ["control"])["control"]
    assert not all(r["ok"] for r in judge(numbers, cell.limits)), numbers
