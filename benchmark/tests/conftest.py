"""Fixtures of the benchmark's CPU tests: a tiny cell of each mode, made in a
directory of the test's own from new files alone (a configuration, two
traffic mixes, their limits and a BENCHMARK.json naming them), so that the
harness finds each piece by name without an edit to the repository's."""

import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny_cpm", "source": "test", "builder": "flagship_cfg", "builder_args": {"tiny": True},
    "replay": "grid_cascade",
    "set": {"GRID_RCNN.SCORE_THRESH": 0.0, "TEST.SCALE": 64, "TEST.MAX_SIZE": 96,
            "TRAIN.SCALES": [64], "TRAIN.MAX_SIZE": 96, "TRAIN.MAX_GT_BOXES": 8,
            "TPU.COMPUTE_DTYPE": "float32"},
    "lr_batch": 16, "reduced": [],
}
# the same, at ResNeXt with deformable convs: the sampler's stage check
TINY_DCN = dict(TINY_CONFIG, name="tiny_dcn", builder="x101_dcn_cfg")
MIX = {"aspects": [[80, 60, 0.6], [60, 80, 0.2], [80, 45, 0.1], [80, 80, 0.1]],
       "instances": {"mean": 3, "min": 1, "max": 6},
       "area_split": {"small": 0.5, "medium": 0.5, "large": 0.0}, "classes": 8, "jpeg_quality": 90}
# the tiny cells' limits: the port in float32 on the PIL decode path
# (`pil_decode`) computes what the reference does, to round-off
LIMITS = {
    "tiny.serve": {"score_gap": {"limit": 1e-4}, "select_miss": {"limit": 0.0},
                   "box_p25": {"limit": 1e-4}, "count_gap": {"limit": 0.0},
                   "proposal_stage": {"limit": 1e-3}, "decode_stage": {"limit": 1e-3}},
    "tiny.train": {"loss_gap": {"limit": 1e-4}, "grad_gap": {"limit": 1e-3},
                   "delta_gap": {"limit": 1e-3}, "proposal_stage": {"limit": 1e-3},
                   "decode_stage": {"limit": 1e-3}},
    "tiny_dcn.train": {"loss_gap": {"limit": 1e-4}, "delta_med": {"limit": 1e-3},
                       "proposal_stage": {"limit": 1e-3}, "decode_stage": {"limit": 1e-3},
                       "sampler_stage": {"limit": 1e-5}},
}


def _dump(path: Path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


@pytest.fixture
def tiny_root(tmp_path):
    """A directory holding BENCHMARK.json and benchmark/{configs, traffic,
    limits} for three tiny cells: `tiny.serve`, `tiny.train` and
    `tiny_dcn.train`."""
    root = tmp_path / "bench"
    _dump(root / "benchmark" / "configs" / "tiny_cpm.json", TINY_CONFIG)
    _dump(root / "benchmark" / "configs" / "tiny_dcn.json", TINY_DCN)
    _dump(root / "benchmark" / "traffic" / "tiny_serve.json",
          {"mode": "serve", "images": 6, "check_requests": 3, **MIX})
    _dump(root / "benchmark" / "traffic" / "tiny_train.json",
          {"mode": "train", "images": 8, "images_per_card": 2, **MIX})
    for cell, numbers in LIMITS.items():
        _dump(root / "benchmark" / "limits" / f"{cell}.json", {"numbers": numbers})
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": c, "source": "test", "why": "test", "reduced": [],
                         "file": f"benchmark/configs/{c}.json"} for c in ("tiny_cpm", "tiny_dcn")]
    bench["workloads"] = [
        {"name": "tiny.serve", "config": "tiny_cpm", "traffic": "tiny_serve", "chips": 1, "why": "t"},
        {"name": "tiny.train", "config": "tiny_cpm", "traffic": "tiny_train", "chips": 1, "why": "t"},
        {"name": "tiny_dcn.train", "config": "tiny_dcn", "traffic": "tiny_train", "chips": 1,
         "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tiny.serve"] if m["moves" if "moves" in m else "name"].startswith("serve")
                              else ["tiny.train", "tiny_dcn.train"])
    _dump(root / "BENCHMARK.json", bench)
    return root


@pytest.fixture
def pil_decode(monkeypatch):
    """The port's loaders on their PIL path, the reference's decode."""
    import cpm_tpu_torch.data.loader as loader

    monkeypatch.setattr(loader, "_native", lambda: None)


def load_tiny(root: Path, name: str):
    from benchmark.registry import load_cell

    return load_cell(name, root / "BENCHMARK.json", roots=[root / "benchmark"])
