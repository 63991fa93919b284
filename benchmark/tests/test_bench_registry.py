"""The harness finds a cell's pieces by name, so a later change adds a
configuration, a traffic mix, a per-layer metric or a cell as new files and
entries alone; and BENCHMARK.json agrees with the files it names."""

import json
import re

import pytest

from benchmark.registry import HERE, REPO, load_cell, metric_reader
from benchmark.run import run_cell
from conftest import load_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_new_files_are_found_by_name(tiny_root):
    cell = load_tiny(tiny_root, "tiny.train")
    assert cell.config["name"] == "tiny_cpm" and cell.mode == "train"
    assert set(cell.limits) == {"loss_gap", "grad_gap", "delta_gap", "proposal_stage", "decode_stage"}
    with pytest.raises(FileNotFoundError):
        metric_reader("no_such_metric.train", [tiny_root / "benchmark"])


def test_a_new_head_replay_is_found_by_the_configurations_name(tiny_root):
    replays = tiny_root / "benchmark" / "replays"
    replays.mkdir()
    (replays / "copied_head.py").write_text((HERE / "replays" / "grid_cascade.py").read_text())
    config = tiny_root / "benchmark" / "configs" / "tiny_cpm.json"
    config.write_text(json.dumps(dict(json.loads(config.read_text()), replay="copied_head")))
    cell = load_tiny(tiny_root, "tiny.serve")
    head = cell.head_replay()
    assert head.__file__ == str(replays / "copied_head.py") and hasattr(head, "serve_numbers")
    assert cell.mode_module().__name__ == "benchmark.serve"


def test_a_new_per_layer_metric_is_read_from_its_own_file(tiny_root, pil_decode):
    (tiny_root / "benchmark" / "metrics").mkdir()
    (tiny_root / "benchmark" / "metrics" / "steps_traced.train.py").write_text(
        'LAYER = "train entry (engine/train.py)"\nMOVES = "train_img_s"\n'
        'SOURCE = "program_span"\nUNIT = "steps"\nBETTER = "higher"\n\n\n'
        "def read(ctx):\n    return float(ctx.traced_units) or None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                               "source": "program_span", "layer": "train entry (engine/train.py)",
                               "moves": "train_img_s", "workloads": ["tiny.train"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(load_tiny(tiny_root, "tiny.train"), 3, 1.0, True, device="cpu",
                   roots=[tiny_root / "benchmark"], t_start=0.0)
    assert res["metrics"]["steps_traced.train"]["value"] >= 1


def test_every_name_and_file_of_the_benchmark():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        spec = json.loads((REPO / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["reduced"] == c["reduced"]
        assert spec["source"] == c["source"]
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert NAME.match(w["name"]) and cell.limits, w["name"]
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["per_layer"]:
        reader = metric_reader(m["name"])
        assert (reader.LAYER, reader.MOVES, reader.SOURCE, reader.UNIT, reader.BETTER) == (
            m["layer"], m["moves"], m["source"], m["unit"], m["better"]), m["name"]
        moved = {e["name"]: e for e in bench["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
        assert NAME.match(m["name"])
