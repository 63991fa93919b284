"""Finds a cell's pieces by name: its configuration, traffic mix, limits and
per-layer metric readers, each a file of its own.

    BENCHMARK.json           the cells, metrics and configurations
    benchmark/configs/       <config>.json: builder, keys set, reduced, assumed
    benchmark/traffic/       <traffic>.json: a mix's parameters (traffic.py reads them)
    benchmark/limits/        <cell>.json: each compared number's limit and readings
    benchmark/metrics/       <metric>.py: LAYER, MOVES, SOURCE, UNIT, BETTER, read(ctx)
    benchmark/replays/       <head>.py: the check's replay of a head family, named by
                             the configuration's `replay`
    benchmark/<mode>.py      a mode's run and calibration readings, named by the
                             traffic mix's `mode`

Each lookup searches `roots` in order (the repository's `benchmark/` last),
so a test can add a piece in a directory of its own without touching one.
"""

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _find(roots, *parts) -> Path:
    for root in list(roots) + [HERE]:
        p = Path(root).joinpath(*parts)
        if p.exists():
            return p
    raise FileNotFoundError("/".join(parts))


def _load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict        # the configuration file's content
    mix: dict           # the traffic mix's content
    chips: int
    limits: dict        # number -> {"limit": x, ...}
    end_to_end: list    # the entries that this cell reports
    per_layer: list
    roots: tuple = ()   # directories searched before the repository's benchmark/

    @property
    def mode(self) -> str:
        return self.mix["mode"]

    def mode_module(self):
        """The module `benchmark.<mode>`: `run(...)` and `readings(...)`."""
        return importlib.import_module(f"benchmark.{self.mode}")

    def head_replay(self):
        """The configuration's head replay, `replays/<replay>.py` (found in
        `roots` first)."""
        name = self.config["replay"]
        return _load_module(_find(self.roots, "replays", f"{name}.py"), f"benchmark_replay_{name}")


def applies(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def load_cell(name: str, bench_file: Optional[Path] = None, roots: List[Path] = ()) -> Cell:
    bench_file = Path(bench_file or REPO / "BENCHMARK.json")
    bench = _load_json(bench_file)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {bench_file}")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(bench_file.parent / entry["file"])
    mix = _load_json(_find(roots, "traffic", f"{w['traffic']}.json"))
    try:
        limits = _load_json(_find(roots, "limits", f"{name}.json"))["numbers"]
    except FileNotFoundError:
        limits = {}
    return Cell(name=name, config=config, mix=mix,
                chips=int(w["chips"]), limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)],
                roots=tuple(roots))


def metric_reader(name: str, roots: List[Path] = ()):
    """The module of `benchmark/metrics/<name>.py` (found in `roots` first)."""
    return _load_module(_find(roots, "metrics", f"{name}.py"),
                        f"benchmark_metric_{name.replace('.', '_')}")


def _load_module(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
