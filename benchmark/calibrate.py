"""The readings that the limits of `correct` are set from, on the chip.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--bf16-seeds ...]

For each of `--seeds`: the port's output on the cell's check (a serving
cell's sampled requests, a training cell's first three steps) against the
plain reference in float32: the lower readings. For each of
`--control-seeds`: the control (reference/precision.py: the reference in
the port's bfloat16 regime with every bfloat16 value rounded to float8)
against the reference: the upper readings. For each of `--fault-seeds`:
the port under each fault of its mode (serve.FAULTS, train.FAULTS). For
each of `--bf16-seeds` (training): the reference in the port's bfloat16
regime, unrounded, against the reference: what bfloat16 alone reads. One
JSON line a reading, then the largest program reading and the smallest
control and fault readings of each number. The benchmark's own runs do not
run this.
"""

import argparse
import json
import shutil
import tempfile

import torch

from benchmark.registry import load_cell


def readings(cell, seed, device, kinds):
    """{kind: numbers} for this seed; kinds among program, control, fault,
    bf16 (the cell's mode module reads them)."""
    workdir = tempfile.mkdtemp(prefix="cpm_calibrate_")
    try:
        return cell.mode_module().readings(cell, seed, device, kinds, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--bf16-seeds", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: needs a CUDA device")
    cell = load_cell(args.workload)
    split = lambda s: [int(x) for x in s.split(",") if x]
    plan = {}
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds),
                        ("fault", args.fault_seeds), ("bf16", args.bf16_seeds)):
        for s in split(seeds):
            plan.setdefault(s, []).append(kind)
    table = {}
    for seed, kinds in plan.items():
        for kind, numbers in readings(cell, seed, "cuda", kinds).items():
            print(json.dumps({"seed": seed, "kind": kind, **numbers}), flush=True)
            table.setdefault(kind, []).append(numbers)
    for kind, rows in table.items():
        pick = max if kind in ("program", "bf16") else min
        print(json.dumps({"summary": kind, "n": len(rows),
                          **{k: pick(r[k] for r in rows) for k in rows[0]
                             if isinstance(rows[0][k], float)}}), flush=True)


if __name__ == "__main__":
    main()
