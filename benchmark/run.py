"""The benchmark of cpm_tpu_torch on an NVIDIA H100: one cell, one run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up (data tree, weights, the port's model and loaders, warm-up of every
shape), measures for `--seconds`, checks what the timed path produced
against the plain reference, and prints one JSON line last: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and `checks` (each compared number beside its limit). Everything else goes
on earlier lines. Exits non-zero with no result line where there is no
CUDA device, too few of them, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
GIB = float(2 ** 30)


def card_lines(count: int):
    """The cards' names and power limits, from nvidia-smi."""
    try:
        text = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        text = f"nvidia-smi unavailable: {e}"
    return text.splitlines()[:count] or [text]


def end_to_end(cell, run) -> dict:
    lat = run.host.get("latency_ms", [])
    values = {
        "serve_img_s": run.images / run.window_s if run.window_s else None,
        "serve_p95_ms": statistics.quantiles(lat, n=20)[18] if len(lat) >= 20 else None,
        "train_img_s": run.images / run.window_s if run.window_s else None,
        "peak_mem_gib": run.peak_window_bytes / GIB if run.peak_window_bytes else None,
        "setup_s": run.setup_s,
    }
    out = {}
    for m in cell.end_to_end:
        v = values.get(m["name"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


class Context:
    """What a per-layer reader reads: host samples, the trace summary, the
    captured calls' bounds, FLOPs and the run's counts."""

    def __init__(self, cell, run):
        self.cell, self.run = cell, run
        self.host, self.trace, self.bounds = run.host, run.trace, run.bounds
        self.flops_per_image = run.flops_per_image
        self.traced_units, self.captured_units = run.traced_units, run.captured_units
        self.traced_window_s = (run.host.get("traced_window_s") or [0.0])[0]


def per_layer(cell, run, roots=()) -> dict:
    from benchmark.registry import metric_reader

    ctx = Context(cell, run)
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"], roots).read(ctx)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def describe(cell, run):
    """Earlier lines: sample counts and the counts behind each share."""
    for k, v in run.host.items():
        if v and k != "traced_window_s":
            print(f"[samples] {k}: n={len(v)} mean={statistics.fmean(v):.4f} "
                  f"median={statistics.median(v):.4f} max={max(v):.4f}")
    if run.flops_per_image:
        print(f"[count] FLOPs an image (reference, FlopCounterMode): {run.flops_per_image:.6e}")
    for k, v in run.bounds.items():
        print(f"[count] {k}: {v}")
    if run.trace is not None:
        t = run.trace
        print(f"[trace] window {t.window_s:.6f} s, device busy {t.busy_s:.6f} s, "
              f"{run.traced_units} units traced, {run.captured_units} captured")
        for k, (s, n) in sorted(t.spans.items()):
            print(f"[trace] span {k}: {s:.6f} s host over {n}")


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda", roots=(),
             hooks=None, workdir=None, t_start=None) -> dict:
    """One run of `cell`; returns the result line's object."""
    import torch

    from benchmark import check
    from benchmark.common import jax_modules

    torch.set_num_threads(4)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="cpm_bench_")
    try:
        run = cell.mode_module().run(cell, seed, seconds, trace, device, workdir,
                                     T_START if t_start is None else t_start, hooks=hooks)
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    describe(cell, run)
    rows = check.judge(run.numbers, cell.limits)
    for k, v in run.numbers.items():
        if k not in cell.limits:
            print(f"[check] {k} = {v!r} (not judged)")
    correct = bool(rows) and all(r["ok"] for r in rows) and run.failed == 0
    dev = torch.device(device)
    result = {
        "correct": correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": per_layer(cell, run, roots) if trace else end_to_end(cell, run),
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": run.peak_bytes,
        },
    }
    if trace and run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    found = jax_modules()
    if found:
        raise SystemExit(f"benchmark: the run loaded {', '.join(found)}")
    for r in rows:
        print(f"check {r['name']} {r['value']!r} limit {r['limit']!r} "
              f"{'ok' if r['ok'] else 'FAILED'}", file=sys.stderr)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths (the
    # port's nvcc builds and native library go to build/cpm_tpu_torch/ itself)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "benchmark" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "benchmark" / "triton")
    os.environ["USE_FLAX"] = "0"

    from benchmark.registry import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.exit(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {n}")
    if cell.chips != 1:
        sys.exit(f"benchmark: {args.workload}: cells of more than one card are not run yet")
    for line in card_lines(cell.chips):
        print(f"[card] {line}")
    print(f"[run] {args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
