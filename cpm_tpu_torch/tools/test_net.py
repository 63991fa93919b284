"""Eval CLI of the port.

    python -m cpm_tpu_torch.tools.test_net --cfg file.yaml [--device cuda|cpu]
        [--range s e] [--shards N] [KEY VALUE ...]

The contract of the JAX package's tools/test_net.py and of the reference's
tools/rcnn/test_net.py: a YAML config and trailing `KEY VALUE` overrides
(after the options). It evaluates the weights that the reference's
precedence picks (pet/utils/checkpointer.py:13-18): an existing TEST.WEIGHTS
file wins (a reference torch checkpoint, .pth / .pt / .pkl, imported by
utils/weight_import.py), otherwise CKPT's `model_latest`; with neither it
says loudly that it evaluates seeded random weights. It runs TEST.DATASETS'
first dataset, with the passes of TEST.BBOX_AUG when it is on, writes
$CKPT/test/bbox.json and prints the COCO stats and the images per second
(the first batch apart: the card plans its convolutions for a bucket then).

`--range s e` runs images [s, e) only and writes their results to
$CKPT/test/detection_range_{s}_{e}.json, without evaluating. `--shards N`
is a parent mode (the reference's subprocess-per-GPU eval,
pet/utils/subprocess.py:12-95): it splits the images (or the `--range`)
over N child processes of this CLI, each on one card, merges their range
files, and evaluates (or, with `--range`, writes the merged range file).
`--device` as in train_net.
"""

import json
import os
import subprocess
import sys
import time

from cpm_tpu_torch.tools.train_net import (
    arg_parser,
    device_name,
    load_config,
    parse_args,
    resolve_device,
)

# the directory that holds cpm_tpu_torch: the children import the package from it
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _args(argv):
    p = arg_parser("CPM R-CNN evaluation (PyTorch)")
    p.add_argument("--range", dest="range", nargs=2, type=int, default=None,
                   help="evaluate images [s, e) only; write their results, do not evaluate")
    p.add_argument("--shards", type=int, default=0,
                   help="parent mode: split the images over N child processes, one card each")
    return parse_args(argv, p)


def _write_range(cfg, start, end, results):
    out_dir = os.path.join(cfg.CKPT, "test")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"detection_range_{start}_{end}.json")
    with open(path, "w") as f:
        json.dump(results, f)
    print(f"wrote {path}", flush=True)


def run_sharded(args, cfg, dataset):
    """Parent mode (test_engine.py:60-100, subprocess.py:12-95): one child of
    this CLI a shard with `--range`, the parent's `--device` and overrides;
    wait, merge the range files, evaluate. Each child's output goes to
    $CKPT/test/shard_{s}_{e}.log.

    On `cuda` a child sees one card, CUDA_VISIBLE_DEVICES = i mod the card
    count (unless the caller set the variable), and the children run in
    waves of the card count; on the CPU all at once, sharing the cores
    (OMP_NUM_THREADS, unless the caller set it). The parent itself
    creates no CUDA context. Returns dict(stats, results)."""
    import torch

    from cpm_tpu_torch.engine.test import evaluate_results, shard_ranges

    out_dir = os.path.join(cfg.CKPT, "test")
    os.makedirs(out_dir, exist_ok=True)
    start, end = args.range if args.range else (0, len(dataset))
    ranges = [(start + s, start + e) for s, e in shard_ranges(end - start, args.shards)]
    cards = torch.cuda.device_count() if args.device.startswith("cuda") else 0
    wave_size = cards if cards else len(ranges)
    cpus = len(os.sched_getaffinity(0))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    results = []
    for w0 in range(0, len(ranges), wave_size):
        procs = []
        try:
            for i, (s, e) in enumerate(ranges[w0:w0 + wave_size], start=w0):
                cmd = [sys.executable, "-m", "cpm_tpu_torch.tools.test_net",
                       "--cfg", args.cfg_file, "--device", args.device,
                       "--range", str(s), str(e)] + (args.opts or [])
                child_env = dict(env)
                if cards and "CUDA_VISIBLE_DEVICES" not in os.environ:
                    child_env["CUDA_VISIBLE_DEVICES"] = str(i % cards)
                if not cards and "OMP_NUM_THREADS" not in os.environ:
                    # CPU children share the cores; each taking all of them
                    # slows a wave by a hundred times
                    child_env["OMP_NUM_THREADS"] = str(max(1, cpus // wave_size))
                log_path = os.path.join(out_dir, f"shard_{s}_{e}.log")
                with open(log_path, "w") as log:
                    procs.append((s, e, log_path, subprocess.Popen(
                        cmd, env=child_env, stdout=log, stderr=subprocess.STDOUT)))
                print(f"spawned shard {i}: images [{s}, {e}) -> {log_path}", flush=True)
            for s, e, log_path, proc in procs:
                if proc.wait() != 0:
                    with open(log_path) as f:
                        tail = f.read()[-3000:]
                    raise RuntimeError(f"shard [{s}, {e}) failed with rc {proc.returncode}; "
                                       f"the end of {log_path}:\n{tail}")
                with open(os.path.join(out_dir, f"detection_range_{s}_{e}.json")) as f:
                    results.extend(json.load(f))
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    if args.range:
        _write_range(cfg, start, end, results)
        return dict(stats=None, results=results)
    stats = evaluate_results(cfg, dataset, results, output_dir=out_dir)
    print(json.dumps(stats, indent=2), flush=True)
    return dict(stats=stats, results=results)


def main(argv=None):
    """Evaluate as the config says; returns dict(stats, results, seconds,
    model): the COCO stats (None with `--range`), the result dicts, each
    batch's wall time and the model evaluated. In parent mode (`--shards`),
    dict(stats, results)."""
    args = _args(argv)
    device = resolve_device(args.device)
    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.test import evaluate_results, run_inference_on_dataset, tta_passes
    from cpm_tpu_torch.engine.train import TrainState
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.utils.weight_import import import_cpm_checkpoint

    cfg = load_config(args.cfg_file, args.opts)
    dataset = build_dataset(cfg, cfg.TEST.DATASETS, is_train=False)[0]
    if args.shards > 1:
        return run_sharded(args, cfg, dataset)

    tw = cfg.TEST.WEIGHTS
    model = build_model(cfg, device, seed=0)
    if tw and os.path.isfile(tw) and tw.endswith((".pth", ".pt", ".pkl")):
        model.load_state_dict(import_cpm_checkpoint(tw, cfg), strict=True)
        print(f"loaded torch weights from TEST.WEIGHTS: {tw}", flush=True)
    elif tw and os.path.exists(tw):
        # an existing path that cannot be imported is a user error: failing
        # beats evaluating other weights under its name
        raise ValueError(f"TEST.WEIGHTS exists but is not an importable torch checkpoint "
                         f"(.pth/.pt/.pkl): {tw}")
    else:
        if tw:
            print(f"WARNING: TEST.WEIGHTS not found, falling back to CKPT: {tw}", flush=True)
        state = TrainState(step=0, model=model, optimizer=None, draws=None)
        if CheckPointer(cfg.CKPT, auto_resume=True).load(state) is not None:
            print(f"loaded checkpoint at iter {state.step}", flush=True)
        else:
            print(f"WARNING: no checkpoint found under {cfg.CKPT}; evaluating random init",
                  flush=True)

    start, end = args.range if args.range else (0, len(dataset))
    seconds = []
    t0 = time.perf_counter()
    results = run_inference_on_dataset(cfg, model, dataset, start=start, end=end,
                                       batch_seconds=seconds)
    dt = time.perf_counter() - t0
    n = end - start
    first = min(n, max(1, int(cfg.TEST.IMS_PER_GPU)))  # the first batch's images
    rest = (f"; the first batch {seconds[0]:.3f} s, the other {n - first} images at "
            f"{(n - first) / sum(seconds[1:]):.2f} img/s" if len(seconds) > 1 else "")
    print(f"inference: {n} images in {dt:.2f} s ({n / dt:.2f} img/s), "
          f"{len(tta_passes(cfg))} passes an image{rest} | {device_name(device)}", flush=True)

    if args.range:
        _write_range(cfg, start, end, results)
        stats = None
    else:
        stats = evaluate_results(cfg, dataset, results, output_dir=os.path.join(cfg.CKPT, "test"))
        print(json.dumps(stats, indent=2), flush=True)
    return dict(stats=stats, results=results, seconds=seconds, model=model)


if __name__ == "__main__":
    main(sys.argv[1:])
