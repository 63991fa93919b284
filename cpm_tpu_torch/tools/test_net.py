"""Eval CLI of the port.

    python -m cpm_tpu_torch.tools.test_net --cfg file.yaml [--device cuda|cpu] [KEY VALUE ...]

The contract of the JAX package's tools/test_net.py and of the reference's
tools/rcnn/test_net.py: a YAML config and trailing `KEY VALUE` overrides
(after the options). It evaluates the weights that the reference's
precedence picks (pet/utils/checkpointer.py:13-18): an existing TEST.WEIGHTS
file wins, otherwise CKPT's `model_latest`; with neither it says loudly
that it evaluates seeded random weights. It runs one pass over
TEST.DATASETS' first dataset, writes $CKPT/test/bbox.json and prints the
COCO stats and the images per second (the first image apart: the card plans
its convolutions for the bucket then). `--device` as in train_net.
`--shards` and `--range` are not ported yet.
"""

import json
import os
import sys
import time

from cpm_tpu_torch.tools.train_net import device_name, load_config, parse_args, resolve_device


def main(argv=None):
    """Evaluate as the config says; returns dict(stats, results, seconds):
    the COCO stats, the result dicts, and each image's wall time."""
    args = parse_args(argv, description="CPM R-CNN evaluation (PyTorch)")
    device = resolve_device(args.device)
    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.test import evaluate_results, run_inference_on_dataset
    from cpm_tpu_torch.engine.train import TrainState
    from cpm_tpu_torch.modeling.model import build_model

    cfg = load_config(args.cfg_file, args.opts)
    tw = cfg.TEST.WEIGHTS
    if tw and os.path.isfile(tw) and tw.endswith((".pth", ".pt", ".pkl")):
        raise NotImplementedError(
            f"TEST.WEIGHTS {tw}: the .pth importer is not ported yet (ROADMAP.md Queue 1, item 5)")
    if tw and os.path.exists(tw):
        # an existing path that cannot be imported is a user error: failing
        # beats evaluating other weights under its name
        raise ValueError(f"TEST.WEIGHTS exists but is not an importable torch checkpoint "
                         f"(.pth/.pt/.pkl): {tw}")
    if tw:
        print(f"WARNING: TEST.WEIGHTS not found, falling back to CKPT: {tw}", flush=True)
    dataset = build_dataset(cfg, cfg.TEST.DATASETS, is_train=False)[0]

    model = build_model(cfg, device, seed=0)
    state = TrainState(step=0, model=model, optimizer=None, draws=None)
    if CheckPointer(cfg.CKPT, auto_resume=True).load(state) is not None:
        print(f"loaded checkpoint at iter {state.step}", flush=True)
    else:
        print(f"WARNING: no checkpoint found under {cfg.CKPT}; evaluating random init",
              flush=True)

    seconds = []
    t0 = time.perf_counter()
    results = run_inference_on_dataset(cfg, model, dataset, batch_seconds=seconds)
    dt = time.perf_counter() - t0
    n = len(dataset)
    first = min(n, max(1, int(cfg.TEST.IMS_PER_GPU)))  # the first batch's images
    rest = (f"; the first batch {seconds[0]:.3f} s, the other {n - first} images at "
            f"{(n - first) / sum(seconds[1:]):.2f} img/s" if len(seconds) > 1 else "")
    print(f"inference: {n} images in {dt:.2f} s ({n / dt:.2f} img/s){rest} | "
          f"{device_name(device)}", flush=True)

    stats = evaluate_results(cfg, dataset, results, output_dir=os.path.join(cfg.CKPT, "test"))
    print(json.dumps(stats, indent=2), flush=True)
    return dict(stats=stats, results=results, seconds=seconds)


if __name__ == "__main__":
    main(sys.argv[1:])
