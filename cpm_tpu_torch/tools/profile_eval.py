"""Where the eval forward's time goes on one NVIDIA GPU.

    python3 -m cpm_tpu_torch.tools.profile_eval [--config flagship|x101_dcn | --cfg file.yaml [KEY VALUE ...]]

Builds the flagship CPM R-50-FPN or CPM X-101-32x4d-FPN-DCN as chip_smoke.py
does, or the model of a YAML (`--cfg`, with KEY VALUE overrides after it;
any head family the port runs, the C4 family too):
seeded random weights, the deformable convs' offset convs spread from a
seed, bf16, GRID_RCNN.SCORE_THRESH and FAST_RCNN.SCORE_THRESH 0.0 so that
every stage pools a full detection set. It warms the model up and prints
for batch 1 and batch 2 at 800x1344:

* stage times: the forward's own stages, each timed on the host clock
  between synchronises, median of 5 forwards (a stage that runs several
  times a forward, its mean sum a forward); "nms" is the share of the
  forward spent in `ops/nms.py::nms` (one host sync per fixed-point
  iteration). The head's stages by family: the grid cascade's cls,
  cascade and rescore; Cascade R-CNN's box stages, its detection filter
  and rescore; Fast R-CNN's whole head;
* device busy share: the CUDA kernels' device time over 3 forwards
  (torch.profiler) divided by the wall time of 3 forwards taken without the
  profiler, and the kernels that take the most device time.

The synchronises make the stage times sum to more than an unsynchronised
forward. Every result line ends with the card's name and power limit.
"""

import argparse
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TRUNK_STAGES = ("backbone", "fpn", "rpn_head", "select_proposals")
# the head's stages by family: stage -> (owner, attribute); a stage listed
# in SUMMED runs several times a forward
HEAD_STAGES = {
    "GridCascadeRCNNHead": {"cls": ("head", "_test_cls"), "cascade": ("head", "_test_cascade"),
                            "rescore": ("module", "rescore_detections")},
    "CascadeRCNNHead": {"box_stages": ("head", "_stage"), "filter": ("module", "filter_detections"),
                        "rescore": ("module", "rescore_detections")},
    "FastRCNNHead": {"roi_head": ("head", "forward")},
}
SUMMED = ("box_stages", "nms")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def make_request(rng, valid_hw, padded_hw=(800, 1344)):
    """A batch of uint8 NHWC images padded to padded_hw, random pixels inside
    each image's valid (h, w), and the [B, 2] image sizes."""
    images = np.zeros((len(valid_hw),) + tuple(padded_hw) + (3,), np.uint8)
    for i, (h, w) in enumerate(valid_hw):
        images[i, :h, :w] = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    return images, np.asarray(valid_hw, np.int32)


def _instrument(model, laps):
    """Wrap each stage of `model`'s forward so that it appends its
    synchronised host time (ms) to laps[stage]; returns the stages' names."""
    from cpm_tpu_torch.modeling import model as model_mod
    from cpm_tpu_torch.modeling import rpn as rpn_mod
    from cpm_tpu_torch.ops import nms as nms_mod

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            laps[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    head = model.roi_head
    model.backbone.forward = timed("backbone", model.backbone.forward)
    if model.fpn is not None:
        model.fpn.forward = timed("fpn", model.fpn.forward)
    model.rpn_head.forward = timed("rpn_head", model.rpn_head.forward)
    model_mod.select_proposals = timed("select_proposals", model_mod.select_proposals)
    head_module = sys.modules[type(head).__module__]
    stages = HEAD_STAGES[type(head).__name__]
    for name, (owner, attr) in stages.items():
        target = head if owner == "head" else head_module
        setattr(target, attr, timed(name, getattr(target, attr)))
    # rpn imports nms by name; batched_nms calls the module's own
    rpn_mod.nms = nms_mod.nms = timed("nms", nms_mod.nms)
    return TRUNK_STAGES + tuple(stages) + ("nms",)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--config", default="flagship", choices=("flagship", "x101_dcn"))
    group.add_argument("--cfg", dest="cfg_file", help="a YAML config instead of --config")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides of --cfg")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_eval: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from cpm_tpu_torch import config
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics, spread_offset_convs
    from cpm_tpu_torch.tools.train_net import load_config

    card = card_line()
    if args.cfg_file:
        cfg = load_config(args.cfg_file, args.opts)
    else:
        cfg = {"flagship": config.flagship_cfg, "x101_dcn": config.x101_dcn_cfg}[args.config]()
    cfg.GRID_RCNN.SCORE_THRESH = 0.0
    cfg.FAST_RCNN.SCORE_THRESH = 0.0
    model = build_model(cfg, "cuda", seed=0)
    if spread_offset_convs(model, seed=1):
        # offsets are conv outputs: they need a trunk whose activations have
        # unit scale, as a pretrained one's are
        fold_batch_statistics(model, make_request(np.random.RandomState(99), [(800, 1344)])[0])
    print(f"[profile] config {args.cfg_file or args.config} {' '.join(args.opts)}")
    forward = make_forward_fn(cfg, model)
    rng = np.random.RandomState(0)
    requests = {1: make_request(rng, [(800, 1333)]),
                2: make_request(rng, [(800, 1333), (800, 1067)])}
    for req in requests.values():
        forward(*req)
    torch.cuda.synchronize()

    for batch, req in requests.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                forward(*req)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in events) / 3e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            forward(*req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"[profile] batch {batch}: wall {wall_ms:.2f} ms/forward, CUDA kernels "
              f"{device_ms:.2f} ms/forward, device busy share {device_ms / wall_ms:.3f} | {card}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[profile] batch {batch}: {e.self_device_time_total / 3e3:8.3f} ms/forward "
                  f"x{e.count // 3:<4d} {e.key[:90]}")

    laps = {}
    stages = _instrument(model, laps)
    for batch, req in requests.items():
        laps.clear()
        laps.update({k: [] for k in stages})
        totals = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(*req)
            torch.cuda.synchronize()
            totals.append((time.perf_counter() - t0) * 1e3)
        ms = {k: sum(v) / 5 if k in SUMMED else statistics.median(v)
              for k, v in laps.items() if v}
        line = " ".join(f"{k} {ms[k]:.2f}" for k in stages if k in ms)
        print(f"[stages] batch {batch} ms: {line} total {statistics.median(totals):.2f} | {card}")


if __name__ == "__main__":
    main()
