"""Where the eval forward's time goes on one NVIDIA GPU.

    python3 -m cpm_tpu_torch.tools.profile_eval [--config flagship|x101_dcn | --cfg file.yaml [KEY VALUE ...]]

Builds the flagship CPM R-50-FPN or CPM X-101-32x4d-FPN-DCN as chip_smoke.py
does, or the model of a YAML (`--cfg`, with KEY VALUE overrides after it;
any head family the port runs, the C4 family too):
seeded random weights, the deformable convs' offset convs spread from a
seed, bf16, GRID_RCNN.SCORE_THRESH and FAST_RCNN.SCORE_THRESH 0.0 so that
every stage pools a full detection set. It warms the model up and prints
for batch 1 and batch 2 at 800x1344, from one torch.profiler session of 3
forwards and from 3 forwards without it:

* device busy share: the CUDA kernels' device time over the 3 forwards
  divided by the wall time of the 3 forwards taken without the profiler,
  and the kernels that take the most device time;
* stage table (`stage_table`): each `cpm/` span of the forward
  (utils/spans.py: backbone, FPN, RPN head and proposals, the grid
  cascade's stages, the host syncs; another head family's time stays under
  `cpm/forward`), its host time and count a forward, and the time the card
  was idle while it was the innermost span open. Nothing is synchronised
  between stages, so the stages run as they do untraced but for the spans'
  cost (about 2 us each).

Every result line ends with the card's name and power limit.
"""

import argparse
import subprocess
import sys
import time

import numpy as np
import torch


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


def stage_table(prof, n: int):
    """The stages of `n` forwards or train steps from the spans of `prof`'s
    session (utils/spans.py: `cpm/` and `train_step/`): {span: (host ms,
    count, idle ms)} a forward or step, in the order the spans first open.
    A stage's idle time is the time the card ran nothing while that span was
    the innermost one open, from the first span's start to the last one's
    end; "outside any span" holds the rest of that time's idle."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, busy = [], []
    for e in prof.profiler.kineto_results.events():
        a, name = e.start_ns(), e.name()
        if e.device_type() == cuda:
            if not name.startswith(("Optimizer.", "ProfilerStep")):  # annotations
                busy.append((a, a + e.duration_ns()))
        elif name.startswith(("cpm/", "train_step/")):
            spans.append((a, a + e.duration_ns(), name))
    spans.sort()
    rows = {}
    for a, b, name in spans:
        host, count, idle = rows.get(name, (0.0, 0, 0.0))
        rows[name] = (host + (b - a) / 1e6, count + 1, idle)
    rows["outside any span"] = (0.0, 0, 0.0)
    t0, t1 = spans[0][0], max(b for _, b, _ in spans)
    merged = []
    for a, b in sorted(busy):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    edges = [t0] + [min(max(x, t0), t1) for ab in merged for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        around = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(around, key=lambda s: s[1] - s[0])[2] if around else "outside any span"
        host, count, idle = rows[name]
        rows[name] = (host, count, idle + (b - a) / 1e6)
    return {k: (host / n, count / n, idle / n) for k, (host, count, idle) in rows.items()}


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
        for name, (host, count, idle) in stage_table(prof, 3).items():
            print(f"[stages] batch {batch}: {name} host {host:.2f} ms x{count:g}, card idle "
                  f"{idle:.2f} ms a forward | {card}")


if __name__ == "__main__":
    main()
