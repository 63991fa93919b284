"""Where a training step's time goes on the card.

    python3 -m cpm_tpu_torch.tools.profile_train [--config flagship|x101_dcn | --cfg file.yaml]

Runs the training step of the flagship CPM R-50-FPN, of CPM
X-101-32x4d-FPN-DCN or of a YAML's model (`--cfg`, any head family the
port runs, its SOLVER.BASE_LR scaled from 16 images to 2 by the linear
rule) at the operating point of `training_cfg` (batch 2 at 800x1344, bf16
compute on f32 masters, seeded random weights, the deformable convs'
offset convs spread from a seed, synthetic uint8 batches) and prints,
beside the card's name and power limit: the step's wall time, the CUDA
kernel time per step and the device busy share from `torch.profiler`, the
host and device time of the step's forward, backward, allreduce (empty in
one process) and optimizer spans (engine/train.py's spans, utils/spans.py),
the largest kernels by device time, and the step's stage table
(profile_eval.stage_table: each span's host time and count a step, and the
card's idle time under it).
"""

import argparse
import math
import statistics
import sys
import time

import torch

from cpm_tpu_torch.tools.profile_eval import card_line, stage_table

SPANS = ("train_step/forward", "train_step/backward", "train_step/allreduce",
         "train_step/optimizer")


CONFIGS = ("flagship", "x101_dcn")


BATCH = 2   # images a step on one card


def training_cfg(name: str = "flagship", cfg_file: str = None):
    """A config of the port at the operating point the JAX package trains and
    benchmarks: 2000 pre-NMS candidates per level, 2 images a step. The
    X-101-DCN YAML sets SOLVER.BASE_LR 0.02 for its 16 images a step, as do
    the YAMLs that `cfg_file` names (which wins over `name`); by the linear
    scaling rule 2 images take 0.0025."""
    from cpm_tpu_torch import config
    from cpm_tpu_torch.tools.train_net import load_config

    if cfg_file:
        cfg = load_config(cfg_file, [])
    else:
        cfg = {"flagship": config.flagship_cfg, "x101_dcn": config.x101_dcn_cfg}[name]()
    cfg.RPN.PRE_NMS_TOP_N_TRAIN = 2000
    if name == "x101_dcn" or cfg_file:
        cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * BATCH / 16
    return cfg


OFFSET_CELLS = 2.0        # offsets spread over about +-2 cells
OFFSET_INPUT_SHARE = 0.1  # the part of that spread that depends on the conv's input


def spread_offset_convs(model, seed: int):
    """Draw every deformable conv's offset conv from `seed`, in place, so that
    its offsets spread over about +-OFFSET_CELLS cells, some samples leaving
    the map: biases uniform in that range (one constant offset per tap and
    axis) and weights normal with std OFFSET_INPUT_SHARE * OFFSET_CELLS *
    sqrt(2 / fan_in), which on inputs of unit scale (a ReLU's output, whose
    mean square is half its variance) add an input-dependent part of that
    share. A fresh offset conv
    is zero, as a checkpoint before training has it; then every sample sits on
    a whole cell and the sampler only copies, which neither a trained model
    nor a measurement should look like. The input-dependent share is kept
    small because a random trunk's features are white noise from cell to
    cell: the gradient that reaches a conv's input through its offsets is then
    about sqrt(C) times the one through the sampled values, and with weights
    of full share 30 such convs in a row multiply it beyond what SGD
    survives (the X-101 losses reached 1e21 in three steps). Returns how many
    convs were drawn."""
    from cpm_tpu_torch.ops.deform_conv import _DeformPack

    g = torch.Generator().manual_seed(seed)
    n = 0
    for mod in model.modules():
        if isinstance(mod, _DeformPack):
            conv = getattr(mod, mod.offset_conv_name)
            fan_in = conv.weight[0].numel()
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                                  * (OFFSET_INPUT_SHARE * OFFSET_CELLS * math.sqrt(2.0 / fan_in)))
                conv.bias.copy_((torch.rand(conv.bias.shape, generator=g) * 2.0 - 1.0)
                                * OFFSET_CELLS)
            n += 1
    return n


def fold_batch_statistics(model, images):
    """Set the trunk's frozen AffineChannels from the statistics of one
    batch, as a pretrained checkpoint's folded BatchNorm does: each becomes
    (x - mean) / std per channel of what it is fed, the last one of every
    residual block (a bottleneck's bn3, an aligned block's bn, a basic
    block's bn2) times 0.25. With the fresh unit affines the untrained
    trunk's activations grow by orders of magnitude from block to block, the
    first losses are in the tens of thousands, and SGD at the schedule's
    rate diverges within two steps; a trained trunk never looks like that.
    One f32 forward of the trunk, each affine set just before it runs."""
    from cpm_tpu_torch.modeling.backbone.resnet import AlignedBottleneck, BasicBlock, Bottleneck
    from cpm_tpu_torch.modeling.norm import AffineChannel

    def fold(module, args):
        x = args[0].float()
        mean, std = x.mean(dim=(0, 2, 3)), x.std(dim=(0, 2, 3)).clamp_min(1e-3)
        gamma = 0.25 if module in last_of_block else 1.0
        module.weight.copy_(gamma / std)
        module.bias.copy_(-mean * gamma / std)

    affines = [(n, m) for n, m in model.backbone.named_modules() if isinstance(m, AffineChannel)]
    last = {Bottleneck: "bn3", AlignedBottleneck: "bn", BasicBlock: "bn2"}
    last_of_block = {getattr(b, last[type(b)]) for b in model.backbone.modules() if type(b) in last}
    hooks = [m.register_forward_pre_hook(fold) for _, m in affines]
    try:
        with torch.no_grad():
            x = model._normalize_uint8(torch.as_tensor(images, device=model.backbone.conv1.weight.device))
            model.backbone(x.float().permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()
    return len(affines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--config", default="flagship", choices=CONFIGS)
    group.add_argument("--cfg", dest="cfg_file", help="a YAML config instead of --config")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step

    card = card_line()
    cfg = training_cfg(args.config, args.cfg_file)
    what = args.cfg_file or args.config
    model, optimizer, state = create_train_state(cfg, "cuda", seed=0)
    spread_offset_convs(model, seed=1)
    step_fn = make_train_step(cfg, model, optimizer)

    def batch_for(seed):
        return synthetic_batch(2, 800, 1344, max_gt=32, num_classes=cfg.MODEL.NUM_CLASSES,
                               seed=seed, uint8=True)

    fold_batch_statistics(model, batch_for(99)["images"])
    batches = [batch_for(100 + i) for i in range(4)]
    for b in batches[:2]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()

    # wall time first, so that none of the profiler's own cost is in it
    times = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(times)

    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            state, metrics = step_fn(state, batches[i % len(batches)])
        torch.cuda.synchronize()
    averages = prof.key_averages()
    on_card = torch.autograd.DeviceType.CUDA
    # the spans and the optimizer's own annotation also appear as device rows
    kernels = [e for e in averages if e.device_type == on_card
               and not e.key.startswith(("train_step/", "Optimizer."))]
    device_ms = sum(e.self_device_time_total for e in kernels) / n / 1e3

    print(f"[profile] {what} train step, batch 2 at 800x1344: wall {wall_ms:.2f} ms/step (min "
          f"{min(times):.2f}, max {max(times):.2f} over 5), CUDA kernels {device_ms:.2f} ms/step, "
          f"device busy share {device_ms / wall_ms:.3f}, total_loss "
          f"{float(metrics['total_loss']):.4f} | {card}")
    # a span's device time covers the kernels its own thread launched; the
    # backward's are launched by the autograd thread, so it gets the rest
    spans = {e.key: e for e in averages if e.key in SPANS and e.device_type != on_card}
    span_ms = {k: e.device_time_total / n / 1e3 for k, e in spans.items()}
    span_ms["train_step/backward"] = device_ms - sum(
        span_ms[k] for k in SPANS if k != "train_step/backward")
    for k in SPANS:
        print(f"[profile] {k}: host {spans[k].cpu_time_total / n / 1e3:.2f} ms/step, "
              f"device {span_ms[k]:.2f} ms/step")
    print(f"[profile] {sum(e.count for e in kernels) // n} kernel launches per step")
    for name, (host, count, idle) in stage_table(prof, n).items():
        print(f"[stages] {name} host {host:.2f} ms x{count:g}, card idle {idle:.2f} ms a step "
              f"| {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"[profile] {e.self_device_time_total / n / 1e3:8.3f} ms/step "
              f"x{e.count // n:<4d} {e.key[:90]}")


if __name__ == "__main__":
    main()
