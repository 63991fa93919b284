"""Chip smoke test: drives the port's eval path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

0. device: requires CUDA; prints the card's name and power limit, the torch
   and CUDA versions, and whether yaml and PIL import.
1. build: builds the multilevel RoIAlign CUDA kernel from
   cpm_tpu_torch/csrc with nvcc.
2. kernel: the kernel against its plain PyTorch version at the flagship's
   pooler shapes (B=2, P2-P5 of an 800x1344 batch, C=256), f32 and bf16.
3. main path: the flagship CPM R-50-FPN config (81 classes, 3 CMM stages,
   ISM, RSM) with seeded random weights, bf16, uint8 images normalized on
   the device: six batch-1 requests at 800x1344, then one batch-2 request.
   Checks every request's detections and that it launched the kernel 5 times
   (cls, three grid stages, rescore). Then the kernel check of phase 2 is
   repeated on the FPN maps and rois of the five pooler calls of one batch-1
   forward; the JSON line's `ms` and `plain_ms` are their times summed.
4. reference: the port on the card against the port on the CPU (plain
   pooler) at a narrow width in f32, detections compared as masked sets.

Then a JSON line of kernel results and, last, {"ok": true, "device": ...}.
Random weights give softmax scores near 1/81, below the default 0.03
threshold, so GRID_RCNN.SCORE_THRESH is set to 0.0 for phase 3.
"""

import json
import math
import statistics
import sys
import time

import numpy as np
import torch

SHAPES = [(200, 336), (100, 168), (50, 84), (25, 42)]
SCALES = (0.25, 0.125, 0.0625, 0.03125)
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-2
F32_ATOL = 1e-5
REPLACES = "cpm_tpu/ops/pallas/multilevel_pallas.py:480"
POOLER_SITES = ("cls 7x7", "grid stage 1 14x14", "grid stage 2 14x14",
                "grid stage 3 14x14", "rescore 7x7")


def cuda_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernel(name, features, rois, levels, valid, pool, rescale=False):
    """Kernel vs plain version, f32 and bf16, on the same inputs. Returns
    (f32 max error, bf16 kernel ms, bf16 plain ms).

    rescale: first scale the maps by the power of two that brings their
    largest magnitude to at most 1. The scaling is exact in f32 and bf16 and
    RoIAlign is linear, so atol 1e-5 then bounds the error relative to the
    maps' magnitude (random-weight FPN maps reach the thousands)."""
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import KERNEL
    from cpm_tpu_torch.ops.roi_align import multilevel_roi_align as plain

    def run_plain(fs):
        return plain(fs, rois, levels, pool, SCALES, 2) * valid.to(fs[0].dtype)[:, None, None, None]

    if rescale:
        peak = max(f.float().abs().max().item() for f in features)
        exp = max(0, math.ceil(math.log2(peak))) if peak > 0 else 0
        features = [f * 2.0 ** -exp for f in features]
        name = f"{name} (maps scaled by 2^-{exp}, max |map| {peak:.4g})"
    f32 = [f.float().contiguous() for f in features]
    got = KERNEL(f32, rois, levels, valid, pool, SCALES, 2)
    want = run_plain(f32)
    torch.cuda.synchronize()
    err32 = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or err32 > F32_ATOL:
        raise AssertionError(f"{name}: f32 kernel vs plain max |err| {err32} > {F32_ATOL}")

    bf = [f.to(torch.bfloat16).contiguous() for f in features]
    got = KERNEL(bf, rois, levels, valid, pool, SCALES, 2).float()
    want = run_plain([f.float() for f in bf]).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    err16 = (got - want).abs().max().item()
    bad = ((got - want).abs() > BF16_ATOL + BF16_RTOL * want.abs()).sum().item()
    if bad:
        raise AssertionError(f"{name}: bf16 {bad} elements beyond rtol {BF16_RTOL} atol {BF16_ATOL}")

    ms = cuda_ms(lambda: KERNEL(bf, rois, levels, valid, pool, SCALES, 2))
    plain_ms = cuda_ms(lambda: run_plain(bf))
    print(
        f"[kernel] {name}: R={rois.shape[0]} pool={pool} valid={int(valid.sum())} "
        f"f32 max|err|={err32:.3g} (atol {F32_ATOL}) bf16 max|err|={err16:.3g} "
        f"(rtol {BF16_RTOL}, atol {BF16_ATOL}) bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
    )
    return err32, ms, plain_ms


def synthetic_rois(n, rng, dev):
    """[n, 5] rois over a 2 x 800x1344 batch: random boxes, ~30% masked,
    plus extreme-aspect, out-of-image and degenerate rows."""
    b = rng.randint(0, 2, n)
    x1 = rng.uniform(-50, 1300, n)
    y1 = rng.uniform(-50, 760, n)
    w = np.exp(rng.uniform(np.log(4), np.log(900), n))
    h = np.exp(rng.uniform(np.log(4), np.log(700), n))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1)
    special = np.array([
        [0, 300, 1340, 310],       # 134:1 wide
        [600, 0, 606, 799],        # 1:133 tall
        [1400, 900, 1500, 1000],   # outside the image
        [-300, -300, -100, -100],  # outside, negative
        [500, 400, 480, 380],      # degenerate: x2 < x1, y2 < y1
        [700, 300, 700, 300],      # zero area
        [0, 0, 1343, 799],         # whole image
    ], np.float64)
    boxes[: len(special)] = special
    rois = np.concatenate([b[:, None], boxes], 1).astype(np.float32)
    valid = rng.rand(n) > 0.3
    valid[: len(special)] = True
    return torch.from_numpy(rois).to(dev), torch.from_numpy(valid).to(dev)


def phase_kernel(dev, rng):
    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    feats = [torch.randn(2, h, w, 256, generator=torch.Generator().manual_seed(i)).to(dev)
             for i, (h, w) in enumerate(SHAPES)]
    results = []
    for n, pool in ((2000, (7, 7)), (600, (14, 14))):
        rois, valid = synthetic_rois(n, rng, dev)
        levels = assign_fpn_levels(rois[:, 1:5], 2, 5) - 2
        results.append(check_kernel(f"synthetic {pool[0]}x{pool[1]}", feats, rois, levels, valid, pool))
    return results


def check_detections(dets, sizes, batch, num_classes, max_dets):
    boxes, scores = dets.boxes.float().cpu(), dets.scores.float().cpu()
    labels, mask = dets.labels.cpu(), dets.mask.cpu()
    if tuple(boxes.shape) != (batch, max_dets, 4) or tuple(scores.shape) != (batch, max_dets):
        raise AssertionError(f"detection shapes {tuple(boxes.shape)} {tuple(scores.shape)}")
    if tuple(labels.shape) != (batch, max_dets) or tuple(mask.shape) != (batch, max_dets):
        raise AssertionError("label or mask shape")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("non-finite detections")
    counts = mask.sum(1).tolist()
    for i, (h, w) in enumerate(sizes.tolist()):
        m = mask[i]
        if not m.any():
            raise AssertionError(f"image {i}: no valid detection")
        b = boxes[i][m]
        inside = (b[:, 0] >= 0) & (b[:, 2] <= w - 1) & (b[:, 1] >= 0) & (b[:, 3] <= h - 1)
        if not inside.all():
            raise AssertionError(f"image {i}: valid boxes outside the {h}x{w} image")
        lab = labels[i][m]
        if not ((lab >= 1) & (lab <= num_classes - 1)).all():
            raise AssertionError(f"image {i}: labels outside 1..{num_classes - 1}")
    return counts


def phase_main(dev, rng, card):
    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.ops.cuda import multilevel_roi_align as op
    from cpm_tpu_torch.tools.profile_eval import make_request

    cfg = flagship_cfg()
    cfg.GRID_RCNN.SCORE_THRESH = 0.0
    print("[main] GRID_RCNN.SCORE_THRESH set to 0.0 (random weights score near 1/81)")
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=0)
    forward = make_forward_fn(cfg, model)
    print(f"[main] model built in {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters, {cfg.TPU.COMPUTE_DTYPE}")
    nc, max_dets = cfg.MODEL.NUM_CLASSES, cfg.GRID_RCNN.TEST_MAX_DETECTIONS

    # cuDNN plans each new conv shape on first use: warm both batch shapes
    forward(*make_request(rng, [(800, 1333)]))
    forward(*make_request(rng, [(800, 1344), (800, 1344)]))
    torch.cuda.synchronize()
    print("[main] warm-up: one batch-1 and one batch-2 request (untimed, uncounted)")

    batch1 = [[(800, 1333)], [(800, 1067)], [(800, 1200)], [(750, 1344)],
              [(800, 1344)], [(608, 1344)]]
    requests = [make_request(rng, hw) for hw in batch1]
    requests.append(make_request(rng, [(800, 1333), (800, 1067)]))
    torch.cuda.reset_peak_memory_stats()
    op.KERNEL.launches = 0
    latencies = []
    for i, (images, sizes) in enumerate(requests):
        before = op.KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = forward(images, sizes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        latencies.append(dt)
        launched = op.KERNEL.launches - before
        counts = check_detections(dets, sizes, images.shape[0], nc, max_dets)
        if launched != 5:
            raise AssertionError(f"request {i}: {launched} kernel launches, want 5")
        print(f"[main] request {i}: batch {images.shape[0]} sizes {sizes.tolist()} "
              f"{dt * 1e3:.1f} ms, valid detections {counts}, kernel launches {launched}")
    launches = op.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    lat1 = statistics.median(latencies[:6]) * 1e3
    print(f"[main] batch-1 median latency {lat1:.2f} ms over 6 requests | {card}")
    print(f"[main] batch-2 throughput {2 / latencies[6]:.2f} img/s ({latencies[6] * 1e3:.1f} ms) | {card}")
    print(f"[main] peak device memory {peak / 2**20:.1f} MiB (max_memory_allocated) | {card}")
    print(f"[main] kernel launches in the main-path run: {launches} over {len(requests)} forwards")

    # after the timed run, so that the copies do not count in its peak memory:
    # one more batch-1 request, capturing the inputs of its five pooler calls
    captured = []
    real = op.multilevel_roi_align

    def capture(features, rois, levels, valid, output_size, *args, **kwargs):
        captured.append(([f.clone() for f in features], rois.clone(), levels.clone(),
                         valid.clone(), tuple(output_size)))
        return real(features, rois, levels, valid, output_size, *args, **kwargs)

    op.multilevel_roi_align = capture
    try:
        forward(*requests[0])
        torch.cuda.synchronize()
    finally:
        op.multilevel_roi_align = real

    if len(captured) != len(POOLER_SITES):
        raise AssertionError(f"{len(captured)} pooler calls in one forward, want 5")
    results = [
        check_kernel(f"main-path {site}", *call, rescale=True)
        for site, call in zip(POOLER_SITES, captured)
    ]
    err = max(r[0] for r in results)
    ms, plain_ms = sum(r[1] for r in results), sum(r[2] for r in results)
    print(f"[kernel] the 5 pooler calls of one batch-1 forward: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (bf16, median CUDA-event times summed) | {card}")
    return launches, err, ms, plain_ms


def phase_reference(dev):
    """The port on the card (CUDA kernel) against the port on the CPU (plain
    pooler) at a narrow width in f32; the CPU port is held against the JAX
    package by the CPU tests."""
    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools.profile_eval import make_request

    cfg = flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    rng = np.random.RandomState(1)
    images, sizes = make_request(rng, [(128, 160), (112, 96)], padded_hw=(128, 160))
    out = {}
    for d in ("cpu", dev):
        out[d] = make_forward_fn(cfg, build_model(cfg, d, seed=0))(images, sizes)
    ref, got = out["cpu"], out[dev]
    for i in range(images.shape[0]):
        rm, gm = ref.mask[i], got.mask[i].cpu()
        if rm.sum() != gm.sum() or rm.sum() == 0:
            raise AssertionError(f"reference image {i}: {int(gm.sum())} vs {int(rm.sum())} detections")
        want = zip(ref.labels[i][rm].tolist(), ref.boxes[i][rm].tolist(), ref.scores[i][rm].tolist())
        have = list(zip(got.labels[i][gm].cpu().tolist(), got.boxes[i][gm].cpu().tolist(),
                        got.scores[i][gm].cpu().tolist()))
        # one-to-one: each reference detection pairs with an unused one of
        # the same label within the tolerances
        for lw, bw, sw in want:
            for j, (lh, bh, sh) in enumerate(have):
                if lh == lw and max(abs(a - b) for a, b in zip(bw, bh)) <= 1e-2 and abs(sw - sh) <= 1e-4:
                    del have[j]
                    break
            else:
                raise AssertionError(f"reference image {i}: no detection matches ({lw}, {bw}, {sw})")
        print(f"[reference] image {i}: {int(gm.sum())} detections match the CPU port "
              f"(labels exact, boxes 1e-2 px, scores 1e-4)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from cpm_tpu_torch.tools.profile_eval import card_line

    dev = "cuda"
    card = card_line()
    print(f"[device] {card}")
    print(f"[device] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    for mod in ("yaml", "PIL"):
        try:
            __import__(mod)
            print(f"[device] {mod}: importable")
        except ImportError:
            print(f"[device] {mod}: not installed")

    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import KERNEL

    KERNEL.build()
    regs = [ln.strip() for ln in KERNEL.build_log.splitlines() if "registers" in ln]
    print(f"[build] {KERNEL.library_path} in {KERNEL.build_seconds:.2f} s; {regs}")

    rng = np.random.RandomState(0)
    synthetic = phase_kernel(dev, rng)
    launches, err, ms, plain_ms = phase_main(dev, rng, card)
    phase_reference(dev)

    max_err = max([err] + [r[0] for r in synthetic])
    print(json.dumps({"kernels": [{
        "name": "multilevel_roi_align",
        "route": "cuda",
        "source": "cpm_tpu_torch/csrc/multilevel_roi_align.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
