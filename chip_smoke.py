"""Chip smoke test: drives the port's eval and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

0. device: requires CUDA; prints the card's name and power limit, the torch
   and CUDA versions, and whether yaml and PIL import.
1. build: builds the multilevel RoIAlign CUDA kernels (forward and backward)
   from cpm_tpu_torch/csrc with nvcc.
2. kernel: the forward kernel against its plain PyTorch version at the
   flagship's pooler shapes (B=2, P2-P5 of an 800x1344 batch, C=256), f32
   and bf16.
2b. backward kernel: against its plain version (autograd of the plain
   forward) at the training shapes (R=1024 at 7x7, R=256 at 14x14, ~30%
   masked, and a case where 512 rois share a few cells so that the atomics
   collide): f32, bf16, masked rois add nothing, two runs on the same inputs.
3. main path: the flagship CPM R-50-FPN config (81 classes, 3 CMM stages,
   ISM, RSM) with seeded random weights, bf16, uint8 images normalized on
   the device: six batch-1 requests at 800x1344, then one batch-2 request.
   Checks every request's detections and that it launched the kernel 5 times
   (cls, three grid stages, rescore). Then the kernel check of phase 2 is
   repeated on the FPN maps and rois of the five pooler calls of one batch-1
   forward; the JSON line's `ms` and `plain_ms` are their times summed.
4. reference: the port on the card against the port on the CPU (plain
   pooler) at a narrow width in f32, detections compared as masked sets.
5. training path: `create_train_state(flagship_cfg(), "cuda", seed=0)` at
   the operating point the JAX package trains (batch 2 at 800x1344, up to
   32 gt per image, RPN.PRE_NMS_TOP_N_TRAIN=2000, bf16 compute on f32
   masters, uint8 images). The weights are random from the seed; the
   trunk's frozen affines are then set from one seeded batch's statistics
   (cpm_tpu_torch/tools/profile_train.py::fold_batch_statistics). One warm-up step, three timed steps checked for
   losses, launches (5 forward, 5 backward), gradients, changed and frozen
   parameters and the learning rate; then the backward-kernel check of
   phase 2b on the gradients, rois and level shapes of the five pooler
   sites of one more step.
6. training reference: two steps of the port on the card against two on the
   CPU at a narrow width in f32, the same seed, batch and draws.

Then a JSON line of kernel results and, last, {"ok": true, "device": ...}.
Random weights give softmax scores near 1/81, below the default 0.03
threshold, so GRID_RCNN.SCORE_THRESH is set to 0.0 for phase 3.

Each kernel's `bound_ms` is the least time the card could take for the call:
the larger of its bytes over 3.35 TB/s (the level cells the rois touch, the
rois, and the output for the forward; the valid rois' gradient rows, the
rois, and every level map written once for the backward) and its f32
multiply-adds over 67 TFLOP/s. No single PyTorch call computes a multilevel
RoIAlign or its transpose, so `library_ms` is null.
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
BWD_F32_RTOL, BWD_F32_ATOL = 1e-4, 1e-4
REPLACES = "cpm_tpu/ops/pallas/multilevel_pallas.py:480"
BWD_REPLACES = "cpm_tpu/ops/pallas/multilevel_pallas.py:632"
SOURCE = "cpm_tpu_torch/csrc/multilevel_roi_align.cu"
POOLER_SITES = ("cls 7x7", "grid stage 1 14x14", "grid stage 2 14x14",
                "grid stage 3 14x14", "rescore 7x7")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # f32 outside the tensor cores, same sheet
TRAIN_LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_grid_1",
                "loss_grid_2", "loss_grid_3", "loss_iou_3", "loss_rescore")


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


def roi_align_bounds(shapes, rois, levels, valid, pool, elem_size):
    """(forward bound ms, backward bound ms, 'bytes' or 'operations' each)
    for one call on these inputs, as the module docstring sets out. The
    cells a forward must read are those that receive a non-zero gradient
    from an all-ones output gradient, counted with the plain backward at
    C=1."""
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import plain_multilevel_roi_align_backward

    channels = shapes[0][3]
    ones = torch.ones((rois.shape[0], *pool, 1), device=rois.device)
    touched = plain_multilevel_roi_align_backward(
        [(*s[:3], 1) for s in shapes], rois, levels, valid, ones, SCALES, 2)
    cells = sum(int((t != 0).sum()) for t in touched)
    n, n_valid = rois.shape[0], int(valid.sum())
    bins = pool[0] * pool[1]
    roi_bytes = n * (5 * 4 + 4 + 1)
    out_bytes = n * bins * channels * elem_size
    fwd_bytes = cells * channels * elem_size + roi_bytes + out_bytes
    map_bytes = sum(s[0] * s[1] * s[2] for s in shapes) * channels * elem_size
    bwd_bytes = n_valid * bins * channels * elem_size + roi_bytes + map_bytes
    flops = n_valid * bins * 4 * 4 * channels * 2  # samples x cells x (mul, add)
    out = []
    for nbytes in (fwd_bytes, bwd_bytes):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        out.append((max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"))
    return out


def check_kernel(name, features, rois, levels, valid, pool, rescale=False):
    """Kernel vs plain version, f32 and bf16, on the same inputs. Returns
    (f32 max error, bf16 kernel ms, bf16 plain ms, bound ms, bound_by).

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
    (bound_ms, bound_by), _ = roi_align_bounds(
        [tuple(f.shape) for f in bf], rois, levels, valid, pool, 2)
    print(
        f"[kernel] {name}: R={rois.shape[0]} pool={pool} valid={int(valid.sum())} "
        f"f32 max|err|={err32:.3g} (atol {F32_ATOL}) bf16 max|err|={err16:.3g} "
        f"(rtol {BF16_RTOL}, atol {BF16_ATOL}) bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})"
    )
    return err32, ms, plain_ms, bound_ms, bound_by


def check_backward_kernel(name, shapes, rois, levels, valid, g, card, rescale=False):
    """Backward kernel vs its plain version (autograd of the plain forward)
    on the same inputs: f32 (TF32 plays no part: neither side multiplies
    matrices), bf16, masked rois, two runs. Returns a dict of the f32 max
    error and the bf16 times and bound.

    Tolerances. f32: rtol 1e-4 / atol 1e-4, the JAX package's own for its
    backward kernel; both sides sum each cell's terms in f32 in another
    order, the kernel's atomics in an order that changes from run to run.
    bf16: the kernel sums in f32 and rounds once, the plain version is the
    f32 gradient of the same bf16 `g` rounded to bf16, so they differ by at
    most one bf16 rounding: rtol 1.6e-2 / atol 1e-2.
    rescale: first scale `g` by the power of two that brings its largest
    magnitude to at most 1 (exact, and the backward is linear in `g`)."""
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import (
        KERNEL,
        plain_multilevel_roi_align_backward as plain,
    )

    pool = tuple(g.shape[1:3])
    if rescale:
        peak = g.float().abs().max().item()
        exp = math.ceil(math.log2(peak)) if peak > 0 else 0
        g = g * 2.0 ** -exp
        name = f"{name} (g scaled by 2^{-exp}, max |g| {peak:.4g})"
    g32 = g.float().contiguous()
    got = KERNEL.backward(shapes, rois, levels, valid, g32, SCALES, 2)
    want = plain(shapes, rois, levels, valid, g32, SCALES, 2)
    torch.cuda.synchronize()
    err32 = 0.0
    for a, b in zip(got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite f32 gradient")
        d = (a - b).abs()
        err32 = max(err32, d.max().item())
        bad = (d > BWD_F32_ATOL + BWD_F32_RTOL * b.abs()).sum().item()
        if bad:
            raise AssertionError(
                f"{name}: f32 backward, {bad} cells beyond rtol {BWD_F32_RTOL} "
                f"atol {BWD_F32_ATOL}, max |err| {d.max().item()}")

    # masked rois add nothing: the same gradient with them removed
    kept = KERNEL.backward(shapes, rois[valid].contiguous(), levels[valid].contiguous(),
                           torch.ones_like(valid[valid]), g32[valid].contiguous(), SCALES, 2)
    err_masked = max((a - b).abs().max().item() for a, b in zip(got, kept))
    if any(((a - b).abs() > BWD_F32_ATOL + BWD_F32_RTOL * b.abs()).any() for a, b in zip(got, kept)):
        raise AssertionError(f"{name}: masked rois changed the gradient by {err_masked}")

    again = KERNEL.backward(shapes, rois, levels, valid, g32, SCALES, 2)
    rerun = max((a - b).abs().max().item() for a, b in zip(got, again))

    g16 = g.to(torch.bfloat16).contiguous()
    got16 = KERNEL.backward(shapes, rois, levels, valid, g16, SCALES, 2)
    want16 = plain(shapes, rois, levels, valid, g16.float(), SCALES, 2)
    torch.cuda.synchronize()
    err16 = 0.0
    for a, b in zip(got16, want16):
        a, b = a.float(), b.to(torch.bfloat16).float()
        d = (a - b).abs()
        err16 = max(err16, d.max().item())
        bad = (d > BF16_ATOL + BF16_RTOL * b.abs()).sum().item()
        if bad:
            raise AssertionError(f"{name}: bf16 backward, {bad} cells beyond rtol {BF16_RTOL} "
                                 f"atol {BF16_ATOL}, max |err| {d.max().item()}")
    del got, want, kept, again, got16, want16

    ms = cuda_ms(lambda: KERNEL.backward(shapes, rois, levels, valid, g16, SCALES, 2))
    plain_ms = cuda_ms(lambda: plain(shapes, rois, levels, valid, g16, SCALES, 2), reps=5)
    _, (bound_ms, bound_by) = roi_align_bounds(shapes, rois, levels, valid, pool, 2)
    print(
        f"[bwd kernel] {name}: R={rois.shape[0]} pool={pool} valid={int(valid.sum())} "
        f"f32 max|err|={err32:.3g} (rtol {BWD_F32_RTOL}, atol {BWD_F32_ATOL}) "
        f"masked-removed max|diff|={err_masked:.3g} two-runs max|diff|={rerun:.3g} "
        f"bf16 max|err|={err16:.3g} (rtol {BF16_RTOL}, atol {BF16_ATOL}) "
        f"bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}) | {card}"
    )
    return dict(err=err32, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                rerun=rerun)


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


def phase_backward_kernel(dev, rng, card):
    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    shapes = [(2, h, w, 256) for h, w in SHAPES]
    results = []
    cases = [("synthetic 7x7", 1024, (7, 7), False), ("synthetic 14x14", 256, (14, 14), False),
             ("colliding 7x7", 512, (7, 7), True)]
    for name, n, pool, collide in cases:
        rois, valid = synthetic_rois(n, rng, dev)
        if collide:
            # every roi a jittered copy of one small box: they share a few cells
            base = torch.tensor([0.0, 400.0, 300.0, 430.0, 326.0], device=dev)
            rois = base + torch.from_numpy(rng.uniform(-2, 2, (n, 5)).astype(np.float32)).to(dev)
            rois[:, 0] = 0.0
        levels = assign_fpn_levels(rois[:, 1:5], 2, 5) - 2
        g = torch.randn(n, *pool, 256, generator=torch.Generator().manual_seed(n)).to(dev)
        results.append(check_backward_kernel(name, shapes, rois, levels, valid, g, card))
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
    ms, plain_ms, bound_ms = (sum(r[i] for r in results) for i in (1, 2, 3))
    bound_by = max(results, key=lambda r: r[3])[4]
    print(f"[kernel] the 5 pooler calls of one batch-1 forward: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
          f"(bf16, median CUDA-event times summed) | {card}")
    return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


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


# one parameter of each group must move in every training step
TRAINED_GROUPS = (
    "backbone.layer2.", "backbone.layer3.", "backbone.layer4.", "fpn.", "rpn_head.",
    "roi_head.cls_head.", "roi_head.cls_output.",
    "roi_head.grid_heads.0.", "roi_head.grid_outputs.0.",
    "roi_head.grid_heads.1.", "roi_head.grid_outputs.1.",
    "roi_head.grid_heads.2.", "roi_head.grid_outputs.2.deconv", "roi_head.grid_outputs.2.iou_",
    "roi_head.rescore_head.", "roi_head.rescore_output.",
)


def phase_train(dev, card):
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import KERNEL
    from cpm_tpu_torch.solver.lr_schedule import make_lr_fn
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics, training_cfg

    cfg = training_cfg()
    t0 = time.perf_counter()
    model, optimizer, state = create_train_state(cfg, dev, seed=0)
    step_fn = make_train_step(cfg, model, optimizer)
    lr_fn = make_lr_fn(cfg.SOLVER)
    labels = classify_params(model, int(cfg.BACKBONE.RESNET.FREEZE_AT))
    frozen = {k for k, v in labels.items() if v == "frozen"}
    if not any(k.startswith("backbone.conv1") for k in frozen) or not any(
            k.startswith("backbone.layer1.") for k in frozen):
        raise AssertionError("stem and layer1 are not frozen")
    def batch_for(seed):
        return synthetic_batch(2, 800, 1344, max_gt=32, num_classes=cfg.MODEL.NUM_CLASSES,
                               seed=seed, uint8=True)

    n_folded = fold_batch_statistics(model, batch_for(99)["images"])
    print(f"[train] {n_folded} frozen trunk affines set from the statistics of one seeded batch "
          f"(folded BatchNorm, as a pretrained trunk has; unit affines diverge in two steps)")
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    print(f"[train] state built in {time.perf_counter() - t0:.2f} s: "
          f"{sum(p.numel() for p in model.parameters())} parameters, {len(frozen)} frozen tensors, "
          f"{cfg.TPU.COMPUTE_DTYPE} compute on f32 masters, SGD momentum {cfg.SOLVER.MOMENTUM} "
          f"wd {cfg.SOLVER.WEIGHT_DECAY}, groups {[g['name'] for g in optimizer.param_groups]}; "
          f"grid towers run on the valid prefix rounded up to TPU.TOWER_BUCKETS "
          f"{tuple(cfg.TPU.TOWER_BUCKETS)} or the cap")

    state, _ = step_fn(state, batch_for(100))
    torch.cuda.synchronize()
    print("[train] warm-up: one step (untimed, uncounted)")

    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = KERNEL.backward_launches = 0
    times = []
    for i in range(3):
        batch = batch_for(101 + i)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        fwd0, bwd0, step0 = KERNEL.launches, KERNEL.backward_launches, state.step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses = {k: float(metrics[k]) for k in TRAIN_LOSSES}
        if set(metrics) != set(TRAIN_LOSSES) | {"total_loss", "lr"}:
            raise AssertionError(f"step {i}: metrics {sorted(metrics)}")
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"step {i}: non-finite loss {losses}")
        total = float(metrics["total_loss"])
        if abs(total - sum(losses.values())) > 1e-4 * abs(total):
            raise AssertionError(f"step {i}: total_loss {total} != sum {sum(losses.values())}")
        launched = (KERNEL.launches - fwd0, KERNEL.backward_launches - bwd0)
        if metrics["lr"] != lr_fn(step0):
            raise AssertionError(f"step {i}: lr {metrics['lr']} != schedule {lr_fn(step0)}")
        changed = set()
        for k, p in model.named_parameters():
            if k in frozen:
                if p.grad is not None or not torch.equal(p, start[k]):
                    raise AssertionError(f"step {i}: frozen parameter {k} changed")
                continue
            if p.grad is None or p.grad.dtype != torch.float32 or not torch.isfinite(p.grad).all():
                raise AssertionError(f"step {i}: gradient of {k} missing, not f32 or not finite")
            if p.dtype != torch.float32 or not torch.isfinite(p).all():
                raise AssertionError(f"step {i}: parameter {k} not f32 or not finite")
            if not torch.equal(p, before[k]):
                changed.add(k)
        still = [g for g in TRAINED_GROUPS if not any(k.startswith(g) for k in changed)]
        if still:
            raise AssertionError(f"step {i}: no parameter changed in {still}")
        if launched != (5, 5):
            raise AssertionError(f"step {i}: {launched} forward/backward launches, want (5, 5)")
        print(f"[train] step {i} (update {step0}): {times[-1] * 1e3:.1f} ms, lr {metrics['lr']:.6g} "
              f"(schedule {lr_fn(step0):.6g}), total_loss {total:.4f}, "
              + ", ".join(f"{k[5:]} {v:.4f}" for k, v in losses.items())
              + f"; launches fwd {launched[0]} bwd {launched[1]}; "
              f"{len(changed)} tensors changed, {len(frozen)} frozen bit-equal")
        del before
    launches = (KERNEL.launches, KERNEL.backward_launches)
    peak = torch.cuda.max_memory_allocated()
    ms = sorted(t * 1e3 for t in times)
    print(f"[train] step time median {ms[1]:.1f} ms (min {ms[0]:.1f}, max {ms[2]:.1f}) over 3 steps, "
          f"batch 2 at 800x1344 | {card}")
    print(f"[train] peak device memory {peak / 2**20:.1f} MiB (max_memory_allocated) | {card}")
    print(f"[train] kernel launches in the 3 steps: forward {launches[0]}, backward {launches[1]}")

    # after the timed run: one more step, capturing what the five backward
    # launches were given
    captured = []
    real = KERNEL.backward

    def capture(shapes, rois, levels, valid, g, *args, **kwargs):
        captured.append(([tuple(s) for s in shapes], rois.clone(), levels.clone(),
                         valid.clone(), g.clone()))
        return real(shapes, rois, levels, valid, g, *args, **kwargs)

    KERNEL.backward = capture
    try:
        state, _ = step_fn(state, batch_for(104))
        torch.cuda.synchronize()
    finally:
        del KERNEL.backward
    if len(captured) != len(POOLER_SITES):
        raise AssertionError(f"{len(captured)} backward launches in one step, want 5")
    del start
    model.zero_grad(set_to_none=True)
    # autograd runs the sites backwards: rescore first, cls last
    results = [
        check_backward_kernel(f"train-step {site}", *call, card, rescale=True)
        for site, call in zip(POOLER_SITES, reversed(captured))
    ]
    ms_k, plain_ms, bound_ms = (sum(r[k] for r in results) for k in ("ms", "plain_ms", "bound_ms"))
    print(f"[bwd kernel] the 5 backward calls of one training step: kernel {ms_k:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bf16, median CUDA-event times "
          f"summed) | {card}")
    return dict(
        launches=launches, err=max(r["err"] for r in results), ms=ms_k, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=max(results, key=lambda r: r["bound_ms"])["bound_by"],
    )


def phase_train_reference(dev):
    """Two training steps of the port on the card against two on the CPU at
    a narrow width in f32: the same seed (so the same weights and the same
    draws, both made on the CPU) and the same batch. The CPU port is held
    against the JAX package by the CPU tests. Tolerances: losses 1e-4
    relative; gradients rtol 1e-3 / atol 1e-5 and parameters after two steps
    rtol 1e-4 / atol 1e-6 (cuDNN and the CPU sum in different orders; TF32
    is off)."""
    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step

    cfg = flagship_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    batch = synthetic_batch(2, 128, 160, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES, seed=5)
    runs = {}
    for d in ("cpu", dev):
        model, optimizer, state = create_train_state(cfg, d, seed=0)
        step_fn = make_train_step(cfg, model, optimizer)
        state, m1 = step_fn(state, batch)
        grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        state, m2 = step_fn(state, batch)
        runs[d] = (
            [{k: float(v) for k, v in m.items()} for m in (m1, m2)], grads,
            {k: p.detach().cpu().clone() for k, p in model.named_parameters()},
        )
    (ref_m, ref_g, ref_p), (got_m, got_g, got_p) = runs["cpu"], runs[dev]
    for i, (rm, gm) in enumerate(zip(ref_m, got_m)):
        for k in TRAIN_LOSSES + ("total_loss", "lr"):
            if abs(gm[k] - rm[k]) > 1e-4 * abs(rm[k]):
                raise AssertionError(f"train reference step {i}: {k} {gm[k]} vs {rm[k]}")
    if set(ref_g) != set(got_g):
        raise AssertionError("train reference: different parameters have gradients")
    for what, ref, got, rtol, atol in (("gradient", ref_g, got_g, 1e-3, 1e-5),
                                       ("parameter after 2 steps", ref_p, got_p, 1e-4, 1e-6)):
        worst = 0.0
        for k in ref:
            d = (got[k] - ref[k]).abs()
            worst = max(worst, d.max().item())
            if (d > atol + rtol * ref[k].abs()).any():
                raise AssertionError(f"train reference: {what} {k} differs by {d.max().item()}")
        print(f"[train reference] {len(ref)} {what} tensors match the CPU port "
              f"(rtol {rtol}, atol {atol}; max |diff| {worst:.3g})")
    print(f"[train reference] 8 losses, total and lr of 2 steps match the CPU port to 1e-4 relative: "
          f"step 0 total {got_m[0]['total_loss']:.6f} vs {ref_m[0]['total_loss']:.6f}, "
          f"step 1 total {got_m[1]['total_loss']:.6f} vs {ref_m[1]['total_loss']:.6f}")


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
    synthetic_bwd = phase_backward_kernel(dev, rng, card)
    fwd = phase_main(dev, rng, card)
    phase_reference(dev)
    bwd = phase_train(dev, card)
    phase_train_reference(dev)

    fwd_launches = fwd["launches"] + bwd["launches"][0]
    print(f"[kernels] forward launches: eval path {fwd['launches']}, training path "
          f"{bwd['launches'][0]}; backward launches: training path {bwd['launches'][1]}")
    kernels = [
        dict(name="multilevel_roi_align", replaces=REPLACES, launches=fwd_launches,
             max_abs_err=max([fwd["err"]] + [r[0] for r in synthetic]), stats=fwd),
        dict(name="multilevel_roi_align_backward", replaces=BWD_REPLACES,
             launches=bwd["launches"][1],
             max_abs_err=max([bwd["err"]] + [r["err"] for r in synthetic_bwd]), stats=bwd),
    ]
    print(json.dumps({"kernels": [{
        "name": k["name"],
        "route": "cuda",
        "source": SOURCE,
        "replaces": k["replaces"],
        "launches": k["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["stats"]["ms"],
        "plain_ms": k["stats"]["plain_ms"],
        "bound_ms": k["stats"]["bound_ms"],
        "bound_by": k["stats"]["bound_by"],
        "library_ms": None,
    } for k in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
