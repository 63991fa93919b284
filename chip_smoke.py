"""Chip smoke test: drives the port's eval and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

0. device: requires CUDA; prints the card's name and power limit, the torch
   and CUDA versions, and whether yaml and PIL import.
1. build: builds the six CUDA sources of cpm_tpu_torch/csrc with nvcc, one
   process each, all started together (nine kernels: multilevel forward and
   backward, stacked forward and backward, clustered forward, single-level
   forward, deformable-conv sampler forward and backward, cross-roi
   shared-window forward).
2. kernels: each multilevel-pooling forward kernel (multilevel, stacked,
   clustered) against its plain PyTorch version at the flagship's pooler
   shapes (B=2, P2-P5 of an 800x1344 batch, C=256), f32 and bf16, on random
   rois (~30% masked, with extreme-aspect, outside and degenerate boxes) and
   on a dense set that forms multi-roi groups (the group-size histogram is
   printed); the stacked and clustered kernels also against the multilevel
   kernel on the same inputs. The single-level kernel against its plain
   version at the C4 shape ([2, 50, 84, 1024] f32, 1024 rois, 7x7 and 14x14).
2b. backward kernels: the multilevel and the stacked backward against their
   plain versions (autograd of the plain forwards) at the training shapes
   (R=1024 at 7x7, R=256 at 14x14, ~30% masked, and a case where 512 rois
   share a few cells, so that many sums meet in one cell): f32, bf16, masked
   rois add nothing, two runs on the same inputs (bit-equal for the
   multilevel backward, whose blocks own tiles of the gradient maps; the
   stacked one sums through atomics and its difference is printed); the
   stacked backward also against the multilevel one.
3. eval paths: the flagship CPM R-50-FPN config (81 classes, 3 CMM stages,
   ISM, RSM) with seeded random weights, bf16, uint8 images normalized on
   the device, under TPU.POOLER_KERNEL auto, then stacked, then clustered:
   batch-1 requests at 800x1344 (four under auto, two under the others) and
   one batch-2 request. Checks every request's detections and that it
   launched its backend's forward kernel 5 times (cls, three grid stages,
   rescore) and no other kernel; under stacked and clustered the detections
   of two requests must equal the auto path's. Then the kernel check of
   phase 2 is repeated on the FPN maps and rois of the five pooler calls of
   one batch-1 forward; each kernel's `ms` and `plain_ms` in the JSON line
   are their times summed.
4. reference: the port on the card against the port on the CPU (plain
   pooler) at a narrow width in f32, detections compared as masked sets.
5. training paths: `create_train_state(training_cfg(), "cuda", seed=0)` at
   the operating point the JAX package trains (batch 2 at 800x1344, up to
   32 gt per image, RPN.PRE_NMS_TOP_N_TRAIN=2000, bf16 compute on f32
   masters, uint8 images), under auto, stacked and clustered. The weights
   are random from the seed; the trunk's frozen affines are then set from
   one seeded batch's statistics
   (cpm_tpu_torch/tools/profile_train.py::fold_batch_statistics). One
   warm-up step and two timed steps, checked for losses, launches (5 forward
   and 5 backward of the backend's kernels, none of any other), gradients,
   changed and frozen parameters and the learning rate; under stacked and
   clustered the losses are held against the auto path's. Then the
   backward-kernel check of phase 2b on the gradients, rois and level shapes
   of the five pooler sites of one more step (auto and stacked; clustered
   trains through the multilevel backward kernel), two runs bit-equal under
   auto.
6. training reference: two steps of the port on the card against two on the
   CPU at a narrow width in f32, the same seed, batch and draws.
7. single-level path: no model of the port has a one-level pooler yet, so a
   `Pooler` over one C4 map is driven directly, forward and backward, and
   held against the plain version.
8. sampler kernels: the deformable-conv sampler's forward and backward
   kernels against their plain versions (`deform_sample_plain` and autograd
   of it) at the geometries of cpm_tpu_torch/tools/probe_dcn_sampler.py (res3
   104x168x256, res4 52x84x512, res5 26x42x1024, batch 2, 9 taps, coordinates
   over the map and past its border), f32 and bf16, two backward runs
   bit-equal, with the time of one `F.grid_sample` call (forward, and its
   backward to the map and the grid) on the same inputs as the library
   yardstick, and the backward's binning kernels timed on a line of their
   own.
9. cross-roi kernel: the shared-window RoIAlign at G in {1, 2, 4, 8} rois per
   window against its plain version at the shapes of
   cpm_tpu_torch/tools/probe_pooler_crossroi.py (one [2, 208, 336, 256] map,
   1024 rois, 7x7; G 1 and 4 at 14x14), beside the single-level and the
   multilevel kernel on the same inputs; no model runs this kernel, so the
   path that is driven is the wrapper the tool calls.
10. X-101 eval path: CPM X-101-32x4d-FPN-DCN (`x101_dcn_cfg()`: ResNeXt
   (3, 4, 23, 3), 32 groups of width 4, 30 deformable 3x3 convs in res3 to
   res5, the flagship's head) with seeded random weights, the offset convs
   spread from a seed (a fresh one predicts zero offsets, which would turn the
   sampler into a copy) and the trunk's frozen affines set from one batch's
   statistics, bf16: batch-1 requests at 800x1344, each checked for its
   detections and for 30 sampler launches and 5 multilevel pooler launches and
   none of any other kernel. Then the sampler check of phase 8 on the maps and
   coordinates of the 30 sampler calls of one forward; the sampler's `ms`,
   `plain_ms`, `bound_ms` and `library_ms` in the JSON line are those summed.
   And the port on the card against the port on the CPU at a tiny width.
11. X-101 training path: the same model at the training operating point (batch
   2 at 800x1344), a warm-up and two timed steps checked as phase 5 checks
   them, with 30 + 30 sampler and 5 + 5 pooler launches per step, every
   offset conv moved, and the peak memory beside the reckoned size of the
   sampled columns kept for the backward. Then the backward check of phase 8
   on what the 30 backward launches of one more step were given (two runs
   bit-equal); the sampler backward's `ms`, `plain_ms`, `bound_ms` and
   `library_ms` in the JSON line are those summed, the binning's time inside
   `ms`. Last, one step at batch 4, checked for its losses and launches, and
   the backward check on its largest site (the first res3 block's 200x336
   map, 4200 tiles an image): the binning counts its keys per image, so the
   batch is not bounded by them.

Then a JSON line of kernel results and, last, {"ok": true, "device": ...}.
Random weights give softmax scores near 1/81, below the default 0.03
threshold, so GRID_RCNN.SCORE_THRESH is set to 0.0 for phase 3.

Each kernel's `bound_ms` is the least time the card could take for the call:
the larger of its bytes over 3.35 TB/s (the level cells the rois touch, the
rois, and the output for a forward; the valid rois' gradient rows, the
rois, and every level map written once for a backward; for the clustered
forward each group's rectangle counted once, not once per roi, plus the
grouping arrays) and its f32 multiply-adds over 67 TFLOP/s. The stacked
kernels' stack copy and the clustered kernel's grouping are torch ops
outside the kernels; their times are printed on lines of their own. No
single PyTorch call computes a RoIAlign or its transpose (torchvision's is
no dependency of the port), so `library_ms` is null for the RoIAlign kernels. The
sampler's bounds (cpm_tpu_torch/tools/probe_dcn_sampler.py::sampler_bounds)
and the cross-roi kernel's (tools/probe_pooler_crossroi.py::crossroi_bound)
are made the same way; the sampler has a library call, `F.grid_sample`, and
for its backward that call's backward to the map and the grid. The backward
bounds count each gradient map written once: the tile-owned backward kernels
(multilevel and sampler) write exactly that, with no float32 accumulator.
"""

import contextlib
import json
import math
import statistics
import sys
import time

import numpy as np
import torch

SHAPES = [(200, 336), (100, 168), (50, 84), (25, 42)]
SCALES = (0.25, 0.125, 0.0625, 0.03125)
C4_SHAPE, C4_SCALE, C4_ROIS = (2, 50, 84, 1024), 0.0625, 1024
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-2
F32_ATOL = 1e-5
BWD_F32_RTOL, BWD_F32_ATOL = 1e-4, 1e-4
POOLER_SITES = ("cls 7x7", "grid stage 1 14x14", "grid stage 2 14x14",
                "grid stage 3 14x14", "rescore 7x7")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # f32 outside the tensor cores, same sheet
TRAIN_LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_grid_1",
                "loss_grid_2", "loss_grid_3", "loss_iou_3", "loss_rescore")
BACKENDS = ("auto", "stacked", "clustered")
# what disagreed with the auto path: reported where it happens, so that one
# run shows every disagreement, and raised together at the end of main
DISAGREEMENTS = []
# the nine kernels: name -> (source, the TPU kernel it replaces)
KERNELS = {
    "multilevel_roi_align": (
        "cpm_tpu_torch/csrc/multilevel_roi_align.cu", "cpm_tpu/ops/pallas/multilevel_pallas.py:480"),
    "multilevel_roi_align_backward": (
        "cpm_tpu_torch/csrc/multilevel_roi_align.cu", "cpm_tpu/ops/pallas/multilevel_pallas.py:632"),
    "clustered_roi_align": (
        "cpm_tpu_torch/csrc/clustered_roi_align.cu", "cpm_tpu/ops/pallas/clustered_pallas.py:327"),
    "stacked_roi_align": (
        "cpm_tpu_torch/csrc/stacked_roi_align.cu", "cpm_tpu/ops/pallas/stacked_pallas.py:296"),
    "stacked_roi_align_backward": (
        "cpm_tpu_torch/csrc/stacked_roi_align.cu", "cpm_tpu/ops/pallas/stacked_pallas.py:379"),
    "roi_align": (
        "cpm_tpu_torch/csrc/roi_align.cu", "cpm_tpu/ops/pallas/roi_align_pallas.py:49"),
    "deform_sample": (
        "cpm_tpu_torch/csrc/deform_sample.cu", "tools/probe_dcn_pallas_sampler.py:92"),
    # the JAX package's sampler backward is a hand-written custom_vjp of XLA ops
    "deform_sample_backward": (
        "cpm_tpu_torch/csrc/deform_sample.cu", "cpm_tpu/ops/deform_conv.py:132"),
    "crossroi_roi_align": (
        "cpm_tpu_torch/csrc/crossroi_roi_align.cu", "tools/probe_pooler_crossroi.py:37"),
}
X101_SAMPLER_CALLS = 30   # deformable 3x3 convs in res3 (4), res4 (23), res5 (3)
# the kernels that a pooler call launches under each TPU.POOLER_KERNEL value
FORWARD_KERNEL = {"auto": "multilevel_roi_align", "stacked": "stacked_roi_align",
                  "clustered": "clustered_roi_align"}
BACKWARD_KERNEL = {"auto": "multilevel_roi_align_backward",
                   "stacked": "stacked_roi_align_backward",
                   "clustered": "multilevel_roi_align_backward"}


def ops():
    """The six wrapper modules, imported when first needed."""
    from cpm_tpu_torch.ops.cuda import (
        clustered_roi_align,
        crossroi_roi_align,
        deform_sample,
        multilevel_roi_align,
        roi_align,
        stacked_roi_align,
    )

    return dict(multilevel=multilevel_roi_align, stacked=stacked_roi_align,
                clustered=clustered_roi_align, single=roi_align, deform=deform_sample,
                crossroi=crossroi_roi_align)


def launch_counts():
    """Launches of each of the nine kernels so far, as their wrappers count them."""
    m = ops()
    return {
        "deform_sample": m["deform"].KERNEL.launches,
        "deform_sample_backward": m["deform"].KERNEL.backward_launches,
        "crossroi_roi_align": m["crossroi"].KERNEL.launches,
        "multilevel_roi_align": m["multilevel"].KERNEL.launches,
        "multilevel_roi_align_backward": m["multilevel"].KERNEL.backward_launches,
        "clustered_roi_align": m["clustered"].KERNEL.launches,
        "stacked_roi_align": m["stacked"].KERNEL.launches,
        "stacked_roi_align_backward": m["stacked"].KERNEL.backward_launches,
        "roi_align": m["single"].KERNEL.launches,
    }


def reset_launch_counts():
    m = ops()
    for mod in m.values():
        mod.KERNEL.launches = 0
    for name in ("multilevel", "stacked", "deform"):
        m[name].KERNEL.backward_launches = 0


def launched_since(before):
    """The kernels launched since `before` (a `launch_counts()`), without zeros."""
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}


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


def bound_of(nbytes, flops):
    """(bound ms, 'bytes' or 'operations') of a call that must move nbytes
    and do flops f32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def touched_cells(shapes, rois, levels, valid, pool, scales):
    """How many level cells the valid rois read: those that receive a
    non-zero gradient from an all-ones output gradient, counted with the
    plain backward at C=1."""
    from cpm_tpu_torch.ops.cuda.multilevel_roi_align import plain_multilevel_roi_align_backward

    ones = torch.ones((rois.shape[0], *pool, 1), device=rois.device)
    touched = plain_multilevel_roi_align_backward(
        [(*s[:3], 1) for s in shapes], rois, levels, valid, ones, scales, 2)
    return sum(int((t != 0).sum()) for t in touched)


def roi_align_bounds(shapes, rois, levels, valid, pool, elem_size, scales=SCALES):
    """(forward bound ms, backward bound ms, 'bytes' or 'operations' each)
    for one call on these inputs, as the module docstring sets out."""
    channels = shapes[0][3]
    cells = touched_cells(shapes, rois, levels, valid, pool, scales)
    n, n_valid = rois.shape[0], int(valid.sum())
    bins = pool[0] * pool[1]
    roi_bytes = n * (5 * 4 + 4 + 1)
    out_bytes = n * bins * channels * elem_size
    fwd_bytes = cells * channels * elem_size + roi_bytes + out_bytes
    map_bytes = sum(s[0] * s[1] * s[2] for s in shapes) * channels * elem_size
    bwd_bytes = n_valid * bins * channels * elem_size + roi_bytes + map_bytes
    flops = n_valid * bins * 4 * 4 * channels * 2  # samples x cells x (mul, add)
    return bound_of(fwd_bytes, flops), bound_of(bwd_bytes, flops)


def clustered_bound(shapes, rois, levels, valid, pool, elem_size, grouping):
    """The clustered forward's bound: every group's rectangle read once (a
    singleton whose rectangle exceeds the tile reads the cells it touches),
    the rois, the grouping arrays, and the output written once."""
    from cpm_tpu_torch.ops.roi_align import TILE

    channels = shapes[0][3]
    g = grouping.groups.long()
    fits = (g[:, 6] <= TILE) & (g[:, 7] <= TILE)
    cells = int((g[:, 6] * g[:, 7])[fits & (g[:, 1] > 0)].sum())
    # the members of the groups beyond the tile: all singletons
    big = torch.zeros_like(valid)
    big[grouping.order.long()[g[~fits & (g[:, 1] > 0), 0]]] = True
    if big.any():
        cells += touched_cells(shapes, rois, levels, big, pool, SCALES)
    n, n_valid = rois.shape[0], int(valid.sum())
    bins = pool[0] * pool[1]
    nbytes = (cells * channels * elem_size + n * (5 * 4 + 1) + n * 4 + n * 8 * 4
              + n * bins * channels * elem_size)
    return bound_of(nbytes, n_valid * bins * 4 * 4 * channels * 2)


def group_histogram(grouping):
    """'size:count' of the groups' sizes, and the largest rectangle."""
    g = grouping.groups.cpu().numpy()
    sizes = g[g[:, 1] > 0, 1]
    hist = " ".join(f"{k}:{v}" for k, v in enumerate(np.bincount(sizes)) if v)
    return (f"{len(sizes)} groups of {int(sizes.sum())} rois, size:count {hist}, mean "
            f"{sizes.mean():.2f}, largest rectangle {int(g[:, 6].max())}x{int(g[:, 7].max())} cells")


def forward_impl(impl, features, rois, levels, valid, pool):
    """(run kernel, run plain, extra) for one forward formulation on these
    inputs. The stacked kernel runs on a stack made beforehand and the
    clustered one on a grouping made beforehand; `extra` names what that
    preparation (torch ops outside the kernel) costs."""
    from cpm_tpu_torch.ops import roi_align as plain

    m = ops()
    mask = valid[:, None, None, None]
    if impl == "multilevel":
        return (lambda fs: m["multilevel"].KERNEL(fs, rois, levels, valid, pool, SCALES, 2),
                lambda fs: plain.multilevel_roi_align(fs, rois, levels, pool, SCALES, 2)
                * mask.to(fs[0].dtype), None)
    level_hw = [tuple(f.shape[1:3]) for f in features]
    if impl == "stacked":
        stacks = {}

        def kernel(fs):
            key = fs[0].dtype
            if key not in stacks:
                stacks[key] = plain.stack_levels(fs)
            return m["stacked"].KERNEL(stacks[key], level_hw, rois, levels, valid, pool, SCALES, 2)

        def extra(fs):
            ms = cuda_ms(lambda: plain.stack_levels(fs))
            return f"stack copy (pad and cat, torch ops) {ms:.4f} ms"

        return (kernel, lambda fs: plain.multilevel_roi_align_stacked_plain(
            fs, rois, levels, pool, SCALES, 2) * mask.to(fs[0].dtype), extra)
    if impl == "clustered":
        def cluster():
            return plain.cluster_rois(rois, levels, valid, level_hw, features[0].shape[0], pool,
                                      SCALES, 2)

        grouping = cluster()

        def extra(fs):
            return (f"grouping (cluster_rois, torch ops) {cuda_ms(cluster):.4f} ms; "
                    f"{group_histogram(grouping)}")

        return (lambda fs: m["clustered"].KERNEL(fs, rois, levels, valid, pool, SCALES, 2,
                                                 grouping=grouping),
                lambda fs: plain.multilevel_roi_align_clustered_plain(
                    fs, rois, levels, valid, pool, SCALES, 2, grouping=grouping), extra)
    raise ValueError(impl)


def check_kernel(name, features, rois, levels, valid, pool, card, rescale=False, impl="multilevel"):
    """One forward kernel vs its plain version, f32 and bf16, on the same
    inputs; the stacked and clustered kernels also vs the multilevel kernel.
    Returns a dict of the f32 max error and the bf16 times and bound.

    rescale: first scale the maps by the power of two that brings their
    largest magnitude to at most 1. The scaling is exact in f32 and bf16 and
    RoIAlign is linear, so atol 1e-5 then bounds the error relative to the
    maps' magnitude (random-weight FPN maps reach the thousands)."""
    if rescale:
        peak = max(f.float().abs().max().item() for f in features)
        exp = max(0, math.ceil(math.log2(peak))) if peak > 0 else 0
        features = [f * 2.0 ** -exp for f in features]
        name = f"{name} (maps scaled by 2^-{exp}, max |map| {peak:.4g})"
    name = f"{impl} {name}"
    kernel, plain, extra = forward_impl(impl, features, rois, levels, valid, pool)
    other = forward_impl("multilevel", features, rois, levels, valid, pool)[0]
    f32 = [f.float().contiguous() for f in features]
    got = kernel(f32)
    want = plain(f32)
    torch.cuda.synchronize()
    err32 = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or err32 > F32_ATOL:
        raise AssertionError(f"{name}: f32 kernel vs plain max |err| {err32} > {F32_ATOL}")
    if got[~valid].any():
        raise AssertionError(f"{name}: a masked roi's row is not zero")
    vs_multilevel = (got - other(f32)).abs().max().item()
    if vs_multilevel > F32_ATOL:
        raise AssertionError(f"{name}: differs from the multilevel kernel by {vs_multilevel}")

    bf = [f.to(torch.bfloat16).contiguous() for f in features]
    got = kernel(bf).float()
    want = plain([f.float() for f in bf]).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    err16 = (got - want).abs().max().item()
    bad = ((got - want).abs() > BF16_ATOL + BF16_RTOL * want.abs()).sum().item()
    if bad:
        raise AssertionError(f"{name}: bf16 {bad} elements beyond rtol {BF16_RTOL} atol {BF16_ATOL}")
    del got, want

    ms = cuda_ms(lambda: kernel(bf))
    plain_ms = cuda_ms(lambda: plain(bf), reps=5)
    shapes = [tuple(f.shape) for f in bf]
    if impl == "clustered":
        from cpm_tpu_torch.ops.roi_align import cluster_rois

        grouping = cluster_rois(rois, levels, valid, [s[1:3] for s in shapes], shapes[0][0], pool,
                                SCALES, 2)
        bound_ms, bound_by = clustered_bound(shapes, rois, levels, valid, pool, 2, grouping)
    else:
        (bound_ms, bound_by), _ = roi_align_bounds(shapes, rois, levels, valid, pool, 2)
    print(
        f"[kernel] {name}: R={rois.shape[0]} pool={pool} valid={int(valid.sum())} "
        f"f32 max|err|={err32:.3g} (atol {F32_ATOL}) vs multilevel kernel {vs_multilevel:.3g} "
        f"bf16 max|err|={err16:.3g} (rtol {BF16_RTOL}, atol {BF16_ATOL}) bf16 kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) | {card}"
    )
    if extra is not None:
        print(f"[kernel] {name}: {extra(bf)} | {card}")
    return dict(err=err32, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_backward_kernel(name, shapes, rois, levels, valid, g, card, rescale=False,
                          impl="multilevel"):
    """One backward kernel ('multilevel' or 'stacked') vs its plain version
    (autograd of its plain forward) on the same inputs: f32 (TF32 plays no
    part: neither side multiplies matrices), bf16, masked rois, two runs;
    the stacked kernel also vs the multilevel one. Returns a dict of the f32
    max error and the bf16 times and bound.

    Tolerances. f32: rtol 1e-4 / atol 1e-4, the JAX package's own for its
    backward kernels; both sides sum each cell's terms in f32 in another
    order (the stacked kernel's atomics in an order that changes from run to
    run; the multilevel kernel's in one fixed order).
    bf16: the kernel sums in f32 and rounds once, the plain version is the
    f32 gradient of the same bf16 `g` rounded to bf16, so they differ by at
    most one bf16 rounding: rtol 1.6e-2 / atol 1e-2.
    rescale: first scale `g` by the power of two that brings its largest
    magnitude to at most 1 (exact, and the backward is linear in `g`)."""
    m = ops()
    mod = m[impl]
    kernel = mod.KERNEL.backward
    plain = (mod.plain_multilevel_roi_align_backward if impl == "multilevel"
             else mod.plain_stacked_roi_align_backward)
    name = f"{impl} {name}"

    pool = tuple(g.shape[1:3])
    if rescale:
        peak = g.float().abs().max().item()
        exp = math.ceil(math.log2(peak)) if peak > 0 else 0
        g = g * 2.0 ** -exp
        name = f"{name} (g scaled by 2^{-exp}, max |g| {peak:.4g})"
    g32 = g.float().contiguous()
    got = kernel(shapes, rois, levels, valid, g32, SCALES, 2)
    want = plain(shapes, rois, levels, valid, g32, SCALES, 2)
    torch.cuda.synchronize()

    def worst(a_list, b_list, what):
        out = 0.0
        for a, b in zip(a_list, b_list):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name}: non-finite f32 gradient")
            d = (a - b).abs()
            out = max(out, d.max().item())
            bad = (d > BWD_F32_ATOL + BWD_F32_RTOL * b.abs()).sum().item()
            if bad:
                raise AssertionError(
                    f"{name}: f32 backward vs {what}, {bad} cells beyond rtol {BWD_F32_RTOL} "
                    f"atol {BWD_F32_ATOL}, max |err| {d.max().item()}")
        return out

    err32 = worst(got, want, "plain")
    vs_multilevel = worst(got, m["multilevel"].KERNEL.backward(
        shapes, rois, levels, valid, g32, SCALES, 2), "the multilevel kernel")
    # masked rois add nothing: the same gradient with them removed
    kept = kernel(shapes, rois[valid].contiguous(), levels[valid].contiguous(),
                  torch.ones_like(valid[valid]), g32[valid].contiguous(), SCALES, 2)
    err_masked = worst(got, kept, "the call without the masked rois")
    again = kernel(shapes, rois, levels, valid, g32, SCALES, 2)
    if impl == "multilevel":
        # the tile-owned backward sums every cell in one fixed order
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two backward runs on the same inputs differ")
        rerun = "two runs bit-equal"
    else:
        rerun = f"two-runs max|diff|={max((a - b).abs().max().item() for a, b in zip(got, again)):.3g}"

    g16 = g.to(torch.bfloat16).contiguous()
    got16 = kernel(shapes, rois, levels, valid, g16, SCALES, 2)
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

    ms = cuda_ms(lambda: kernel(shapes, rois, levels, valid, g16, SCALES, 2))
    plain_ms = cuda_ms(lambda: plain(shapes, rois, levels, valid, g16, SCALES, 2), reps=3)
    _, (bound_ms, bound_by) = roi_align_bounds(shapes, rois, levels, valid, pool, 2)
    print(
        f"[bwd kernel] {name}: R={rois.shape[0]} pool={pool} valid={int(valid.sum())} "
        f"f32 max|err|={err32:.3g} (rtol {BWD_F32_RTOL}, atol {BWD_F32_ATOL}) "
        f"vs multilevel kernel {vs_multilevel:.3g} "
        f"masked-removed max|diff|={err_masked:.3g} {rerun} "
        f"bf16 max|err|={err16:.3g} (rtol {BF16_RTOL}, atol {BF16_ATOL}) "
        f"bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}) | {card}"
    )
    return dict(err=err32, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


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


def dense_rois(n, rng, dev):
    """[n, 5] rois that crowd around 24 objects of all sizes, as proposals
    crowd around what an image shows: jittered copies of 24 boxes, ~30%
    masked, so that many rois share cells and multi-roi groups form."""
    k = 24
    side = np.exp(rng.uniform(np.log(24), np.log(500), k))
    aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), k))
    w, h = side * np.sqrt(aspect), side / np.sqrt(aspect)
    x1, y1 = rng.uniform(0, 1344 - w), rng.uniform(0, 800 - h)
    base = np.stack([rng.randint(0, 2, k), x1, y1, x1 + w, y1 + h], 1)
    pick = rng.randint(0, k, n)
    jitter = rng.uniform(-0.08, 0.08, (n, 4)) * np.stack([w, h, w, h], 1)[pick]
    rois = base[pick]
    rois[:, 1:] += jitter
    valid = rng.rand(n) > 0.3
    return torch.from_numpy(rois.astype(np.float32)).to(dev), torch.from_numpy(valid).to(dev)


def phase_kernel(dev, rng, card):
    """Phase 2: {impl: [result, ...]} of the synthetic forward checks."""
    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    feats = [torch.randn(2, h, w, 256, generator=torch.Generator().manual_seed(i)).to(dev)
             for i, (h, w) in enumerate(SHAPES)]
    cases = []
    for n, pool in ((2000, (7, 7)), (600, (14, 14))):
        for kind, make in (("synthetic", synthetic_rois), ("dense", dense_rois)):
            rois, valid = make(n, rng, dev)
            levels = assign_fpn_levels(rois[:, 1:5], 2, 5) - 2
            cases.append((f"{kind} {pool[0]}x{pool[1]}", rois, levels, valid, pool))
    return {
        impl: [check_kernel(name, feats, rois, levels, valid, pool, card, impl=impl)
               for name, rois, levels, valid, pool in cases]
        for impl in ("multilevel", "stacked", "clustered")
    }


def phase_backward_kernel(dev, rng, card):
    """Phase 2b: {impl: [result, ...]} of the synthetic backward checks."""
    from cpm_tpu_torch.ops.pooler import assign_fpn_levels

    shapes = [(2, h, w, 256) for h, w in SHAPES]
    cases = []
    for name, n, pool, collide in (("synthetic 7x7", 1024, (7, 7), False),
                                   ("synthetic 14x14", 256, (14, 14), False),
                                   ("colliding 7x7", 512, (7, 7), True)):
        rois, valid = synthetic_rois(n, rng, dev)
        if collide:
            # every roi a jittered copy of one small box: they share a few cells
            base = torch.tensor([0.0, 400.0, 300.0, 430.0, 326.0], device=dev)
            rois = base + torch.from_numpy(rng.uniform(-2, 2, (n, 5)).astype(np.float32)).to(dev)
            rois[:, 0] = 0.0
        levels = assign_fpn_levels(rois[:, 1:5], 2, 5) - 2
        g = torch.randn(n, *pool, 256, generator=torch.Generator().manual_seed(n)).to(dev)
        cases.append((name, rois, levels, valid, g))
    return {
        impl: [check_backward_kernel(name, shapes, rois, levels, valid, g, card, impl=impl)
               for name, rois, levels, valid, g in cases]
        for impl in ("multilevel", "stacked")
    }


def phase_single_level(dev, rng, card):
    """Phases 2 and 7 for the single-level kernel at the C4 shape: the kernel
    against its plain version, then a one-level `Pooler` driven forward and
    backward, which is the path that reaches this kernel."""
    from cpm_tpu_torch.ops.pooler import Pooler
    from cpm_tpu_torch.ops.roi_align import roi_align as plain

    m = ops()
    feats = torch.randn(C4_SHAPE, generator=torch.Generator().manual_seed(4)).to(dev)
    rois, valid = synthetic_rois(C4_ROIS, rng, dev)
    zeros = torch.zeros(C4_ROIS, dtype=torch.int32, device=dev)
    everyone = torch.ones(C4_ROIS, dtype=torch.bool, device=dev)

    def chunked_plain(pool):
        # 256 rois at a time: one gather of the plain version holds
        # [rois, 2*ph, 2*pw, 1024] floats
        return torch.cat([plain(feats, r, pool, C4_SCALE, 2) for r in rois.split(256)])

    results = []
    for pool in ((7, 7), (14, 14)):
        got = m["single"].KERNEL(feats, rois, pool, C4_SCALE, 2)
        want = chunked_plain(pool)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.isfinite(got).all() or err > F32_ATOL:
            raise AssertionError(f"single-level {pool}: f32 kernel vs plain max |err| {err}")
        del got, want
        ms = cuda_ms(lambda: m["single"].KERNEL(feats, rois, pool, C4_SCALE, 2))
        plain_ms = cuda_ms(lambda: chunked_plain(pool), reps=3)
        (bound_ms, bound_by), _ = roi_align_bounds(
            [C4_SHAPE], rois, zeros, everyone, pool, 4, scales=(C4_SCALE,))
        print(f"[kernel] single-level C4 {pool[0]}x{pool[1]}: map {C4_SHAPE} f32 R={C4_ROIS} "
              f"max|err|={err:.3g} (atol {F32_ATOL}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(in chunks of 256 rois), bound {bound_ms:.4f} ms ({bound_by}) | {card}")
        results.append(dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))

    # the path: a Pooler over this one level, bf16 map as a C4 model would
    # hand it over, forward and backward
    pooler = Pooler((7, 7), (C4_SCALE,), 2)
    half = feats.to(torch.bfloat16).requires_grad_()
    reset_launch_counts()
    before = launch_counts()
    pooled = pooler([half], rois, valid)
    (pooled.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    launched = launched_since(before)
    if launched != {"roi_align": 1, "multilevel_roi_align_backward": 1}:
        raise AssertionError(f"one-level Pooler launched {launched}")
    want = plain(half.detach().float(), rois, (7, 7), C4_SCALE, 2).to(torch.bfloat16)
    want = want * valid[:, None, None, None]
    bad = ((pooled.float() - want.float()).abs() > BF16_ATOL + BF16_RTOL * want.float().abs()).sum()
    if pooled.dtype != torch.bfloat16 or bad.item() or pooled[~valid].any():
        raise AssertionError(f"one-level Pooler: {bad.item()} elements differ from the plain version")
    if half.grad is None or not torch.isfinite(half.grad).all() or not half.grad.any():
        raise AssertionError("one-level Pooler: no finite gradient reached the map")
    # the gradient through the op (forward kernel, multilevel backward kernel
    # at one level) against autograd of the plain version, f32, 256 rois
    few = rois[:256].contiguous()
    g = torch.randn(len(few), 7, 7, C4_SHAPE[3], generator=torch.Generator().manual_seed(5)).to(dev)
    grads = []
    for fn in (m["single"].roi_align_cuda, plain):
        f = feats.clone().requires_grad_()
        (fn(f, few, (7, 7), C4_SCALE, 2) * g).sum().backward()
        grads.append(f.grad)
    d = (grads[0] - grads[1]).abs()
    if (d > BWD_F32_ATOL + BWD_F32_RTOL * grads[1].abs()).any():
        raise AssertionError(f"single-level gradient differs from the plain one by {d.max().item()}")
    print(f"[single-level path] gradient of {len(few)} rois vs autograd of the plain version: "
          f"max |diff| {d.max().item():.3g} (rtol {BWD_F32_RTOL}, atol {BWD_F32_ATOL})")
    print(f"[single-level path] Pooler over one C4 level, bf16 map {C4_SHAPE}, R={C4_ROIS} "
          f"({int(valid.sum())} valid), 7x7: matches the plain version (rtol {BF16_RTOL}, atol "
          f"{BF16_ATOL}), masked rows zero, gradient finite; launches {launched}")
    # the JSON line's times are those of the path's shape, 7x7
    return dict(results[0], launches=launched["roi_align"], err=max(r["err"] for r in results))


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


def same_detections(got, want, what):
    """Raise unless two `Detections` hold the same masked sets: counts and
    labels exactly, boxes to 1e-2 px and scores to 1e-4 (the pooling kernels
    of all backends sum in the same order, so the sets are expected equal)."""
    for i in range(want.mask.shape[0]):
        wm, gm = want.mask[i].cpu(), got.mask[i].cpu()
        if wm.sum() != gm.sum():
            raise AssertionError(f"{what} image {i}: {int(gm.sum())} vs {int(wm.sum())} detections")
        have = list(zip(got.labels[i].cpu()[gm].tolist(), got.boxes[i].float().cpu()[gm].tolist(),
                        got.scores[i].float().cpu()[gm].tolist()))
        # one-to-one: each wanted detection pairs with an unused one of the
        # same label within the tolerances
        for lw, bw, sw in zip(want.labels[i].cpu()[wm].tolist(),
                              want.boxes[i].float().cpu()[wm].tolist(),
                              want.scores[i].float().cpu()[wm].tolist()):
            for j, (lh, bh, sh) in enumerate(have):
                if lh == lw and max(abs(a - b) for a, b in zip(bw, bh)) <= 1e-2 and abs(sw - sh) <= 1e-4:
                    del have[j]
                    break
            else:
                near = min((max(abs(a - b) for a, b in zip(bw, bh)), abs(sw - sh))
                           for lh, bh, sh in have if lh == lw) if any(h[0] == lw for h in have) else None
                raise AssertionError(
                    f"{what} image {i}: no detection matches ({lw}, {bw}, {sw}); nearest of its "
                    f"label (box diff px, score diff): {near}; {len(have)} left unmatched")


@contextlib.contextmanager
def capture_calls(owner, name, keep):
    """While open, every call of `owner.name` first appends keep(*args) to
    the list this yields."""
    calls, real = [], getattr(owner, name)

    def wrapper(*args, **kwargs):
        calls.append(keep(*args))
        return real(*args, **kwargs)

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def phase_eval(dev, card, backend, n_batch1, reference):
    """Phase 3 under one TPU.POOLER_KERNEL value. `reference` holds the auto
    path's detections of the two compared requests ({} while auto itself
    runs, which fills it). Returns the forward kernel's launches and its
    check at the five pooler sites."""
    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.ops.pooler import get_pooler_backend
    from cpm_tpu_torch.tools.profile_eval import make_request

    tag = f"[eval {backend}]"
    rng = np.random.RandomState(0)  # the same requests under every backend
    cfg = flagship_cfg()
    cfg.TPU.POOLER_KERNEL = backend
    cfg.GRID_RCNN.SCORE_THRESH = 0.0
    print(f"{tag} GRID_RCNN.SCORE_THRESH set to 0.0 (random weights score near 1/81)")
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=0)
    if get_pooler_backend() != backend:
        raise AssertionError(f"build_model left the pooler backend at {get_pooler_backend()}")
    forward = make_forward_fn(cfg, model)
    print(f"{tag} model built in {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters, {cfg.TPU.COMPUTE_DTYPE}")
    nc, max_dets = cfg.MODEL.NUM_CLASSES, cfg.GRID_RCNN.TEST_MAX_DETECTIONS

    # cuDNN plans each new conv shape on first use: warm both batch shapes
    forward(*make_request(rng, [(800, 1333)]))
    forward(*make_request(rng, [(800, 1344), (800, 1344)]))
    torch.cuda.synchronize()
    print(f"{tag} warm-up: one batch-1 and one batch-2 request (untimed, uncounted)")

    # all five are made under every backend, so that the compared ones (the
    # first and the batch-2 request) hold the same images
    batch1 = [[(800, 1333)], [(800, 1067)], [(800, 1200)], [(750, 1344)]]
    requests = [make_request(rng, hw) for hw in batch1]
    requests = requests[:n_batch1] + [make_request(rng, [(800, 1333), (800, 1067)])]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    want_launches = {FORWARD_KERNEL[backend]: 5}
    latencies = []
    for i, (images, sizes) in enumerate(requests):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = forward(images, sizes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        latencies.append(dt)
        launched = launched_since(before)
        counts = check_detections(dets, sizes, images.shape[0], nc, max_dets)
        if launched != want_launches:
            raise AssertionError(f"{tag} request {i}: launched {launched}, want {want_launches}")
        compared = ""
        if i in (0, len(requests) - 1):
            key = "batch 1" if i == 0 else "batch 2"
            if backend == "auto":
                reference[key] = dets
            else:
                try:
                    same_detections(dets, reference[key], f"{tag} request {i} vs auto")
                    compared = "; detections equal the auto path's (boxes 1e-2 px, scores 1e-4)"
                except AssertionError as e:
                    DISAGREEMENTS.append(str(e))
                    compared = f"; DISAGREES with the auto path: {e}"
        print(f"{tag} request {i}: batch {images.shape[0]} sizes {sizes.tolist()} "
              f"{dt * 1e3:.1f} ms, valid detections {counts}, launches {launched}{compared}")
    launches = launch_counts()[FORWARD_KERNEL[backend]]
    peak = torch.cuda.max_memory_allocated()
    lat1 = statistics.median(latencies[:-1]) * 1e3
    print(f"{tag} batch-1 median latency {lat1:.2f} ms over {n_batch1} requests | {card}")
    print(f"{tag} batch-2 throughput {2 / latencies[-1]:.2f} img/s ({latencies[-1] * 1e3:.1f} ms) | {card}")
    print(f"{tag} peak device memory {peak / 2**20:.1f} MiB (max_memory_allocated) | {card}")
    print(f"{tag} launches of {FORWARD_KERNEL[backend]} in this run: {launches} over "
          f"{len(requests)} forwards")

    # after the timed run, so that the copies do not count in its peak memory:
    # one more batch-1 request, capturing the inputs of its five pooler calls
    impl = "multilevel" if backend == "auto" else backend
    op_name = {"multilevel": "multilevel_roi_align", "stacked": "multilevel_roi_align_stacked",
               "clustered": "multilevel_roi_align_clustered"}[impl]

    def keep(features, rois, levels, valid, output_size, *_):
        return ([f.clone() for f in features], rois.clone(), levels.clone(), valid.clone(),
                tuple(output_size))

    with capture_calls(ops()[impl], op_name, keep) as captured:
        forward(*requests[0])
        torch.cuda.synchronize()
    if len(captured) != len(POOLER_SITES):
        raise AssertionError(f"{tag} {len(captured)} pooler calls in one forward, want 5")
    del model, forward
    results = [
        check_kernel(f"eval-path {site}", *call, card, rescale=True, impl=impl)
        for site, call in zip(POOLER_SITES, captured)
    ]
    return summed(results, launches, f"[kernel] {impl}: the 5 pooler calls of one batch-1 forward", card)


def summed(results, launches, what, card):
    """The sites' results as one: times and bounds summed (the library call's
    too, where the sites have one), the largest error."""
    out = dict(
        launches=launches, err=max(r["err"] for r in results),
        bound_by=max(results, key=lambda r: r["bound_ms"])["bound_by"],
        **{k: sum(r[k] for r in results) for k in ("ms", "plain_ms", "bound_ms")},
    )
    lib = ""
    if results[0].get("library_ms") is not None:
        out["library_ms"] = sum(r["library_ms"] for r in results)
        lib = f", library call {out['library_ms']:.4f} ms"
    print(f"{what}: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms{lib}, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}) (bf16, median CUDA-event times summed) "
          f"| {card}")
    return out


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


def phase_train(dev, card, backend, reference, config="flagship"):
    """Phase 5 under one TPU.POOLER_KERNEL value, and phase 11 (config
    'x101_dcn', under auto). `reference` holds the auto path's losses per step
    ([] while auto itself runs, which fills it; None: nothing to hold
    against). Returns the launches of the backend's forward and backward
    kernels and, for auto and stacked, the backward kernel's check at the five
    sites; for x101_dcn the sampler's launches and its backward kernel's check
    at the 30 sites instead."""
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.ops.pooler import get_pooler_backend
    from cpm_tpu_torch.solver.lr_schedule import make_lr_fn
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.tools.profile_train import (
        fold_batch_statistics,
        spread_offset_convs,
        training_cfg,
    )

    deformable = config == "x101_dcn"
    tag = f"[train {config}]" if deformable else f"[train {backend}]"
    fwd_kernel, bwd_kernel = FORWARD_KERNEL[backend], BACKWARD_KERNEL[backend]
    cfg = training_cfg(config)
    cfg.TPU.POOLER_KERNEL = backend
    t0 = time.perf_counter()
    model, optimizer, state = create_train_state(cfg, dev, seed=0)
    if deformable:
        n_spread = spread_offset_convs(model, seed=1)
        if n_spread != X101_SAMPLER_CALLS:
            raise AssertionError(f"{n_spread} deformable convs, want {X101_SAMPLER_CALLS}")
        print(f"{tag} {n_spread} offset convs drawn from a seed (offsets of about +-2 cells; "
              f"fresh ones are zero and would turn the sampler into a copy)")
    if get_pooler_backend() != backend:
        raise AssertionError(f"build_model left the pooler backend at {get_pooler_backend()}")
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
    print(f"{tag} {n_folded} frozen trunk affines set from the statistics of one seeded batch "
          f"(folded BatchNorm, as a pretrained trunk has; unit affines diverge in two steps)")
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    print(f"{tag} state built in {time.perf_counter() - t0:.2f} s: "
          f"{sum(p.numel() for p in model.parameters())} parameters, {len(frozen)} frozen tensors, "
          f"{cfg.TPU.COMPUTE_DTYPE} compute on f32 masters, SGD momentum {cfg.SOLVER.MOMENTUM} "
          f"wd {cfg.SOLVER.WEIGHT_DECAY}, groups {[g['name'] for g in optimizer.param_groups]}; "
          f"grid towers run on the valid prefix rounded up to TPU.TOWER_BUCKETS "
          f"{tuple(cfg.TPU.TOWER_BUCKETS)} or the cap")

    def losses_of(metrics):
        return {k: float(metrics[k]) for k in TRAIN_LOSSES}

    def held_against_auto(step, losses, rel, names=TRAIN_LOSSES):
        """The named losses of this step against the auto path's, or record them."""
        losses = dict(losses, total_loss=sum(losses.values()))
        if reference is None:
            return ""
        if backend == "auto":
            reference.append(losses)
            return ""
        want = reference[step]
        worst = max(abs(losses[k] - want[k]) / abs(want[k]) for k in names)
        if worst > rel:
            DISAGREEMENTS.append(f"{tag} step {step}: losses {losses} differ from the auto "
                                 f"path's {want} by {worst:.3g} relative, beyond {rel}")
            return f"; DISAGREES with the auto path: {DISAGREEMENTS[-1]}"
        return (f"; {'total_loss' if len(names) == 1 else 'each loss'} within {worst:.2g} "
                f"relative of the auto path's (bound {rel})")

    # the warm-up step starts from the same weights, batch and draws under
    # every backend and the forward kernels sum in the same order, so each of
    # its losses agrees to 1e-4; from then on the parameters differ by the
    # stacked backward's atomics and cuDNN's sums, whose order changes, which
    # bf16 training amplifies, and the total loss is held to 0.1 relative
    state, metrics = step_fn(state, batch_for(100))
    torch.cuda.synchronize()
    note = held_against_auto(0, losses_of(metrics), 1e-4)
    print(f"{tag} warm-up: one step (untimed, uncounted), total_loss "
          f"{float(metrics['total_loss']):.4f}{note}")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    want_launches = {fwd_kernel: 5, bwd_kernel: 5}
    if deformable:
        want_launches.update(deform_sample=X101_SAMPLER_CALLS,
                             deform_sample_backward=X101_SAMPLER_CALLS)
    offset_convs = {k for k in labels if ".conv_offset." in k}
    times = []
    for i in range(2):
        batch = batch_for(101 + i)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        counts0, step0 = launch_counts(), state.step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses = losses_of(metrics)
        if set(metrics) != set(TRAIN_LOSSES) | {"total_loss", "lr"}:
            raise AssertionError(f"step {i}: metrics {sorted(metrics)}")
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"step {i}: non-finite loss {losses}")
        total = float(metrics["total_loss"])
        if abs(total - sum(losses.values())) > 1e-4 * abs(total):
            raise AssertionError(f"step {i}: total_loss {total} != sum {sum(losses.values())}")
        launched = launched_since(counts0)
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
        if offset_convs - changed:
            raise AssertionError(f"step {i}: offset convs unchanged: {sorted(offset_convs - changed)}")
        if launched != want_launches:
            raise AssertionError(f"step {i}: launched {launched}, want {want_launches}")
        note = held_against_auto(i + 1, losses, 0.1, names=("total_loss",))
        print(f"{tag} step {i} (update {step0}): {times[-1] * 1e3:.1f} ms, lr {metrics['lr']:.6g} "
              f"(schedule {lr_fn(step0):.6g}), total_loss {total:.4f}, "
              + ", ".join(f"{k[5:]} {v:.4f}" for k, v in losses.items())
              + f"; launches {launched}; "
              f"{len(changed)} tensors changed, {len(frozen)} frozen bit-equal{note}")
        del before
    counts = launch_counts()
    launches = (counts[fwd_kernel], counts[bwd_kernel])
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} step times {times[0] * 1e3:.1f} and {times[1] * 1e3:.1f} ms, "
          f"batch 2 at 800x1344 | {card}")
    print(f"{tag} peak device memory {peak / 2**20:.1f} MiB (max_memory_allocated) | {card}")
    print(f"{tag} launches in the 2 steps: {fwd_kernel} {launches[0]}, {bwd_kernel} {launches[1]}")
    if backend == "clustered":
        # its backward is the multilevel kernel, checked under auto
        return dict(launches=launches)
    if deformable:
        print(f"{tag} launches in the 2 steps: deform_sample {counts['deform_sample']}, "
              f"deform_sample_backward {counts['deform_sample_backward']}; "
              f"{len(offset_convs)} offset-conv tensors changed in every step")
        out = sampler_backward_sites(
            tag, lambda: step_fn(state, batch_for(104)), card, pooler_launches=launches,
            launches=(counts["deform_sample"], counts["deform_sample_backward"]))
        wide_batch_step(tag, step_fn, state, cfg, want_launches, card)
        return out

    # after the timed run: one more step, capturing what the five backward
    # launches were given
    impl = "multilevel" if backend == "auto" else backend

    def keep(shapes, rois, levels, valid, g, *_):
        return ([tuple(s) for s in shapes], rois.clone(), levels.clone(), valid.clone(), g.clone())

    with capture_calls(ops()[impl].KERNEL, "backward", keep) as captured:
        state, _ = step_fn(state, batch_for(104))
        torch.cuda.synchronize()
    if len(captured) != len(POOLER_SITES):
        raise AssertionError(f"{len(captured)} backward launches in one step, want 5")
    del start, model, optimizer, state, step_fn
    # autograd runs the sites backwards: rescore first, cls last
    results = [
        check_backward_kernel(f"train-step {site}", *call, card, rescale=True, impl=impl)
        for site, call in zip(POOLER_SITES, reversed(captured))
    ]
    return summed(results, launches,
                  f"[bwd kernel] {impl}: the 5 backward calls of one training step", card)


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


def unit_scale(t):
    """(t scaled by the power of two that brings its largest magnitude into
    (1/2, 1], the exponent): exact in f32 and bf16, up as well as down (the
    gradients that reach the sampler are of the order 1e-6), and the sampler
    is linear in the map and in `g`, so the absolute tolerances then hold
    relative to the tensor's magnitude."""
    peak = t.float().abs().max().item()
    exp = math.ceil(math.log2(peak)) if peak > 0 else 0
    return t * 2.0 ** -exp, exp


def phase_sampler_kernels(dev, card):
    """Phase 8: the sampler's forward and backward kernels at the probe's three
    geometries, f32 and bf16."""
    from cpm_tpu_torch.tools.probe_dcn_sampler import run_geometries

    return run_geometries([torch.float32, torch.bfloat16], dev, card, reps=10)


def sampler_forward_sites(tag, run_forward, card):
    """The sampler's forward kernel against its plain version on the map and
    coordinates of every sampler call of run_forward(): f32 (the map scaled to
    unit magnitude) and bf16, the latter timed. Returns the sites' summed
    result."""
    from cpm_tpu_torch.tools.probe_dcn_sampler import check_forward

    def keep(feat, ys, xs):
        return feat.detach().clone(), ys.detach().clone(), xs.detach().clone()

    with capture_calls(ops()["deform"], "deform_sample_cuda", keep) as captured:
        run_forward()
        torch.cuda.synchronize()
    if len(captured) != X101_SAMPLER_CALLS:
        raise AssertionError(f"{tag} {len(captured)} sampler calls in one forward, want "
                             f"{X101_SAMPLER_CALLS}")
    moved = [float(((ys - ys.round()).abs() > 1e-3).float().mean()) for _, ys, _ in captured]
    if min(moved) < 0.5:
        raise AssertionError(f"{tag} a sampler call has most samples on whole cells: {moved}")
    results = []
    for i, (feat, ys, xs) in enumerate(captured):
        feat, exp = unit_scale(feat)
        name = f"site {i} map {tuple(feat.shape)} x 2^{-exp}"
        err32 = check_forward(name, feat.float().contiguous(), ys, xs, card, timed=False)["err"]
        res = check_forward(name, feat.contiguous(), ys, xs, card, reps=10)
        results.append(dict(res, err=err32))
    return summed(results, None, f"[kernel] deform_sample: the {len(results)} sampler calls of one "
                  f"batch-{captured[0][0].shape[0]} forward (f32 max|err| "
                  f"{max(r['err'] for r in results):.3g})", card)


def sampler_backward_sites(tag, run_step, card, **extra):
    """The sampler's backward kernel against autograd of the plain version on
    what every backward launch of run_step() was given: f32 (`g` scaled to
    unit magnitude) and bf16, the latter timed. Returns the sites' summed
    result, with `extra`."""
    from cpm_tpu_torch.tools.probe_dcn_sampler import check_backward

    def keep(feat, ys, xs, g, *_):
        return feat.detach().clone(), ys.detach().clone(), xs.detach().clone(), g.detach().clone()

    with capture_calls(ops()["deform"].KERNEL, "backward", keep) as captured:
        run_step()
        torch.cuda.synchronize()
    if len(captured) != X101_SAMPLER_CALLS:
        raise AssertionError(f"{tag} {len(captured)} sampler backward launches in one step, want "
                             f"{X101_SAMPLER_CALLS}")
    columns = sum(g.numel() * g.element_size() for *_, g in captured)
    print(f"{tag} the sampled columns of the {len(captured)} deformable convs hold "
          f"{columns / 2**20:.1f} MiB in {captured[0][3].dtype} (kept for the backward of the "
          f"contraction; part of the peak above)")
    results = []
    # autograd runs the convs backwards: res5 first
    for i, (feat, ys, xs, g) in enumerate(reversed(captured)):
        feat, fexp = unit_scale(feat)
        g, gexp = unit_scale(g)
        name = f"site {i} map {tuple(feat.shape)} x 2^{-fexp}, g x 2^{-gexp}"
        err32 = check_backward(name, feat.float().contiguous(), ys, xs, g.float().contiguous(),
                               card, timed=False)["err"]
        res = check_backward(name, feat.contiguous(), ys, xs, g.contiguous(), card, reps=5)
        results.append(dict(res, err=err32))
    out = summed(results, None, f"[bwd kernel] deform_sample: the {len(results)} backward calls "
                 f"of one training step (f32 max|err| {max(r['err'] for r in results):.3g}, two "
                 f"runs bit-equal at every site)", card)
    print(f"[binning] deform_sample: the binning kernels of the {len(results)} backward calls "
          f"{sum(r['binning_ms'] for r in results):.4f} ms, inside the kernel's "
          f"{out['ms']:.4f} ms | {card}")
    return dict(out, **extra)


def wide_batch_step(tag, step_fn, state, cfg, want_launches, card, batch=4):
    """One X-101-DCN training step at `batch` 4: finite losses and the
    launches of a step, then the sampler backward's check on the largest of
    the 30 sites it captured (the first res3 block samples the 200x336 map at
    stride 2: 4200 tiles and 151,200 samples an image), two runs bit-equal.
    The binning's keys are counted per image, so no batch is beyond them."""
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.tools.probe_dcn_sampler import check_backward

    def keep(feat, ys, xs, g, *_):
        return feat.detach().clone(), ys.detach().clone(), xs.detach().clone(), g.detach().clone()

    data = synthetic_batch(batch, 800, 1344, max_gt=32, num_classes=cfg.MODEL.NUM_CLASSES,
                           seed=105, uint8=True)
    before = launch_counts()
    with capture_calls(ops()["deform"].KERNEL, "backward", keep) as captured:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step_fn(state, data)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = launched_since(before)
    total = float(metrics["total_loss"])
    if not all(math.isfinite(float(metrics[k])) for k in TRAIN_LOSSES) or not math.isfinite(total):
        raise AssertionError(f"{tag} batch {batch}: non-finite losses {metrics}")
    if launched != want_launches:
        raise AssertionError(f"{tag} batch {batch}: launched {launched}, want {want_launches}")
    feat, ys, xs, g = max(captured, key=lambda site: site[0].shape[1] * site[0].shape[2])
    del captured
    feat, fexp = unit_scale(feat)
    g, gexp = unit_scale(g)
    name = f"batch-{batch} site map {tuple(feat.shape)} x 2^{-fexp}, g x 2^{-gexp}"
    err = check_backward(name, feat.contiguous(), ys, xs, g.contiguous(), card, timed=False)["err"]
    print(f"{tag} batch {batch}: one step {seconds * 1e3:.1f} ms (the first at this batch: cuDNN "
          f"plans its shapes), total_loss {total:.4f}, launches {launched}; the sampler backward "
          f"at its largest site, {name}, {ys.shape[1]} samples an image, against autograd of the "
          f"plain version (max |err| {err:.3g}), two runs bit-equal | {card}")


def phase_x101_eval(dev, card, n_requests=2):
    """Phase 10: the X-101-32x4d-FPN-DCN eval path. Returns the sampler's and
    the pooler's launches and the sampler's check at its 30 sites."""
    from cpm_tpu_torch.config import x101_dcn_cfg
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools.profile_eval import make_request
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics, spread_offset_convs

    tag = "[eval x101_dcn]"
    rng = np.random.RandomState(0)
    cfg = x101_dcn_cfg()
    cfg.GRID_RCNN.SCORE_THRESH = 0.0
    print(f"{tag} GRID_RCNN.SCORE_THRESH set to 0.0 (random weights score near 1/81)")
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=0)
    n_spread = spread_offset_convs(model, seed=1)
    if n_spread != X101_SAMPLER_CALLS:
        raise AssertionError(f"{n_spread} deformable convs, want {X101_SAMPLER_CALLS}")
    n_folded = fold_batch_statistics(model, make_request(np.random.RandomState(99), [(800, 1344)])[0])
    # after the fold: the forward runs on casts of the parameters made here
    forward = make_forward_fn(cfg, model)
    layers = tuple(cfg.BACKBONE.RESNEXT.LAYERS)
    print(f"{tag} model built in {time.perf_counter() - t0:.2f} s: ResNeXt {layers} C="
          f"{cfg.BACKBONE.RESNEXT.C} WIDTH={cfg.BACKBONE.RESNEXT.WIDTH} stages "
          f"{tuple(cfg.BACKBONE.RESNEXT.STAGE_WITH_CONV)}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, {cfg.TPU.COMPUTE_DTYPE}; "
          f"{n_spread} offset convs drawn from a seed, {n_folded} frozen affines set from one "
          f"batch's statistics")
    nc, max_dets = cfg.MODEL.NUM_CLASSES, cfg.GRID_RCNN.TEST_MAX_DETECTIONS
    forward(*make_request(rng, [(800, 1333)]))
    torch.cuda.synchronize()
    print(f"{tag} warm-up: one batch-1 request (untimed, uncounted)")

    requests = [make_request(rng, hw) for hw in ([(800, 1333)], [(800, 1067)])[:n_requests]]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    want_launches = {"deform_sample": X101_SAMPLER_CALLS, "multilevel_roi_align": 5}
    latencies = []
    for i, (images, sizes) in enumerate(requests):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = forward(images, sizes)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        launched = launched_since(before)
        counts = check_detections(dets, sizes, images.shape[0], nc, max_dets)
        if launched != want_launches:
            raise AssertionError(f"{tag} request {i}: launched {launched}, want {want_launches}")
        print(f"{tag} request {i}: batch 1 sizes {sizes.tolist()} {latencies[-1] * 1e3:.1f} ms, "
              f"valid detections {counts}, launches {launched}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} batch-1 median latency {statistics.median(latencies) * 1e3:.2f} ms over "
          f"{len(requests)} requests | {card}")
    print(f"{tag} peak device memory {peak / 2**20:.1f} MiB (max_memory_allocated) | {card}")
    out = sampler_forward_sites(tag, lambda: forward(*requests[0]), card)
    return dict(out, launches=counts["deform_sample"],
                pooler_launches=counts["multilevel_roi_align"])


def phase_x101_reference(dev):
    """The X-101-DCN port on the card (CUDA sampler and pooler) against the
    same port on the CPU (plain versions) at a tiny width in f32: one set of
    weights, made on the CPU (seeded, offset convs spread, affines folded)
    and copied to the card."""
    from cpm_tpu_torch.config import x101_dcn_cfg
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools.profile_eval import make_request
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics, spread_offset_convs

    cfg = x101_dcn_cfg(tiny=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.GRID_RCNN.SCORE_THRESH = 0.0
    images, sizes = make_request(np.random.RandomState(1), [(128, 160), (112, 96)],
                                 padded_hw=(128, 160))
    on_cpu = build_model(cfg, "cpu", seed=0)
    spread_offset_convs(on_cpu, seed=1)
    fold_batch_statistics(on_cpu, images)
    on_card = build_model(cfg, dev, seed=0)
    on_card.load_state_dict(on_cpu.state_dict())
    want = make_forward_fn(cfg, on_cpu)(images, sizes)
    before = launch_counts()
    got = make_forward_fn(cfg, on_card)(images, sizes)
    torch.cuda.synchronize()
    launched = launched_since(before)
    if launched != {"deform_sample": 3, "multilevel_roi_align": 5}:
        raise AssertionError(f"[reference x101_dcn] launched {launched}")
    if not want.mask.any():
        raise AssertionError("[reference x101_dcn] the CPU port found no detection")
    same_detections(got, want, "[reference x101_dcn] card vs CPU port")
    print(f"[reference x101_dcn] tiny ResNeXt-DCN, f32: {want.mask.sum(1).tolist()} detections "
          f"match the CPU port (labels exact, boxes 1e-2 px, scores 1e-4); launches {launched}")


def phase_crossroi(dev, card):
    """Phase 9: the cross-roi kernel at each group size against its plain
    version, then the path that reaches it: the wrapper its tool calls, once
    per group size. Returns the result the JSON line takes."""
    from cpm_tpu_torch.tools import probe_pooler_crossroi as probe

    feat, rois = probe.make_inputs(dev)
    probe.reference_points(feat, rois, (7, 7), card)
    results = [probe.check_group(feat, rois, g, (7, 7), card) for g in probe.GROUPS]
    wide = [probe.check_group(feat, rois, g, (14, 14), card, reps=10) for g in (1, 4)]
    half = feat.to(torch.bfloat16)
    reset_launch_counts()
    before = launch_counts()
    for g in probe.GROUPS:
        out = ops()["crossroi"].crossroi_roi_align(half, rois, g, (7, 7), probe.SCALE, 2)
    torch.cuda.synchronize()
    launched = launched_since(before)
    if launched != {"crossroi_roi_align": len(probe.GROUPS)} or not torch.isfinite(out).all():
        raise AssertionError(f"cross-roi path launched {launched}")
    print(f"[cross-roi path] crossroi_roi_align over the probe's map and rois at G in "
          f"{probe.GROUPS}: launches {launched}")
    return dict(
        launches=launched["crossroi_roi_align"], err=max(r["err"] for r in results + wide),
        bound_by=results[0]["bound_by"],
        **{k: sum(r[k] for r in results) for k in ("ms", "plain_ms", "bound_ms")},
    )


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from cpm_tpu_torch.ops.cuda import _build
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

    # one nvcc per source, all started together; then each wrapper loads its library
    t0 = time.perf_counter()
    built = _build.compile_sources([mod.SOURCE for mod in ops().values()])
    print(f"[build] {len(built)} sources in {time.perf_counter() - t0:.2f} s (in parallel)")
    for source, b in built.items():
        facts = [ln.split(":", 1)[-1].strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {source.name} -> {b.library_path.name} in {b.seconds:.2f} s; {facts}")
    for mod in ops().values():
        mod.KERNEL.build()

    rng = np.random.RandomState(0)
    synthetic = phase_kernel(dev, rng, card)
    synthetic_bwd = phase_backward_kernel(dev, rng, card)
    detections, fwd = {}, {}
    for backend, n_batch1 in (("auto", 4), ("stacked", 2), ("clustered", 2)):
        fwd[backend] = phase_eval(dev, card, backend, n_batch1, detections)
        torch.cuda.empty_cache()
    phase_reference(dev)
    losses, bwd = [], {}
    for backend in BACKENDS:
        bwd[backend] = phase_train(dev, card, backend, losses)
        torch.cuda.empty_cache()
    phase_train_reference(dev)
    single = phase_single_level(dev, rng, card)
    sampler = phase_sampler_kernels(dev, card)
    crossroi = phase_crossroi(dev, card)
    x101_fwd = phase_x101_eval(dev, card)
    torch.cuda.empty_cache()
    phase_x101_reference(dev)
    x101_bwd = phase_train(dev, card, "auto", None, config="x101_dcn")
    torch.cuda.empty_cache()

    # launches on the driven paths: eval forwards plus training steps
    launches = {
        "multilevel_roi_align": (fwd["auto"]["launches"] + bwd["auto"]["launches"][0]
                                 + x101_fwd["pooler_launches"] + x101_bwd["pooler_launches"][0]),
        "multilevel_roi_align_backward": (bwd["auto"]["launches"][1] + bwd["clustered"]["launches"][1]
                                          + x101_bwd["pooler_launches"][1]),
        "clustered_roi_align": fwd["clustered"]["launches"] + bwd["clustered"]["launches"][0],
        "stacked_roi_align": fwd["stacked"]["launches"] + bwd["stacked"]["launches"][0],
        "stacked_roi_align_backward": bwd["stacked"]["launches"][1],
        "roi_align": single["launches"],
        "deform_sample": x101_fwd["launches"] + x101_bwd["launches"][0],
        "deform_sample_backward": x101_bwd["launches"][1],
        "crossroi_roi_align": crossroi["launches"],
    }
    print(f"[kernels] launches on the driven paths: {launches}")
    stats = {
        "multilevel_roi_align": (fwd["auto"], synthetic["multilevel"]),
        "multilevel_roi_align_backward": (bwd["auto"], synthetic_bwd["multilevel"]),
        "clustered_roi_align": (fwd["clustered"], synthetic["clustered"]),
        "stacked_roi_align": (fwd["stacked"], synthetic["stacked"]),
        "stacked_roi_align_backward": (bwd["stacked"], synthetic_bwd["stacked"]),
        "roi_align": (single, []),
        # errors in f32, as for the other kernels (the bf16 ones are held to
        # their own tolerance where they are checked)
        "deform_sample": (x101_fwd, [r for r in sampler["forward"] if r["dtype"] == "float32"]),
        "deform_sample_backward": (
            x101_bwd, [r for r in sampler["backward"] if r["dtype"] == "float32"]),
        "crossroi_roi_align": (crossroi, []),
    }
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was launched on no driven path")
    if DISAGREEMENTS:
        raise AssertionError("paths disagree with the auto path:\n" + "\n".join(DISAGREEMENTS))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": max([stats[name][0]["err"]] + [r["err"] for r in stats[name][1]]),
        "ms": stats[name][0]["ms"],
        "plain_ms": stats[name][0]["plain_ms"],
        "bound_ms": stats[name][0]["bound_ms"],
        "bound_by": stats[name][0]["bound_by"],
        "library_ms": stats[name][0].get("library_ms"),
    } for name, (source, replaces) in KERNELS.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
