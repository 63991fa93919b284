"""Chip smoke test: drives the port's eval and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

0. device: requires CUDA; prints the card's name and power limit, the torch
   and CUDA versions, and whether yaml and PIL import.
1. build: builds the six CUDA sources of cpm_tpu_torch/csrc with nvcc, one
   process each, all started together (ten kernels: multilevel forward and
   backward, stacked forward and backward, clustered forward and its
   grouping, single-level forward, deformable-conv sampler forward and
   backward, cross-roi shared-window forward).
2. kernels: each multilevel-pooling forward kernel (multilevel, stacked,
   clustered) against its plain PyTorch version at the flagship's pooler
   shapes (B=2, P2-P5 of an 800x1344 batch, C=256), f32 and bf16, on random
   rois (~30% masked, with extreme-aspect, outside and degenerate boxes) and
   on a dense set that forms multi-roi groups (the group-size histogram is
   printed); the stacked and clustered kernels also against the multilevel
   kernel on the same inputs, bit-equal in f32 and bf16 (the stacked one runs
   its loop, csrc/roi_align_forward.cuh), the stacked path's one-pass stack
   against `stack_levels`, bit-equal, and the grouping kernel against its
   plain version, `cluster_rois`, integer for integer. The single-level
   kernel against its plain version at the C4 shape ([2, 50, 84, 1024] f32,
   1024 rois, 7x7 and 14x14), and against the multilevel kernel at one level
   (not aligned, every roi valid), bit-equal.
2b. backward kernels: the multilevel and the stacked backward against their
   plain versions (autograd of the plain forwards) at the training shapes
   (R=1024 at 7x7, R=256 at 14x14, ~30% masked, and a case where 512 rois
   share a few cells, so that many sums meet in one cell): f32, bf16, masked
   rois add nothing, two runs on the same inputs bit-equal (both backwards'
   blocks own tiles of the gradient maps and sum in one fixed order); the
   stacked backward also against the multilevel one, bit-equal (they share
   one tile loop).
3. eval paths: the flagship CPM R-50-FPN config (81 classes, 3 CMM stages,
   ISM, RSM) with seeded random weights, bf16, uint8 images normalized on
   the device, under TPU.POOLER_KERNEL auto, then stacked, then clustered:
   batch-1 requests at 800x1344 (four under auto, two under the others) and
   one batch-2 request. Checks every request's detections and that it
   launched its backend's forward kernel 5 times (cls, three grid stages,
   rescore), under clustered the grouping kernel 5 times too, and no other
   kernel, and that under stacked it built one stack (the five calls pool the
   same FPN maps), elsewhere none; under stacked and clustered the detections
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
   and 5 backward of the backend's kernels, under clustered 5 groupings, none
   of any other), stacks built (one a step under stacked), gradients,
   changed and frozen parameters and the learning rate; under stacked and
   clustered the losses are held against the auto path's. Then the
   backward-kernel check of phase 2b on the gradients, rois and level shapes
   of the five pooler sites of one more step (auto and stacked; clustered
   trains through the multilevel backward kernel), two runs bit-equal, and
   under stacked bit-equal to the multilevel backward.
6. training reference: two steps of the port on the card against two on the
   CPU at a narrow width in f32, the same seed, batch and draws.
7. single-level path: no model of the port has a one-level pooler yet, so a
   `Pooler` over one C4 map is driven directly, forward and backward, and
   held against the plain version and, bit for bit, against the multilevel
   kernel at one level on the same f32 map.
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
   multilevel kernel on the same inputs, and a line a G with its device time
   (`torch.profiler`) beside its bound; no model runs this kernel, so the
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
12. cli: the train and eval CLIs (`cpm_tpu_torch.tools.train_net.main`,
   `test_net.main`, called in this process) on the headline YAML,
   cfgs/rcnn/mscoco/grid_cascade/iou_helper/rescore/
   e2e_grid_cascade@56_rcnn_R-50-FPN_2x.yaml (ResNet-50, FPN 256, 81
   classes, CMM with 2 stages, ISM unmerged, RSM, 800x1344 bucket, bf16 over
   f32 masters), over the repository's synthetic COCO set (data/
   synthetic_debug, 16 images), batch 2 at SOLVER.BASE_LR 0.0025 (the YAML's
   0.02 for 16 images, scaled linearly). A step-0 checkpoint, written through
   the port's CheckPointer with the frozen affines folded from the first batch
   of the port's TrainLoader, starts two runs: 4 steps in one go, and 2 steps,
   a restore on the card held bit-equal to the model_iter2 snapshot, and a
   resume to 4 whose losses are held against the first run's (relative
   RESUME_LOSS_RTOL; whether the states are bit-equal is reported, and the
   tensors that differ, with the kind of module that owns them, named). Every
   step's losses are finite and its launches are those of the multilevel
   kernels, one of each a pooler call (4 a forward: cls, two CMM stages,
   rescore). Then test_net from the first run's checkpoint over the 16 images
   at TEST.SCALE 800, MAX_SIZE 1333, GRID_RCNN.SCORE_THRESH 0.0: 4 forward
   launches an image, at least one detection, every box inside its image,
   bbox.json parses. It prints the step wall time, the loader wait, the peak
   memory, the eval images per second with the first image apart, the AP,
   and how long the phase took.
13. ms: the paper's _ms YAML, cfgs/rcnn/mscoco/grid_cascade/iou_helper/
   rescore/e2e_grid_cascade@567_rcnn_R-50-FPN_2x_ms.yaml (the @567 model:
   CMM with 3 stages, ISM merged, RSM; TTA with the flip and scales 600,
   1000, 1200 at max size 2000, so 8 passes over 4 buckets up to 1216x2016,
   merged by soft-NMS), from weights in the reference's layout, over the
   synthetic set. A seeded model, its frozen affines folded from the
   loader's first batch, is written as a reference CPM checkpoint
   (`Conv_Body.*`, `Conv_Body_FPN.*`, `RPN.head.*`, `Grid_Cascade_RCNN.*`,
   by `reference_state_dict`, the inverse of the port's importer), as a
   caffe-style trunk and as a port checkpoint. test_net `--range 0 4` from
   the port checkpoint, synchronised around each forward and merge to time
   them, then with TEST.WEIGHTS the .pth: each run 5 x 8 x 4 launches of the
   multilevel forward kernel and none of any other, the merged detections
   finite, inside their images, labels in 1..80, the imported model holding
   the tensors to the bit, and the two runs' results equal to the bit. test_net `--shards 2` over the same images: two children, one
   after the other on one card, whose merged results equal the single
   process's (categories exactly, boxes 1e-2 px, scores 1e-4) and whose logs
   name the card. train_net with TRAIN.WEIGHTS the trunk, 2 steps at batch 2
   on the YAML's multi-scale buckets: finite losses, 5 + 5 launches a step,
   the frozen trunk bit-equal to the import after the steps. It prints each
   pass's forward time by bucket (the first of each apart), the merge's
   time an image, the wall time an image, the peak memory and the phase's
   time.

Then a JSON line of kernel results and, last, {"ok": true, "device": ...}.
Random weights give softmax scores near 1/81, below the default 0.03
threshold, so GRID_RCNN.SCORE_THRESH is set to 0.0 for phase 3.

Each kernel's `bound_ms` is the least time the card could take for the call:
the larger of its bytes over 3.35 TB/s (the level cells the rois touch, the
rois, and the output for a forward; the valid rois' gradient rows, the
rois, and every level map written once for a backward; for the clustered
forward each group's rectangle counted once, not once per roi, plus the
grouping arrays; for the grouping kernel the rois, level ids and mask read
and the grouping written) and its f32 multiply-adds over 67 TFLOP/s. The
stacked kernels' stack is torch ops outside the kernels, made once a
forward in one pass; its time is printed on a line of its own. No
single PyTorch call computes a RoIAlign or its transpose (torchvision's is
no dependency of the port), so `library_ms` is null for the RoIAlign kernels
and the grouping. The
sampler's bounds (cpm_tpu_torch/tools/probe_dcn_sampler.py::sampler_bounds)
and the cross-roi kernel's (cpm_tpu_torch/tools/probe_pooler_crossroi.py::
crossroi_bound, the distinct map cells its members weigh)
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
TRAIN_LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_grid_1",
                "loss_grid_2", "loss_grid_3", "loss_iou_3", "loss_rescore")
BACKENDS = ("auto", "stacked", "clustered")
# what disagreed with the auto path: reported where it happens, so that one
# run shows every disagreement, and raised together at the end of main
DISAGREEMENTS = []
# the ten kernels: name -> (source, the TPU kernel it replaces)
KERNELS = {
    "multilevel_roi_align": (
        "cpm_tpu_torch/csrc/multilevel_roi_align.cu", "cpm_tpu/ops/pallas/multilevel_pallas.py:480"),
    "multilevel_roi_align_backward": (
        "cpm_tpu_torch/csrc/multilevel_roi_align.cu", "cpm_tpu/ops/pallas/multilevel_pallas.py:632"),
    "clustered_roi_align": (
        "cpm_tpu_torch/csrc/clustered_roi_align.cu", "cpm_tpu/ops/pallas/clustered_pallas.py:327"),
    # the clustered path's grouping, XLA ops around the Pallas kernel there
    "cluster_rois": (
        "cpm_tpu_torch/csrc/clustered_roi_align.cu", "cpm_tpu/ops/pallas/clustered_pallas.py:249"),
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
# the grouping kernel each pooler call launches before the forward kernel
GROUPING_KERNEL = {"clustered": "cluster_rois"}
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
    """Launches of each of the ten kernels so far, as their wrappers count them."""
    m = ops()
    return {
        "deform_sample": m["deform"].KERNEL.launches,
        "deform_sample_backward": m["deform"].KERNEL.backward_launches,
        "crossroi_roi_align": m["crossroi"].KERNEL.launches,
        "multilevel_roi_align": m["multilevel"].KERNEL.launches,
        "multilevel_roi_align_backward": m["multilevel"].KERNEL.backward_launches,
        "clustered_roi_align": m["clustered"].KERNEL.launches,
        "cluster_rois": m["clustered"].KERNEL.grouping_launches,
        "stacked_roi_align": m["stacked"].KERNEL.launches,
        "stacked_roi_align_backward": m["stacked"].KERNEL.backward_launches,
        "roi_align": m["single"].KERNEL.launches,
    }


def stack_builds():
    """Stacked buffers built so far by the stacked pooler (once a forward,
    `ops/cuda/stacked_roi_align.py::STACKS`)."""
    return ops()["stacked"].STACKS.builds


def reset_launch_counts():
    m = ops()
    for mod in m.values():
        mod.KERNEL.launches = 0
    for name in ("multilevel", "stacked", "deform"):
        m[name].KERNEL.backward_launches = 0
    m["clustered"].KERNEL.grouping_launches = 0


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
            # the card's stack, made once a forward: one pass over the bytes
            if not torch.equal(plain.stack_levels_in_one_pass(fs), plain.stack_levels(fs)):
                raise AssertionError("the one-pass stack differs from stack_levels")
            ms = cuda_ms(lambda: plain.stack_levels_in_one_pass(fs))
            pad_cat_ms = cuda_ms(lambda: plain.stack_levels(fs))
            return (f"stack in one pass (torch ops, once a forward) {ms:.4f} ms, bit-equal to "
                    f"stack_levels (pad and cat, {pad_cat_ms:.4f} ms)")

        return (kernel, lambda fs: plain.multilevel_roi_align_stacked_plain(
            fs, rois, levels, pool, SCALES, 2) * mask.to(fs[0].dtype), extra)
    if impl == "clustered":
        def cluster():
            return plain.cluster_rois(rois, levels, valid, level_hw, features[0].shape[0], pool,
                                      SCALES, 2)

        grouping = cluster()

        def extra(fs):
            return group_histogram(grouping)

        return (lambda fs: m["clustered"].KERNEL(fs, rois, levels, valid, pool, SCALES, 2,
                                                 grouping=grouping),
                lambda fs: plain.multilevel_roi_align_clustered_plain(
                    fs, rois, levels, valid, pool, SCALES, 2, grouping=grouping), extra)
    raise ValueError(impl)


def check_grouping(name, rois, levels, valid, level_hw, batch, pool, card):
    """The grouping kernel against its plain version, `cluster_rois`, on the
    same inputs: order, groups, slot groups and group count equal, integer
    for integer. Returns a dict of the times and bound (err 0)."""
    from cpm_tpu_torch.ops.roi_align import Grouping, cluster_rois
    from cpm_tpu_torch.tools.bench_roi_align import grouping_bound

    kernel = ops()["clustered"].KERNEL
    args = (rois, levels, valid, level_hw, batch, pool, SCALES, 2)
    got, want = kernel.group(*args), cluster_rois(*args)
    for field in Grouping._fields:
        a, b = getattr(got, field), getattr(want, field)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"grouping {name}: {field} differs from cluster_rois'")
    ms = cuda_ms(lambda: kernel.group(*args))
    plain_ms = cuda_ms(lambda: cluster_rois(*args), reps=5)
    bound_ms, bound_by = grouping_bound(rois.shape[0])
    print(f"[grouping] {name}: R={rois.shape[0]} valid={int(valid.sum())} pool={pool}: "
          f"{int(got.n_groups)} groups, order, groups, slot groups and count equal to "
          f"cluster_rois'; kernel {ms:.4f} ms, plain (cluster_rois, torch ops) {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}) | {card}")
    return dict(err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


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
    # the stacked and clustered forwards sum in the multilevel one's order
    # (csrc/roi_align_forward.cuh, roi_align_common.cuh::pool_bin): its bits
    if impl != "multilevel" and not torch.equal(got, other(f32)):
        raise AssertionError(f"{name}: f32 differs from the multilevel kernel by "
                             f"{(got - other(f32)).abs().max().item()}")

    bf = [f.to(torch.bfloat16).contiguous() for f in features]
    got = kernel(bf)
    if impl != "multilevel" and not torch.equal(got, other(bf)):
        raise AssertionError(f"{name}: bf16 differs from the multilevel kernel's bits")
    got = got.float()
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
    from cpm_tpu_torch.tools.bench_roi_align import clustered_bound, roi_align_bounds

    if impl == "clustered":
        from cpm_tpu_torch.ops.roi_align import cluster_rois

        grouping = cluster_rois(rois, levels, valid, [s[1:3] for s in shapes], shapes[0][0], pool,
                                SCALES, 2)
        bound_ms, bound_by = clustered_bound(shapes, rois, levels, valid, pool, 2, grouping)
    else:
        (bound_ms, bound_by), _ = roi_align_bounds(shapes, rois, levels, valid, pool, 2)
    print(
        f"[kernel] {name}: R={rois.shape[0]} pool={pool} valid={int(valid.sum())} "
        f"f32 max|err|={err32:.3g} (atol {F32_ATOL}) "
        f"{'' if impl == 'multilevel' else 'bit-equal to the multilevel kernel (f32, bf16) '}"
        f"bf16 max|err|={err16:.3g} (rtol {BF16_RTOL}, atol {BF16_ATOL}) bf16 kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) | {card}"
    )
    if extra is not None:
        print(f"[kernel] {name}: {extra(bf)} | {card}")
    out = dict(err=err32, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    if impl == "clustered":
        out["grouping"] = check_grouping(name, rois, levels, valid, [s[1:3] for s in shapes],
                                         shapes[0][0], pool, card)
    return out


def check_backward_kernel(name, shapes, rois, levels, valid, g, card, rescale=False,
                          impl="multilevel"):
    """One backward kernel ('multilevel' or 'stacked') vs its plain version
    (autograd of its plain forward) on the same inputs: f32 (TF32 plays no
    part: neither side multiplies matrices), bf16, masked rois, two runs;
    the stacked kernel also vs the multilevel one, to the bit (one tile
    loop, csrc/roi_align_tiles.cuh). Returns a dict of the f32 max error and
    the bf16 times and bound.

    Tolerances. f32: rtol 1e-4 / atol 1e-4, the JAX package's own for its
    backward kernels; both sides sum each cell's terms in f32 in another
    order (the kernels in one fixed order, so two runs are bit-equal).
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
    # masked rois add nothing: the same gradient with them removed
    kept = kernel(shapes, rois[valid].contiguous(), levels[valid].contiguous(),
                  torch.ones_like(valid[valid]), g32[valid].contiguous(), SCALES, 2)
    err_masked = worst(got, kept, "the call without the masked rois")
    again = kernel(shapes, rois, levels, valid, g32, SCALES, 2)
    # the tile-owned backwards sum every cell in one fixed order
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two backward runs on the same inputs differ")

    g16 = g.to(torch.bfloat16).contiguous()
    got16 = kernel(shapes, rois, levels, valid, g16, SCALES, 2)
    want16 = plain(shapes, rois, levels, valid, g16.float(), SCALES, 2)
    if impl == "stacked":
        # one tile loop: the multilevel kernel's bits
        for dt, ours, gg in (("f32", got, g32), ("bf16", got16, g16)):
            theirs = m["multilevel"].KERNEL.backward(shapes, rois, levels, valid, gg, SCALES, 2)
            if not all(torch.equal(a, b) for a, b in zip(ours, theirs)):
                raise AssertionError(f"{name}: {dt} backward differs from the multilevel kernel's")
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

    from cpm_tpu_torch.tools.bench_roi_align import roi_align_bounds

    ms = cuda_ms(lambda: kernel(shapes, rois, levels, valid, g16, SCALES, 2))
    plain_ms = cuda_ms(lambda: plain(shapes, rois, levels, valid, g16, SCALES, 2), reps=3)
    _, (bound_ms, bound_by) = roi_align_bounds(shapes, rois, levels, valid, pool, 2)
    print(
        f"[bwd kernel] {name}: R={rois.shape[0]} pool={pool} valid={int(valid.sum())} "
        f"f32 max|err|={err32:.3g} (rtol {BWD_F32_RTOL}, atol {BWD_F32_ATOL}) "
        f"{'bit-equal to the multilevel kernel (f32, bf16), ' if impl == 'stacked' else ''}"
        f"masked-removed max|diff|={err_masked:.3g}, two runs bit-equal, "
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
    from cpm_tpu_torch.tools.bench_roi_align import roi_align_bounds

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
        # kernel 1's loop at one level, not aligned, every roi valid: its bits
        if not torch.equal(got, m["multilevel"].KERNEL([feats], rois, zeros, everyone, pool,
                                                       (C4_SCALE,), 2)):
            raise AssertionError(f"single-level {pool}: differs from the multilevel kernel")
        del got, want
        ms = cuda_ms(lambda: m["single"].KERNEL(feats, rois, pool, C4_SCALE, 2))
        plain_ms = cuda_ms(lambda: chunked_plain(pool), reps=3)
        (bound_ms, bound_by), _ = roi_align_bounds(
            [C4_SHAPE], rois, zeros, everyone, pool, 4, scales=(C4_SCALE,))
        print(f"[kernel] single-level C4 {pool[0]}x{pool[1]}: map {C4_SHAPE} f32 R={C4_ROIS} "
              f"max|err|={err:.3g} (atol {F32_ATOL}), bit-equal to the multilevel kernel at one "
              f"level; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
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
    # kernel 5 against kernel 1 at one level on what the Pooler gave it
    level = m["multilevel"].KERNEL([half.detach().float()], rois, zeros, everyone, (7, 7),
                                   (C4_SCALE,), 2).to(torch.bfloat16)
    if not torch.equal(pooled.detach(),
                       torch.where(valid[:, None, None, None], level, torch.zeros_like(level))):
        raise AssertionError("one-level Pooler: differs from the multilevel kernel at one level")
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
          f"{BF16_ATOL}) and the multilevel kernel at one level (bit-equal), masked rows zero, "
          f"gradient finite; launches {launched}")
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
    if backend in GROUPING_KERNEL:
        want_launches[GROUPING_KERNEL[backend]] = 5
    latencies = []
    for i, (images, sizes) in enumerate(requests):
        before, builds = launch_counts(), stack_builds()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = forward(images, sizes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        latencies.append(dt)
        launched = launched_since(before)
        built = stack_builds() - builds
        counts = check_detections(dets, sizes, images.shape[0], nc, max_dets)
        if launched != want_launches:
            raise AssertionError(f"{tag} request {i}: launched {launched}, want {want_launches}")
        # the five pooler calls share the FPN maps: one stack a forward
        if built != (backend == "stacked"):
            raise AssertionError(f"{tag} request {i}: {built} stacks built, want "
                                 f"{int(backend == 'stacked')}")
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
              f"{dt * 1e3:.1f} ms, valid detections {counts}, launches {launched}, stacks "
              f"built {built}{compared}")
    counts = launch_counts()
    launches = counts[FORWARD_KERNEL[backend]]
    grouping_launches = counts.get(GROUPING_KERNEL.get(backend))
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
    out = summed(results, launches, f"[kernel] {impl}: the 5 pooler calls of one batch-1 forward",
                 card)
    if backend in GROUPING_KERNEL:
        name = GROUPING_KERNEL[backend]
        out["grouping"] = summed([r["grouping"] for r in results], grouping_launches,
                                 f"[kernel] {name}: the 5 groupings of one batch-1 forward", card)
    return out


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
    # its losses agrees to 1e-4; from then on the parameters differ by
    # cuDNN's sums, whose order changes, which bf16 training amplifies, and
    # the total loss is held to 0.1 relative
    state, metrics = step_fn(state, batch_for(100))
    torch.cuda.synchronize()
    note = held_against_auto(0, losses_of(metrics), 1e-4)
    print(f"{tag} warm-up: one step (untimed, uncounted), total_loss "
          f"{float(metrics['total_loss']):.4f}{note}")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    want_launches = {fwd_kernel: 5, bwd_kernel: 5}
    if backend in GROUPING_KERNEL:
        want_launches[GROUPING_KERNEL[backend]] = 5
    if deformable:
        want_launches.update(deform_sample=X101_SAMPLER_CALLS,
                             deform_sample_backward=X101_SAMPLER_CALLS)
    offset_convs = {k for k in labels if ".conv_offset." in k}
    times = []
    for i in range(2):
        batch = batch_for(101 + i)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        counts0, step0, builds = launch_counts(), state.step, stack_builds()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        built = stack_builds() - builds
        if built != (backend == "stacked"):
            raise AssertionError(f"step {i}: {built} stacks built, want {int(backend == 'stacked')}")
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
              + f"; launches {launched}, stacks built {built}; "
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
        grouping = counts[GROUPING_KERNEL[backend]]
        print(f"{tag} launches in the 2 steps: {GROUPING_KERNEL[backend]} {grouping}")
        return dict(launches=launches, grouping_launches=grouping)
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
    if any(ys.dim() != 3 or ys.shape[2] % 9 for _, ys, _ in captured):
        raise AssertionError(f"{tag} a sampler call came without its rows of output positions")
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
          f"at its largest site, {name}, {ys[0].numel()} samples an image, against autograd of the "
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
    from cpm_tpu_torch.ops.roi_align import WindowedRois, crossroi_prep_rois
    from cpm_tpu_torch.tools import probe_pooler_crossroi as probe
    from cpm_tpu_torch.tools.compare_kernels import device_ms

    feat, rois = probe.make_inputs(dev)
    probe.reference_points(feat, rois, (7, 7), card)
    results = [probe.check_group(feat, rois, g, (7, 7), card) for g in probe.GROUPS]
    wide = [probe.check_group(feat, rois, g, (14, 14), card, reps=10) for g in (1, 4)]
    half = feat.to(torch.bfloat16)
    for pool, checked in (((7, 7), results), ((14, 14), wide)):
        prep = WindowedRois(*(t.contiguous() for t in crossroi_prep_rois(
            rois, probe.SCALE, feat.shape[1:3], pool, 2)))
        for r in checked:
            ms = device_ms([(half, prep, r["group"], pool, 2)], ops()["crossroi"].KERNEL)
            print(f"[cross-roi device] G={r['group']} {pool[0]}x{pool[1]} bf16: device time "
                  f"{ms:.4f} ms (event {r['ms']:.4f}), bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}: the distinct map cells weighed), {ms / r['bound_ms']:.2f}x "
                  f"| {card}")
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



HEADLINE_YAML = "cfgs/rcnn/mscoco/grid_cascade/iou_helper/rescore/e2e_grid_cascade@56_rcnn_R-50-FPN_2x.yaml"
# the headline YAML's cuts for one card: the repository's synthetic COCO set,
# batch 2 (the flagship's per-device batch) at the linearly scaled rate
CLI_TRAIN_OPTS = ["TRAIN.DATASETS", "('coco_debug_synthetic',)", "TRAIN.BATCH_SIZE", "2",
                  "SOLVER.BASE_LR", "0.0025", "SOLVER.SNAPSHOT_ITERS", "2"]
# random weights score near 1/81, below the YAML's GRID_RCNN.SCORE_THRESH 0.03
CLI_TEST_OPTS = ["TEST.DATASETS", "('coco_debug_synthetic',)", "TEST.SCALE", "800",
                 "TEST.MAX_SIZE", "1333", "GRID_RCNN.SCORE_THRESH", "0.0"]
# the resumed run's losses against the uninterrupted run's, where cuDNN's
# backward sums in another order than in the first run (relative)
RESUME_LOSS_RTOL = 2e-2


def state_differences(a, b, module_types):
    """The tensors of two checkpoint state_dicts ('model') that differ, each
    named with the kind of module that owns it and the largest difference."""
    out = []
    for k in a:
        if not torch.equal(a[k].cpu(), b[k].cpu()):
            owner = module_types.get(k.rsplit(".", 1)[0], "?")
            diff = (a[k].float().cpu() - b[k].float().cpu()).abs().max().item()
            out.append(f"{k} ({owner}, max |diff| {diff:.3g})")
    return out


def phase_cli(dev, card):
    """Phase 12: the train and eval CLIs on the headline YAML. Returns the
    multilevel kernels' launches in its runs."""
    import os
    import tempfile

    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.data.loader import TestLoader, TrainLoader
    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.train import create_train_state
    from cpm_tpu_torch.tools import test_net, train_net
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(repo, HEADLINE_YAML)
    opts = CLI_TRAIN_OPTS + ["DATA_DIR", os.path.join(repo, "data")]
    cfg = train_net.load_config(cfg_file, opts)
    stages = cfg.GRID_RCNN.CASCADE_MAPPING_OPTION.STAGE_NUM
    # the pooler calls of a forward: cls, each CMM stage, rescore
    sites = 1 + stages + int(cfg.GRID_RCNN.RESCORE_ON)
    losses = (["loss_objectness", "loss_rpn_box_reg", "loss_classifier"]
              + [f"loss_grid_{s + 1}" for s in range(stages)] + [f"loss_iou_{stages}", "loss_rescore"])
    print(f"[cli] {HEADLINE_YAML}: {cfg.MODEL.NUM_CLASSES} classes, ResNet "
          f"{tuple(cfg.BACKBONE.RESNET.LAYERS)}, FPN {cfg.FPN.DIM}, CMM {stages} stages, "
          f"{sites} pooler calls a forward, {len(losses)} losses; overrides {opts}")
    fwd = ops()["multilevel"].KERNEL
    launched = dict(forward=0, backward=0)

    def run(what, fn, argv, want_fwd, want_bwd):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(argv)
        seconds = time.perf_counter() - t0
        got = launch_counts()
        others = {k: v for k, v in got.items() if v and not k.startswith("multilevel_roi_align")}
        if (fwd.launches, fwd.backward_launches) != (want_fwd, want_bwd) or others:
            raise AssertionError(f"[cli] {what}: launched {got}, want multilevel_roi_align "
                                 f"{want_fwd} and its backward {want_bwd}, no other")
        launched["forward"] += fwd.launches
        launched["backward"] += fwd.backward_launches
        peak = torch.cuda.max_memory_allocated() / 2**20
        print(f"[cli] {what}: {seconds:.2f} s in the call, launches multilevel_roi_align "
              f"{fwd.launches}, backward {fwd.backward_launches}; peak device memory {peak:.1f} MiB "
              f"(max_memory_allocated) | {card}")
        torch.cuda.empty_cache()
        return out

    def check_steps(what, history, first):
        for r in history:
            names = [k for k in r if k.startswith("loss_")]
            values = [r[k] for k in losses + ["total_loss"]]
            if sorted(names) != sorted(losses) or not all(math.isfinite(v) for v in values):
                raise AssertionError(f"[cli] {what} iter {r['iter']}: losses {r}")
        if [r["iter"] for r in history] != list(range(first, first + len(history))):
            raise AssertionError(f"[cli] {what}: iterations {[r['iter'] for r in history]}")
        for r in history:
            print(f"[cli] {what} iter {r['iter']}: step {r['step_s'] * 1e3:.1f} ms, loader wait "
                  f"{r['wait_s'] * 1e3:.1f} ms, lr {r['lr']:.6g}, total_loss {r['total_loss']:.4f}, "
                  + ", ".join(f"{k[5:]} {r[k]:.4f}" for k in losses))

    with tempfile.TemporaryDirectory(prefix="cpm_cli_") as tmp:
        ck_a, ck_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")

        def argv(ckpt, max_iter):
            return (["--cfg", cfg_file, "--device", dev] + opts
                    + ["CKPT", ckpt, "SOLVER.MAX_ITER", str(max_iter)])

        # a step-0 checkpoint whose frozen affines are folded from the first
        # batch of the port's loader (a random trunk with unit affines
        # diverges in two steps); both CLI runs resume from it
        t0 = time.perf_counter()
        model, optimizer, state = create_train_state(cfg, dev, cfg.SEED)
        module_types = {n: type(m).__name__ for n, m in model.named_modules()}
        (dataset,) = build_dataset(cfg, cfg.TRAIN.DATASETS, is_train=True)
        t1 = time.perf_counter()
        first = next(iter(TrainLoader(cfg, dataset, cfg.TRAIN.BATCH_SIZE, seed=cfg.SEED, prefetch=0)))
        make_ms = (time.perf_counter() - t1) * 1e3
        n_folded = fold_batch_statistics(model, first["images"])
        for ckpt in (ck_a, ck_b):
            CheckPointer(ckpt).save(state, 0)
        del model, optimizer, state
        torch.cuda.empty_cache()
        print(f"[cli] step-0 checkpoint in {time.perf_counter() - t0:.2f} s: {n_folded} frozen "
              f"affines folded from the loader's first batch {tuple(first['images'].shape)} "
              f"{first['images'].dtype}, {len(dataset)} images; the loader made that batch in "
              f"{make_ms:.1f} ms on this thread (PIL decode, resize, flip, padding)")

        straight = run("train_net 4 steps", train_net.main, argv(ck_a, 4), 4 * sites, 4 * sites)
        check_steps("train_net", straight, 1)
        steps = [r["step_s"] for r in straight]
        waits = [r["wait_s"] for r in straight]
        print(f"[cli] train_net step wall time {statistics.median(steps) * 1e3:.1f} ms median "
              f"(first {steps[0] * 1e3:.1f}, cuDNN plans its shapes), loader wait "
              f"{statistics.median(waits) * 1e3:.1f} ms median (max {max(waits) * 1e3:.1f}), "
              f"batch 2 at 800x1344 | {card}")
        files = sorted(os.listdir(ck_a))
        if files != sorted(["model_iter2", "model_iter4", "model_latest",
                            os.path.basename(cfg_file)]):
            raise AssertionError(f"[cli] {ck_a} holds {files}")

        # resume: stopped at step 2, restored, resumed to step 4
        stopped = run("train_net to step 2", train_net.main, argv(ck_b, 2), 2 * sites, 2 * sites)
        check_steps("train_net to step 2", stopped, 1)
        snap = torch.load(os.path.join(ck_b, "model_iter2"), map_location="cpu", weights_only=True)
        model, optimizer, state = create_train_state(cfg, dev, cfg.SEED)
        CheckPointer(ck_b).load(state)
        restored = dict(model=model.state_dict(), optimizer=optimizer.state_dict(),
                        draws=state.draws.state_dict())
        wrong = [f"model {k}" for k in snap["model"]
                 if not torch.equal(restored["model"][k].cpu(), snap["model"][k])]
        for i, s in snap["optimizer"]["state"].items():
            if not torch.equal(restored["optimizer"]["state"][i]["momentum_buffer"].cpu(),
                               s["momentum_buffer"]):
                wrong.append(f"momentum {i}")
        if not torch.equal(restored["draws"]["generator"], snap["draws"]["generator"]):
            wrong.append("draws generator")
        if state.step != 2 or wrong:
            raise AssertionError(f"[cli] restored state at step {state.step} differs from the "
                                 f"snapshot: {wrong[:5]}")
        print(f"[cli] restored on the card: step 2, {len(snap['model'])} model tensors, "
              f"{len(snap['optimizer']['state'])} momentum buffers and the draws' generator "
              f"bit-equal to model_iter2")
        del model, optimizer, state, restored
        torch.cuda.empty_cache()
        resumed = run("train_net resumed to step 4", train_net.main, argv(ck_b, 4),
                      2 * sites, 2 * sites)
        check_steps("train_net resumed", resumed, 3)
        worst = max(abs(b[k] - a[k]) / abs(a[k]) for a, b in zip(straight, stopped + resumed)
                    for k in losses + ["total_loss"])
        same_losses = all(a[k] == b[k] for a, b in zip(straight, stopped + resumed)
                          for k in losses + ["total_loss"])
        def load(ckpt, name):
            return torch.load(os.path.join(ckpt, name), map_location="cpu",
                              weights_only=True)["model"]

        at2 = state_differences(load(ck_a, "model_iter2"), snap["model"], module_types)
        at4 = state_differences(load(ck_a, "model_latest"), load(ck_b, "model_latest"), module_types)
        print(f"[cli] resume: losses of steps 1-4 {'bit-equal to' if same_losses else 'within'} "
              f"the uninterrupted run's (largest relative difference {worst:.3g}, bound "
              f"{RESUME_LOSS_RTOL}); step 2 states bit-equal: {not at2}; step 4 states bit-equal: "
              f"{not at4}")
        for what, diffs in (("step 2 (the same two steps from one checkpoint)", at2),
                            ("step 4 (resumed against uninterrupted)", at4)):
            if diffs:
                owners = sorted({d.split("(")[1].split(",")[0] for d in diffs})
                print(f"[cli] {what}: {len(diffs)} tensors differ, owned by {owners}; the first "
                      f"in module order: {diffs[:3]}")
        if worst > RESUME_LOSS_RTOL:
            raise AssertionError(f"[cli] resumed losses differ by {worst:.3g} relative")
        del snap

        # eval: the final checkpoint over the 16 images
        test_cfg = train_net.load_config(cfg_file, opts + CLI_TEST_OPTS)
        (test_set,) = build_dataset(test_cfg, test_cfg.TEST.DATASETS, is_train=False)
        t0 = time.perf_counter()
        n_loaded = sum(item["count"] for item in TestLoader(test_cfg, test_set))
        load_ms = (time.perf_counter() - t0) * 1e3 / n_loaded
        print(f"[cli] the eval loader alone: {load_ms:.1f} ms an image over {n_loaded} (PIL "
              f"decode, the cv2-rule resize in numpy to 800 rows, padding to 800x1344)")
        out = run("test_net", test_net.main,
                  ["--cfg", cfg_file, "--device", dev, "DATA_DIR", os.path.join(repo, "data"),
                   "CKPT", ck_a] + CLI_TEST_OPTS, sites * len(test_set), 0)
        results, seconds = out["results"], out["seconds"]
        if not results or len(seconds) != len(test_set):
            raise AssertionError(f"[cli] test_net: {len(results)} results, {len(seconds)} batches")
        sizes = {test_set.id_to_img_map[i]: test_set.get_img_info(i) for i in range(len(test_set))}
        for r in results:
            x, y, w, h = r["bbox"]
            info = sizes[r["image_id"]]
            # x + w - 1 is the box's last pixel (TO_REMOVE = 1)
            if not (0 <= x and 0 <= y and w >= 0 and h >= 0 and x + w - 1 < info["width"]
                    and y + h - 1 < info["height"]) or not math.isfinite(r["score"]):
                raise AssertionError(f"[cli] test_net: result {r} outside its "
                                     f"{info['width']}x{info['height']} image")
        with open(os.path.join(ck_a, "test", "bbox.json")) as f:
            if json.load(f) != results:
                raise AssertionError("[cli] bbox.json does not hold the results")
        rest = len(seconds) - 1
        print(f"[cli] test_net: {len(results)} detections over {len(test_set)} images, every box "
              f"inside its image, bbox.json parses; the first image {seconds[0] * 1e3:.1f} ms "
              f"(cuDNN plans the 800x1344 bucket), the other {rest} at "
              f"{rest / sum(seconds[1:]):.2f} img/s ({statistics.median(seconds[1:]) * 1e3:.1f} ms "
              f"median) | {card}")
        print(f"[cli] test_net AP {out['stats']['AP']:.6f} AP50 {out['stats']['AP50']:.6f} "
              f"(seeded weights after 4 steps; not a target)")
    print(f"[cli] phase took {time.perf_counter() - t_phase:.1f} s")
    return (launched["forward"], launched["backward"])

# the port's parameter names -> the reference's (model_builder.py:32-57,
# grid_cascade_rcnn.py:24-48, rpn/rpn.py:26-66): the inverse of
# cpm_tpu_torch/utils/weight_import.py, kept here and not in the package
REFERENCE_NAMES = (
    (r"^backbone\.", "Conv_Body."),
    (r"^fpn\.", "Conv_Body_FPN."),
    (r"^rpn_head\.", "RPN.head."),
    (r"^roi_head\.cls_head\.", "Grid_Cascade_RCNN.Head_cls."),
    (r"^roi_head\.cls_output\.", "Grid_Cascade_RCNN.Output_cls."),
    (r"^roi_head\.rescore_head\.", "Grid_Cascade_RCNN.Head_rescore."),
    (r"^roi_head\.rescore_output\.", "Grid_Cascade_RCNN.Output_rescore."),
    (r"^roi_head\.grid_heads\.(\d+)\.convs\.(\d+)\.", r"Grid_Cascade_RCNN.Head_grid_\1.convs.\2.0."),
    (r"^roi_head\.grid_heads\.(\d+)\.gns\.(\d+)\.", r"Grid_Cascade_RCNN.Head_grid_\1.convs.\2.1."),
    (r"^roi_head\.grid_outputs\.(\d+)\.deconv(\d)\.", r"Grid_Cascade_RCNN.Output_grid_\1.deconv_\2."),
    (r"^roi_head\.grid_outputs\.(\d+)\.(norm1|iou_fc1|iou_fc2|iou_pred)\.",
     r"Grid_Cascade_RCNN.Output_grid_\1.\2."),
)


def reference_state_dict(port_sd, conv1_rgb2bgr=False, pool_hw=(7, 7)):
    """A port state_dict as a reference CPM checkpoint holds it: the
    reference's names, BatchNorm as caffe's affine (weight and bias, no
    running statistics), and the linears over a flattened pool (fc6,
    iou_fc1) with the reference's (C, H, W) input order, where the port
    flattens (H, W, C); with conv1_rgb2bgr (cfg.MODEL.CONV1_RGB2BGR) conv1's
    input channels in the other order. Every other layout is torch's in both."""
    import re

    out = {}
    for key, value in port_sd.items():
        for pattern, repl in REFERENCE_NAMES:
            ref, n = re.subn(pattern, repl, key)
            if n:
                break
        else:
            raise KeyError(f"no reference name for {key}")
        if re.search(r"\.(fc6|iou_fc1)\.weight$", key):
            h, w = pool_hw
            value = (value.reshape(value.shape[0], h, w, -1).permute(0, 3, 1, 2)
                     .reshape(value.shape[0], -1))
        if key == "backbone.conv1.weight" and conv1_rgb2bgr:
            value = value.flip(1)
        out[ref] = value.detach().clone().contiguous()
    return out


def reference_trunk(port_sd, conv1_rgb2bgr=False):
    """The trunk of a port state_dict as an ImageNet `.pth` holds it
    (torchvision's names, caffe's affine BatchNorm)."""
    return {k[len("Conv_Body."):]: v for k, v in reference_state_dict(
        {k: v for k, v in port_sd.items() if k.startswith("backbone.")}, conv1_rgb2bgr).items()}


MS_YAML = "cfgs/rcnn/mscoco/grid_cascade/iou_helper/rescore/e2e_grid_cascade@567_rcnn_R-50-FPN_2x_ms.yaml"
# the _ms YAML's cuts for one card: the repository's synthetic COCO set, batch
# 2 at the linearly scaled rate; random weights score near 1/81, below the
# YAML's GRID_RCNN.SCORE_THRESH 0.03 and the TTA merge's FAST_RCNN one, 0.05
MS_TRAIN_OPTS = ["TRAIN.DATASETS", "('coco_debug_synthetic',)", "TRAIN.BATCH_SIZE", "2",
                 "SOLVER.BASE_LR", "0.0025"]
MS_TEST_OPTS = ["TEST.DATASETS", "('coco_debug_synthetic',)", "GRID_RCNN.SCORE_THRESH", "0.0",
                "FAST_RCNN.SCORE_THRESH", "0.0"]
MS_IMAGES = 4


def same_results(got, want, what):
    """Raise unless two lists of COCO result dicts hold the same detections
    an image: categories exactly, boxes to 1e-2 px and scores to 1e-4
    (same_detections' tolerances), paired one to one."""
    def by_image(results):
        out = {}
        for r in results:
            out.setdefault(r["image_id"], []).append((r["category_id"], r["bbox"], r["score"]))
        return out

    got, want = by_image(got), by_image(want)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: images {sorted(got)} vs {sorted(want)}")
    for img, rows in want.items():
        have = list(got[img])
        if len(have) != len(rows):
            raise AssertionError(f"{what} image {img}: {len(have)} vs {len(rows)} results")
        for cw, bw, sw in rows:
            for j, (ch, bh, sh) in enumerate(have):
                if ch == cw and max(abs(a - b) for a, b in zip(bw, bh)) <= 1e-2 and abs(sw - sh) <= 1e-4:
                    del have[j]
                    break
            else:
                raise AssertionError(f"{what} image {img}: no result matches {(cw, bw, sw)}")


def phase_ms(dev, card):
    """Phase 13: the paper's _ms YAML through the CLIs, from reference-layout
    weights. Returns the launches of kernels 1 and 2 in its in-process runs."""
    import os
    import tempfile

    import cpm_tpu_torch.engine.test as engine
    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.data.loader import TrainLoader
    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.train import create_train_state
    from cpm_tpu_torch.tools import test_net, train_net
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics
    from cpm_tpu_torch.utils.weight_import import import_resnet_backbone, trunk_layers

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(repo, MS_YAML)
    data = ["DATA_DIR", os.path.join(repo, "data")]
    cfg = train_net.load_config(cfg_file, MS_TRAIN_OPTS + data)
    test_cfg = train_net.load_config(cfg_file, MS_TEST_OPTS + data)
    stages = cfg.GRID_RCNN.CASCADE_MAPPING_OPTION.STAGE_NUM
    sites = 1 + stages + int(cfg.GRID_RCNN.RESCORE_ON)
    passes = engine.tta_passes(test_cfg)
    aug = test_cfg.TEST.BBOX_AUG
    if len(passes) != 8 or not test_cfg.TEST.SOFT_NMS.ENABLED or sites != 5:
        raise AssertionError(f"[ms] {MS_YAML}: {len(passes)} passes, soft-NMS "
                             f"{test_cfg.TEST.SOFT_NMS.ENABLED}, {sites} pooler calls a forward")
    print(f"[ms] {MS_YAML}: ResNet {tuple(cfg.BACKBONE.RESNET.LAYERS)}, CMM {stages} stages, "
          f"{sites} pooler calls a forward; TTA {len(passes)} passes (flip {aug.H_FLIP}, scales "
          f"{tuple(aug.SCALES)}, max size {aug.MAX_SIZE}), soft-NMS {test_cfg.TEST.SOFT_NMS.METHOD}, "
          f"box voting {test_cfg.TEST.BBOX_VOTE.ENABLED}; train scales {tuple(cfg.TRAIN.SCALES)}, "
          f"max size {cfg.TRAIN.MAX_SIZE}")
    fwd = ops()["multilevel"].KERNEL
    launched = dict(forward=0, backward=0)

    def run(what, fn, argv, want_fwd, want_bwd):
        reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(argv)
        seconds = time.perf_counter() - t0
        got = launch_counts()
        others = {k: v for k, v in got.items() if v and not k.startswith("multilevel_roi_align")}
        if (fwd.launches, fwd.backward_launches) != (want_fwd, want_bwd) or others:
            raise AssertionError(f"[ms] {what}: launched {got}, want multilevel_roi_align "
                                 f"{want_fwd} and its backward {want_bwd}, no other")
        launched["forward"] += fwd.launches
        launched["backward"] += fwd.backward_launches
        print(f"[ms] {what}: {seconds:.2f} s in the call, launches multilevel_roi_align "
              f"{fwd.launches}, backward {fwd.backward_launches}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (max_memory_allocated) | {card}")
        return out

    with tempfile.TemporaryDirectory(prefix="cpm_ms_") as tmp:
        # 1. reference-layout weights from seeded tensors, the frozen affines
        # folded from the loader's first batch (a random trunk with unit
        # affines diverges); and a port checkpoint of the same tensors
        t0 = time.perf_counter()
        model, optimizer, state = create_train_state(cfg, dev, cfg.SEED)
        (dataset,) = build_dataset(cfg, cfg.TRAIN.DATASETS, is_train=True)
        first = next(iter(TrainLoader(cfg, dataset, cfg.TRAIN.BATCH_SIZE, seed=cfg.SEED, prefetch=0)))
        n_folded = fold_batch_statistics(model, first["images"])
        port_sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
        ck_port = os.path.join(tmp, "port")
        CheckPointer(ck_port).save(state, 0)
        del model, optimizer, state
        whole_pth, trunk_pth = os.path.join(tmp, "model_final.pth"), os.path.join(tmp, "trunk.pth")
        whole = reference_state_dict(port_sd, cfg.MODEL.CONV1_RGB2BGR)
        families = sorted({k.split(".")[0] for k in whole})
        if families != ["Conv_Body", "Conv_Body_FPN", "Grid_Cascade_RCNN", "RPN"]:
            raise AssertionError(f"[ms] reference checkpoint key families {families}")
        torch.save({"model": whole}, whole_pth)
        trunk = reference_trunk(port_sd, cfg.MODEL.CONV1_RGB2BGR)
        torch.save(trunk, trunk_pth)
        imported = import_resnet_backbone(trunk_pth, trunk_layers(cfg), cfg.MODEL.CONV1_RGB2BGR)
        wrong = [k for k, v in imported.items() if not torch.equal(v, port_sd[k])]
        if wrong or len(imported) != sum(k.startswith("backbone.") for k in port_sd):
            raise AssertionError(f"[ms] the imported trunk differs from its tensors: {wrong[:5]}")
        print(f"[ms] weights in {time.perf_counter() - t0:.2f} s: {n_folded} frozen affines folded "
              f"from the loader's first batch {tuple(first['images'].shape)}; {len(whole)} tensors "
              f"in a reference CPM checkpoint ({os.path.getsize(whole_pth) / 2**20:.1f} MiB, "
              f"{families}), {len(trunk)} in a caffe-style trunk ({os.path.getsize(trunk_pth) / 2**20:.1f} "
              f"MiB); the trunk imports to the bit")
        del whole, trunk, imported

        # 2. test_net over images 0-4, 8 passes each: from the port checkpoint
        # with each forward and merge timed on its own (a synchronise before
        # and after; the first forward of a bucket plans cuDNN's algorithms),
        # then from the .pth as TEST.WEIGHTS, the loop pipelined as it runs
        want = sites * len(passes) * MS_IMAGES
        base = ["--cfg", cfg_file, "--device", dev, "--range", "0", str(MS_IMAGES)] + data + MS_TEST_OPTS
        timed = dict(forward=[], merge=[], merged=[])

        def timing(fn, kind):
            def wrapped(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if kind == "forward":
                    timed["forward"].append((tuple(np.shape(args[0])[1:3]), ms))
                else:
                    timed["merge"].append(ms)
                    timed["merged"].append({f: v.cpu() for f, v in out.items()})
                return out
            return wrapped

        real_make, real_merge = engine.make_forward_fn, engine.merge_tta_detections
        engine.make_forward_fn = lambda *a: timing(real_make(*a), "forward")
        engine.merge_tta_detections = timing(real_merge, "merge")
        try:
            from_ckpt = run("test_net CKPT (each forward and merge synchronised)", test_net.main,
                            base + ["CKPT", ck_port], want, 0)
        finally:
            engine.make_forward_fn, engine.merge_tta_detections = real_make, real_merge
        del from_ckpt["model"]
        from_pth = run("test_net TEST.WEIGHTS .pth", test_net.main,
                       base + ["CKPT", os.path.join(tmp, "pth"), "TEST.WEIGHTS", whole_pth], want, 0)
        got_sd = from_pth["model"].state_dict()
        wrong = [k for k in port_sd if not torch.equal(got_sd[k].cpu(), port_sd[k])]
        if wrong or sorted(got_sd) != sorted(port_sd):
            raise AssertionError(f"[ms] the imported model differs from its tensors: {wrong[:5]}")
        del from_pth["model"], got_sd
        seconds = from_pth["seconds"]
        if from_ckpt["results"] != from_pth["results"]:
            raise AssertionError("[ms] detections from the imported .pth differ from those of the "
                                 "port checkpoint of the same tensors")
        (test_set,) = build_dataset(test_cfg, test_cfg.TEST.DATASETS, is_train=False)
        n_dets = []
        for i, merged in enumerate(timed["merged"]):
            info = test_set.get_img_info(i)
            m = merged["mask"][0]
            b, lab = merged["boxes"][0][m], merged["labels"][0][m]
            # a box clipped to an up-scaled image's last pixel maps back past
            # the original's last one by less than a pixel
            inside = ((b[:, 0] >= 0) & (b[:, 1] >= 0) & (b[:, 2] < info["width"])
                      & (b[:, 3] < info["height"]))
            if (not m.any() or not torch.isfinite(b).all() or not inside.all()
                    or not torch.isfinite(merged["scores"][0][m]).all()
                    or not ((lab >= 1) & (lab <= cfg.MODEL.NUM_CLASSES - 1)).all()):
                raise AssertionError(f"[ms] image {i}: merged detections {merged}")
            n_dets.append(int(m.sum()))
        if len(timed["merged"]) != MS_IMAGES or len(timed["forward"]) != len(passes) * MS_IMAGES:
            raise AssertionError(f"[ms] {len(timed['forward'])} forwards, {len(timed['merged'])} merges")
        print(f"[ms] test_net: {len(from_pth['results'])} results over images 0-{MS_IMAGES}, the "
              f"TEST.WEIGHTS run bit-equal to the CKPT run; merged sets of {n_dets} detections, "
              f"finite, inside each image, labels in 1..{cfg.MODEL.NUM_CLASSES - 1}")
        by_bucket = {}
        for hw, ms in timed["forward"]:
            by_bucket.setdefault(hw, []).append(ms)
        for hw, times in by_bucket.items():
            rest = (f", the other {len(times) - 1} {statistics.median(times[1:]):.1f} ms median "
                    f"({min(times[1:]):.1f}-{max(times[1:]):.1f})" if len(times) > 1 else "")
            print(f"[ms] forward at bucket {hw[0]}x{hw[1]} (batch 1): the first {times[0]:.1f} ms "
                  f"(cuDNN plans){rest} | {card}")
        print(f"[ms] TTA merge (soft-NMS over {len(passes)} passes' detections, on the card): "
              f"{statistics.median(timed['merge']):.2f} ms an image median "
              f"({min(timed['merge']):.2f}-{max(timed['merge']):.2f}) | {card}")
        print(f"[ms] wall time an image, from loading to results on the host (the pipelined loop, "
              f"TEST.WEIGHTS run, the buckets planned): {statistics.median(seconds) * 1e3:.1f} ms "
              f"median ({', '.join(f'{s * 1e3:.1f}' for s in seconds)}) | {card}")

        # 3. --shards 2 over the same images: children of the CLI, in waves
        # of the card count
        ck_shard = os.path.join(tmp, "shards")
        t0 = time.perf_counter()
        sharded = run("test_net --shards 2", test_net.main,
                      ["--cfg", cfg_file, "--device", dev, "--shards", "2", "--range", "0",
                       str(MS_IMAGES)] + data + MS_TEST_OPTS
                      + ["CKPT", ck_shard, "TEST.WEIGHTS", whole_pth], 0, 0)
        same_results(sharded["results"], from_pth["results"], "[ms] --shards 2 against one process")
        name = torch.cuda.get_device_name(0)
        for s, e in engine.shard_ranges(MS_IMAGES, 2):
            with open(os.path.join(ck_shard, "test", f"shard_{s}_{e}.log")) as f:
                log = f.read()
            if name not in log:
                raise AssertionError(f"[ms] shard [{s}, {e}) names no {name}:\n{log[-2000:]}")
        print(f"[ms] --shards 2: {time.perf_counter() - t0:.2f} s for two children run one after "
              f"the other (one card), results equal the single process's (categories exactly, "
              f"boxes 1e-2 px, scores 1e-4), each child's log names the {name}")

        # 4. train_net from the caffe-style trunk, 2 steps on the YAML's
        # multi-scale buckets
        ck_train = os.path.join(tmp, "train")
        history = run("train_net TRAIN.WEIGHTS 2 steps", train_net.main,
                      ["--cfg", cfg_file, "--device", dev] + MS_TRAIN_OPTS + data
                      + ["CKPT", ck_train, "TRAIN.WEIGHTS", trunk_pth, "SOLVER.MAX_ITER", "2",
                         "SOLVER.SNAPSHOT_ITERS", "2"], 2 * sites, 2 * sites)
        losses = [k for k in history[0] if k.startswith("loss_")]
        for r in history:
            if len(losses) != 8 or not all(math.isfinite(r[k]) for k in losses + ["total_loss"]):
                raise AssertionError(f"[ms] train_net iter {r['iter']}: {r}")
            print(f"[ms] train_net iter {r['iter']}: step {r['step_s'] * 1e3:.1f} ms, total_loss "
                  f"{r['total_loss']:.4f}, " + ", ".join(f"{k[5:]} {r[k]:.4f}" for k in losses))
        after = torch.load(os.path.join(ck_train, "model_latest"), map_location="cpu",
                           weights_only=True)["model"]
        moved = [k for k in frozen if not torch.equal(after[k], port_sd[k])]
        if moved or len(history) != 2:
            raise AssertionError(f"[ms] frozen trunk tensors moved from the import: {moved[:5]}")
        print(f"[ms] train_net: {len(frozen)} frozen trunk tensors bit-equal to the imported ones "
              f"after {len(history)} steps")
    print(f"[ms] phase took {time.perf_counter() - t_phase:.1f} s | {card}")
    return (launched["forward"], launched["backward"])


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
    cli = phase_cli(dev, card)
    torch.cuda.empty_cache()
    ms = phase_ms(dev, card)

    # launches on the driven paths: eval forwards plus training steps, and
    # the CLIs' runs
    launches = {
        "multilevel_roi_align": (fwd["auto"]["launches"] + bwd["auto"]["launches"][0]
                                 + x101_fwd["pooler_launches"] + x101_bwd["pooler_launches"][0]
                                 + cli[0] + ms[0]),
        "multilevel_roi_align_backward": (bwd["auto"]["launches"][1] + bwd["clustered"]["launches"][1]
                                          + x101_bwd["pooler_launches"][1] + cli[1] + ms[1]),
        "clustered_roi_align": fwd["clustered"]["launches"] + bwd["clustered"]["launches"][0],
        "cluster_rois": fwd["clustered"]["grouping"]["launches"] + bwd["clustered"]["grouping_launches"],
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
        "cluster_rois": (fwd["clustered"]["grouping"], [r["grouping"] for r in synthetic["clustered"]]),
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
