"""Chip smoke test: drives the port's eval and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

0. device: requires CUDA; prints the card's name and power limit, the torch
   and CUDA versions, and whether yaml and PIL import.
1. build: builds the eight CUDA sources of cpm_tpu_torch/csrc with nvcc, one
   process each, all started together, then the native host decode library
   (cpm_tpu_torch/native) with g++ (twelve kernels: multilevel forward and
   backward, stacked forward and backward, clustered forward and its
   grouping, single-level forward, deformable-conv sampler forward and
   backward, cross-roi shared-window forward, the NMS kernels' pair (mask
   and sweep) and the RPN's candidates).
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
7. single-level path: a `Pooler` over one synthetic C4 map, driven
   directly forward and backward, held against the plain version and, bit
   for bit, against the multilevel kernel at one level on the same f32 map
   (phase 15 drives the models whose paths reach it).
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
14. cascade: the Cascade R-CNN and Fast R-CNN families at full width
   (ResNet-50, FPN 256, 81 classes, 7x7 pooling). The paper's cascade YAML
   cfgs/rcnn/mscoco/cascade/ISM+RSM/e2e_cascade_rcnn@2_R-50-FPN_1x.yaml (2
   stages, ISM merged, RSM: 3 pooler calls a forward) through the CLIs over
   the synthetic set: train_net from a seeded caffe-style trunk .pth with
   folded affines (TRAIN.WEIGHTS), batch 2 at SOLVER.BASE_LR 0.0025, 4 steps
   with snapshots (its 8 losses finite, 3 + 3 launches of kernels 1 and 2 a
   step and none of any other, the frozen trunk bit-equal to the import
   after the steps), then test_net from that checkpoint over the 16 images
   at batch 1 with FAST_RCNN.SCORE_THRESH 0.0 (3 launches of kernel 1 an
   image; every detection finite, inside its image, labelled 1..80; random
   weights may leave an image none, since ISM multiplies the score by an
   IoU logit near 0 of either sign; bbox.json parses). Then the same model
   through make_forward_fn: 10 timed batch-1 requests at 800x1344 after a
   warm-up, 3 launches each; and the kernel checks of phases 2 and 2b on
   the inputs of its 3 pooler calls of one eval forward and of one
   training step, forward and backward. The Faster R-CNN YAML,
   cfgs/rcnn/mscoco/faster/e2e_faster_rcnn_R-50-FPN_1x.yaml, through
   build_model / make_forward_fn / make_train_step: 10 timed batch-1
   requests (1 launch each), and 2 steps at batch 2 after a warm-up (4
   finite losses, 1 + 1 launches a step). Last, the tiny Cascade R-CNN (3
   stages, ISM, RSM) and the tiny Fast R-CNN in f32 on the card against the
   CPU port: detections (same_detections) and one training forward's
   losses on the same batch and draws (1e-4 relative). It prints the
   latencies (median and range), the step times, the peak memory, the eval
   CLI's images per second after the first image, and the phase's time.

15. options: the eleven grid-cascade YAMLs of the paper's ablations as
   shipped (cfgs/rcnn/mscoco/grid_cascade/ offset_on, enhance_features,
   extend_roi x2, finest_level_roi, resize_roi, se, random_jitter x2,
   bretter_roi x2: ResNet-50, FPN 256, 81 classes, the 600x1000 bucket as
   608x1024 maps) and R-50-C4 Faster R-CNN with resnet_c5_head and
   resnet_2mlp_head (cfgs/debug/tiny_fast_rcnn_c4.yaml taken to the values
   of Detectron's e2e_faster_rcnn_R-50-C4_1x.yaml, C4_OPTS; 800x1344), each
   built from seed 0 in bf16 over f32 masters with folded trunk affines: one
   batch-1 eval forward and one batch-2 training step, each held to the
   launches `pooler_sites` predicts (FINEST_LEVEL_ROI's stages and the C4
   heads pool one level: kernel 5, whose backward is kernel 2 at one level),
   finite losses and detections inside their images labelled 1..80, frozen
   tensors bit-equal and a tensor of every group moved. finest_level_roi/
   and the C5 head also: 10 timed batch-1 requests after a warm-up, 3
   timed steps, peaks, and kernel 5 at the sites of one eval forward and one
   step (against its plain version, event and device time, bound, and the
   wrapper's bf16->f32 cast of the map). Then kernel 5's backward with NaN
   boxes in masked rows (finite, bit-equal to the gradient without them),
   resize_roi/ through train_net (4 steps from a caffe-style trunk .pth)
   and test_net over the 16 synthetic images, and the tiny option and C4
   models on the card against the CPU port (the C4 ones with their
   near-tied seeded scores spread from a seed, `spread_c4_scores`).
16. data parallel (cpm_tpu_torch/parallel/): the headline YAML at full width
   (R-50-FPN, 800x1344, CMM with 2 stages, ISM, RSM) from a step-0 state with
   the 53 frozen affines folded from the loader's first batch, as phase 12
   starts. (a) Two ranks spawned (the spawn start method: CUDA is live here)
   share cuda:0 over an explicit gloo group with a file:// store, one image
   each, in f32 with TF32 off; their first step is held against this
   process's batch-2 step on the same two images and draws
   (cpm_tpu_torch/tools/check_data_parallel.py's `hold_ranks`: LOSS_RTOL,
   PARAM_RTOL / PARAM_ATOL), their parameters must be bit-equal after each
   of DP_STEPS steps, each launches kernels 1 and 2 4 + 4 times a step and
   compiles nothing (it loads phase 1's libraries); it prints the 2-rank
   step's wall time, the train_step/allreduce span and the step's
   torch.distributed calls, two ranks sharing one card over gloo, not a
   scaling figure. (b) train_net.main, 2
   steps, under torchrun's variables set in this process (WORLD_SIZE 1:
   an NCCL group on the card), bit-equal to the same 2 steps without a
   group. (c) ADAM and RMSPROP on the tiny model: two steps on the card
   against the CPU port (losses 1e-4 relative), and the optimizer alone on
   the same seeded gradients (OPT_RTOL / OPT_ATOL). A rank that fails, or
   does not finish in time, fails the phase; the others are killed.
17. zoo: the trunk and neck options (ZOO_MODELS: GN+WS, GN+WS Faster R-CNN
   with the WS 4conv1fc head, NAS-FPN, BiFPN, HRFPN, ResNet-D with GC
   blocks and extra FPN conv levels, aligned blocks, ResNet-18) at
   800x1344 (BiFPN at 768x1344: ZOO_BUCKET) from the flagship (or the
   Faster R-CNN YAML), bf16, seeded
   weights with the frozen affines folded: one batch-1 eval forward and
   one batch-2 step each, launching exactly what `pooler_sites` predicts
   (kernel 1 a pooler call, kernel 2 a call of a step); finite losses that
   sum to total_loss, detections inside their images with labels 1..80,
   frozen tensors bit-equal and a tensor of every parameter group (and of
   each model's new modules: the FPN's norms, the fusion weights, the GC
   blocks, ...) moved; gn_ws, nasfpn and bifpn timed over 10 batch-1
   requests; each step's peak memory; the tiny twins on the card against
   the CPU port.
18. rest (`phase_rest`): what cpm_tpu_torch/ gained for the rest of
   cpm_tpu/, none of it on a model path and none a kernel of its own (plain
   PyTorch, as the JAX package runs it as XLA ops): on the card against the
   CPU port on the same inputs, at the CPU tests' tolerances (REST_F32,
   REST_CONV, REST_ROT; atol per unit of RMS above 1; the layers with a
   convolution held in f64 and timed in f32), each timed with CUDA events: roi_pool at 7x7 over 512 rois of the C4 map (bins past its
   8-cell lattice included; the CPU runs 16 of them),
   pool_points_interp on 9000 points of a P2 map, roi_align_rotated over
   512 rotated rois, box_iou_rotated 2000 x 2000, nms_rotated and poly_nms
   over 2000 boxes at 0.7 (keep sets equal save for threshold ties),
   matrix_nms over 500 boxes of 80 labels, sigmoid_focal_loss over the 1.6M
   anchors of a batch-2 800x1344 RetinaNet by 80 classes and lovasz_softmax
   over [2, 21, 512, 512], each with its backward, and every layer of the
   zoo forward and backward on a res4 map [2, 1024, 50, 84] (SplAtConv2d on
   [2, 256, 100, 168]). SyncBatchNorm over two gloo ranks spawned on the
   card against one process over the whole batch (spawned at the phase's
   start, checked at its end). The flagship built under MODEL.INIT_SCHEME tpu (the
   heatmap deconvs' prior biases checked): flops_and_params of its batch-1
   eval forward at 800x1344, its parameter count equal to the JAX
   package's (utils/measure.py::FLAGSHIP_JAX_PARAMS), and one training step
   with finite losses. The heaviest CPU references (roi_pool, both NMS, the
   focal loss) run on a thread beside the card's work. The flagship runs'
   launches of kernels 1 and 2 count on the driven paths.
19. native (`phase_native`): the native host decode pool
   (cpm_tpu_torch/native, built by g++ in phase 1 beside the CUDA sources),
   which both loaders take whenever it builds. It prints whether the library
   built, by which route (the system's libjpeg and libpng, or, where g++
   finds no jpeglib.h / png.h, the ones Pillow's wheel carries, through the
   headers in cpm_tpu_torch/native/include) and how long g++ took; a failed
   build fails the run where g++ and one route are present, and only where
   none is does the phase print `native decode: not built: <why>` and go
   on. Then phase 12's
   headline YAML through `train_net.main` (4 steps at batch 2 over
   data/synthetic_debug, from a step-0 checkpoint with the frozen affines
   folded from the loader's first batch) and `test_net.main` over the 16
   images: each must print `decode path: native`, with finite losses, 4 + 4
   launches of kernels 1 and 2 a step, 4 of kernel 1 an image, and every
   detection inside its image. Last, the host's time to make one train
   batch and to load one eval image on the native path and on the PIL path
   (a loader told `native = None`), beside the card's name and power limit.
20. nms (`phase_nms`): the NMS kernels (ops/cuda/nms.py) against the fixed
   point (`tools/probe_nms.py::fixed_point_nms`) and the RPN's candidate
   kernel (ops/cuda/rpn_candidates.py) against its plain version
   (`modeling/rpn.py::level_candidates_plain`), bit for bit, on the rows of
   the benchmark cells' proposal selection (1 x 5 rows of 1000 candidates,
   4 x 5 of 2000) and of the detection filter (1 row of 1024, label
   offsets, 100 slots); `select_proposals` against the per-level loop
   (`per_level_select`) bit for bit at both cells' shapes, with its ATen
   ops and host time beside the loop's; each kernel's CUDA-event time
   beside its plain version's and its bound (bytes). Phases 3 and 5 also
   hold every request to 2 NMS calls (the RPN's, the filter's) and 1
   candidate launch, every step to 1 and 1, with the fixed point forbidden
   on the card.

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

import concurrent.futures
import contextlib
import copy
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
# the twelve kernels: name -> (source, the TPU kernel it replaces)
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
    # the JAX package's NMS is a lax.while_loop of XLA ops, not a Pallas kernel
    "nms": ("cpm_tpu_torch/csrc/nms.cu", "cpm_tpu/ops/nms.py:48"),
    # and its proposal selection's decode, clip and mask are XLA ops
    "rpn_candidates": ("cpm_tpu_torch/csrc/rpn_candidates.cu", "cpm_tpu/modeling/rpn.py:198"),
}
# NMS calls and candidate launches that phases 3 and 5 held to their count
NMS_DRIVEN = {"nms": 0, "rpn_candidates": 0}
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
    """The eight wrapper modules, imported when first needed."""
    from cpm_tpu_torch.ops.cuda import (
        clustered_roi_align,
        crossroi_roi_align,
        deform_sample,
        multilevel_roi_align,
        nms,
        roi_align,
        rpn_candidates,
        stacked_roi_align,
    )

    return dict(multilevel=multilevel_roi_align, stacked=stacked_roi_align,
                clustered=clustered_roi_align, single=roi_align, deform=deform_sample,
                crossroi=crossroi_roi_align, nms=nms, rpn_candidates=rpn_candidates)


def nms_launches():
    """(NMS calls, RPN candidate launches) so far, as their wrappers count them."""
    m = ops()
    return m["nms"].KERNEL.launches, m["rpn_candidates"].KERNEL.launches


def held_to_nms_launches(tag, before, want):
    """Raise unless the NMS calls and candidate launches since `before` (a
    `nms_launches()`) are `want`; count them as driven."""
    now = nms_launches()
    got = (now[0] - before[0], now[1] - before[1])
    if got != want:
        raise AssertionError(f"{tag}: NMS calls and candidate launches {got}, want {want}")
    NMS_DRIVEN["nms"] += got[0]
    NMS_DRIVEN["rpn_candidates"] += got[1]


@contextlib.contextmanager
def fixed_point_forbidden():
    """Raise where the plain NMS fixed point runs on the card: every NMS of
    the flagship's paths takes the kernels there."""
    from cpm_tpu_torch.ops import nms as nms_mod

    real = nms_mod._sorted_keep_mask

    def guard(iou, valid, thresh):
        if iou.device.type == "cuda":
            raise AssertionError("the NMS fixed point ran on the card")
        return real(iou, valid, thresh)

    nms_mod._sorted_keep_mask = guard
    try:
        yield
    finally:
        nms_mod._sorted_keep_mask = real


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


def device_text(ms, bound_ms=None):
    """A device time from `compare_kernels.device_ms(..., or_none=True)` as
    text, beside its bound where one is given: "not measured" where the
    profiler recorded nothing."""
    if ms is None:
        return "not measured (torch.profiler recorded no device time)"
    return f"{ms:.4f} ms" + ("" if bound_ms is None else f", {ms / bound_ms:.2f}x its bound")


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


def check_detections(dets, sizes, batch, num_classes, max_dets, allow_empty=False):
    """Raise unless the detections have their fixed shapes and every valid
    one is finite, inside its image and labelled 1..num_classes - 1; and,
    unless `allow_empty`, each image has one. Boxes are clipped in their own
    dtype: the Cascade head's are in the compute dtype (as in the JAX
    package), so under bf16 a box ends at most at the image's size rounded
    to bf16, less one, in bf16 (1336 in a 1333-wide image). Returns the
    images' counts."""
    boxes, scores = dets.boxes.float().cpu(), dets.scores.float().cpu()
    labels, mask = dets.labels.cpu(), dets.mask.cpu()
    if tuple(boxes.shape) != (batch, max_dets, 4) or tuple(scores.shape) != (batch, max_dets):
        raise AssertionError(f"detection shapes {tuple(boxes.shape)} {tuple(scores.shape)}")
    if tuple(labels.shape) != (batch, max_dets) or tuple(mask.shape) != (batch, max_dets):
        raise AssertionError("label or mask shape")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("non-finite detections")

    def last(n):  # the clip's bound in the boxes' dtype (structures/boxes.py)
        return float(torch.tensor(float(n), dtype=dets.boxes.dtype) - 1.0)

    counts = mask.sum(1).tolist()
    for i, (h, w) in enumerate(sizes.tolist()):
        m = mask[i]
        if not (m.any() or allow_empty):
            raise AssertionError(f"image {i}: no valid detection")
        b = boxes[i][m]
        inside = (b[:, 0] >= 0) & (b[:, 2] <= last(w)) & (b[:, 1] >= 0) & (b[:, 3] <= last(h))
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
        calls.append(keep(*args, **kwargs))
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
        before, builds, nms_before = launch_counts(), stack_builds(), nms_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fixed_point_forbidden():
            dets = forward(images, sizes)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        latencies.append(dt)
        launched = launched_since(before)
        built = stack_builds() - builds
        counts = check_detections(dets, sizes, images.shape[0], nc, max_dets)
        if launched != want_launches:
            raise AssertionError(f"{tag} request {i}: launched {launched}, want {want_launches}")
        # the RPN's NMS and the detection filter's, over the whole batch each
        held_to_nms_launches(f"{tag} request {i}", nms_before, (2, 1))
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
        nms_before = nms_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fixed_point_forbidden():
            state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        held_to_nms_launches(f"{tag} step {i}", nms_before, (1, 1))
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
            ms = device_ms([(half, prep, r["group"], pool, 2)], ops()["crossroi"].KERNEL,
                           or_none=True)
            print(f"[cross-roi device] G={r['group']} {pool[0]}x{pool[1]} bf16: device time "
                  f"{device_text(ms, r['bound_ms'])} (event {r['ms']:.4f} ms), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}: the distinct map cells weighed) "
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


def _batches(loader, n):
    """The first `n` batches of a loader, its iterator closed after them
    (which closes a TrainLoader's native pool)."""
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


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
        first_loader = TrainLoader(cfg, dataset, cfg.TRAIN.BATCH_SIZE, seed=cfg.SEED, prefetch=0)
        first = _batches(first_loader, 1)[0]
        make_ms = (time.perf_counter() - t1) * 1e3
        n_folded = fold_batch_statistics(model, first["images"])
        for ckpt in (ck_a, ck_b):
            CheckPointer(ckpt).save(state, 0)
        del model, optimizer, state
        torch.cuda.empty_cache()
        print(f"[cli] step-0 checkpoint in {time.perf_counter() - t0:.2f} s: {n_folded} frozen "
              f"affines folded from the loader's first batch {tuple(first['images'].shape)} "
              f"{first['images'].dtype}, {len(dataset)} images; the loader made that batch in "
              f"{make_ms:.1f} ms on this thread ({first_loader.decode_path} decode, resize, "
              f"flip, padding)")

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
        test_loader = TestLoader(test_cfg, test_set)
        n_loaded = sum(item["count"] for item in test_loader)
        load_ms = (time.perf_counter() - t0) * 1e3 / n_loaded
        print(f"[cli] the eval loader alone: {load_ms:.1f} ms an image over {n_loaded} "
              f"({test_loader.decode_path} decode, the cv2-rule resize to 800 rows, padding to "
              f"800x1344)")
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
    (r"^roi_head\.grid_heads\.(\d+)\.([fs]order)\.(\d+)_(\d+)\.dw\.",
     r"Grid_Cascade_RCNN.Head_grid_\1.\2_trans.\3.\4.0."),
    (r"^roi_head\.grid_heads\.(\d+)\.([fs]order)\.(\d+)_(\d+)\.pw\.",
     r"Grid_Cascade_RCNN.Head_grid_\1.\2_trans.\3.\4.1."),
    (r"^roi_head\.grid_heads\.(\d+)\.(offset_conv|offset_fc)\.",
     r"Grid_Cascade_RCNN.Head_grid_\1.\2."),
    (r"^roi_head\.grid_outputs\.(\d+)\.deconv(\d)\.", r"Grid_Cascade_RCNN.Output_grid_\1.deconv_\2."),
    (r"^roi_head\.grid_outputs\.(\d+)\.(norm1|iou_fc1|iou_fc2|iou_pred)\.",
     r"Grid_Cascade_RCNN.Output_grid_\1.\2."),
)


def reference_state_dict(port_sd, conv1_rgb2bgr=False, pool_hw=(7, 7)):
    """A port state_dict as a reference CPM checkpoint holds it: the
    reference's names, BatchNorm as caffe's affine (weight and bias, no
    running statistics), and the linears over a flattened pool (fc6,
    iou_fc1, and OFFSET_ON's offset_fc over the 7x7 offset conv) with the
    reference's (C, H, W) input order, where the port flattens (H, W, C);
    with conv1_rgb2bgr (cfg.MODEL.CONV1_RGB2BGR) conv1's input channels in
    the other order. Every other layout is torch's in both."""
    import re

    out = {}
    for key, value in port_sd.items():
        for pattern, repl in REFERENCE_NAMES:
            ref, n = re.subn(pattern, repl, key)
            if n:
                break
        else:
            raise KeyError(f"no reference name for {key}")
        if re.search(r"\.(fc6|iou_fc1)\.weight$", key) or key.endswith(".offset_fc.weight"):
            h, w = (7, 7) if key.endswith(".offset_fc.weight") else pool_hw
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


CASCADE_YAML = "cfgs/rcnn/mscoco/cascade/ISM+RSM/e2e_cascade_rcnn@2_R-50-FPN_1x.yaml"
FASTER_YAML = "cfgs/rcnn/mscoco/faster/e2e_faster_rcnn_R-50-FPN_1x.yaml"
# the YAMLs' cuts for one card: the repository's synthetic COCO set, batch 2
# at the linearly scaled rate; random weights score near 1/81, below the
# YAMLs' FAST_RCNN.SCORE_THRESH 0.05
CASCADE_TRAIN_OPTS = ["TRAIN.DATASETS", "('coco_debug_synthetic',)", "TRAIN.BATCH_SIZE", "2",
                      "SOLVER.BASE_LR", "0.0025", "SOLVER.MAX_ITER", "4",
                      "SOLVER.SNAPSHOT_ITERS", "2"]
CASCADE_TEST_OPTS = ["TEST.DATASETS", "('coco_debug_synthetic',)", "FAST_RCNN.SCORE_THRESH", "0.0"]
N_LATENCY = 10  # timed batch-1 requests a model, after one warm-up


def counted_run(tag, what, fn, want, card):
    """fn() with the launch counters at 0; raise unless it launched exactly
    `want` (kernel name -> launches, the others none). Returns (fn's
    result, its seconds)."""
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = {k: v for k, v in launch_counts().items() if v}
    if got != want:
        raise AssertionError(f"{tag} {what}: launched {got}, want {want}")
    print(f"{tag} {what}: {seconds:.2f} s, launches {got}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (max_memory_allocated) | {card}")
    return out, seconds


def eval_latency(tag, forward, check, sites, card, padded=(800, 1344)):
    """The launch counters at 0, then N_LATENCY timed batch-1 requests (at
    800x1344, or in the `padded` bucket) after a warm-up, each checked by
    check(dets, sizes) and for `sites` launches (of kernel 1, or a dict of
    kernel name -> launches) and no other; prints the median and range of
    their latencies and returns the first request."""
    from cpm_tpu_torch.tools.profile_eval import make_request

    want = sites if isinstance(sites, dict) else {"multilevel_roi_align": sites}
    reset_launch_counts()
    rng = np.random.RandomState(7)
    ph, pw = padded
    forward(*make_request(rng, [(ph, pw - 11)], padded))
    hws = [(ph, pw - 11), (ph, pw * 4 // 5), (ph, pw - 144), (ph - 50, pw), (ph, pw)]
    requests = [make_request(rng, [hws[i % len(hws)]], padded) for i in range(N_LATENCY)]
    latencies = []
    torch.cuda.reset_peak_memory_stats()
    for images, sizes in requests:
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = forward(images, sizes)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        launched = launched_since(before)
        if launched != want:
            raise AssertionError(f"{tag} batch-1 request: launched {launched}, want {want}")
        check(dets, sizes)
    print(f"{tag} batch-1 eval latency median {statistics.median(latencies):.2f} ms "
          f"({min(latencies):.2f}-{max(latencies):.2f}) over {N_LATENCY} requests at "
          f"{ph}x{pw}, launches {want} each; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB | {card}")
    return requests[0]


def phase_cascade(dev, card):
    """Phase 14: the Cascade R-CNN ISM+RSM YAML through the CLIs from a
    caffe-style trunk, then directly with the Faster R-CNN YAML at full
    width, kernels 1 and 2 checked at the cascade's pooler sites, and both
    families at a tiny width on the card against the CPU port. Returns the
    launches of kernels 1 and 2 in its driven runs."""
    import os
    import tempfile

    import cpm_tpu_torch.engine.test as engine
    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.data.loader import TrainLoader
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools import test_net, train_net
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics
    from cpm_tpu_torch.utils.weight_import import import_resnet_backbone, trunk_layers

    tag = "[cascade]"
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(repo, CASCADE_YAML)
    data = ["DATA_DIR", os.path.join(repo, "data")]
    cfg = train_net.load_config(cfg_file, CASCADE_TRAIN_OPTS + data)
    cc = cfg.CASCADE_RCNN
    sites = cc.NUM_STAGE + int(cc.RESCORE_ON)
    losses = (["loss_objectness", "loss_rpn_box_reg"]
              + [f"s{s + 1}_{k}_loss" for s in range(cc.NUM_STAGE) for k in ("cls", "bbox")]
              + [f"loss_iou_{cc.NUM_STAGE}", "loss_rescore"])
    if sites != 3 or len(losses) != 8 or not (cc.IOU_HELPER and cc.IOU_HELPER_MERGE):
        raise AssertionError(f"{tag} {CASCADE_YAML}: {sites} pooler calls, losses {losses}")
    print(f"{tag} {CASCADE_YAML}: ResNet {tuple(cfg.BACKBONE.RESNET.LAYERS)}, FPN {cfg.FPN.DIM}, "
          f"{cfg.MODEL.NUM_CLASSES} classes, {cc.NUM_STAGE} stages at IoU {tuple(cc.FG_IOU_THRESHOLD)}, "
          f"ISM merged, RSM; {sites} pooler calls a forward at "
          f"{tuple(cfg.FAST_RCNN.ROI_XFORM_RESOLUTION)}, sampling ratio "
          f"{cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO}; overrides {CASCADE_TRAIN_OPTS}")
    launched = dict(forward=0, backward=0)

    def tally(counts):
        launched["forward"] += counts.get("multilevel_roi_align", 0)
        launched["backward"] += counts.get("multilevel_roi_align_backward", 0)

    with tempfile.TemporaryDirectory(prefix="cpm_cascade_") as tmp:
        # 1. a caffe-style trunk .pth from seeded weights, its frozen affines
        # folded from the loader's first batch
        model, _, _ = create_train_state(cfg, dev, cfg.SEED)
        (dataset,) = build_dataset(cfg, cfg.TRAIN.DATASETS, is_train=True)
        first = next(iter(TrainLoader(cfg, dataset, cfg.TRAIN.BATCH_SIZE, seed=cfg.SEED, prefetch=0)))
        n_folded = fold_batch_statistics(model, first["images"])
        port_sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        frozen = sorted(n for n, p in model.named_parameters() if not p.requires_grad)
        del model
        trunk_pth = os.path.join(tmp, "trunk.pth")
        torch.save(reference_trunk(port_sd, cfg.MODEL.CONV1_RGB2BGR), trunk_pth)
        imported = import_resnet_backbone(trunk_pth, trunk_layers(cfg), cfg.MODEL.CONV1_RGB2BGR)
        if any(not torch.equal(v, port_sd[k]) for k, v in imported.items()):
            raise AssertionError(f"{tag} the imported trunk differs from its tensors")
        print(f"{tag} a caffe-style trunk .pth of {len(imported)} tensors, {n_folded} frozen "
              f"affines folded from the loader's first batch; it imports to the bit")

        # 2. train_net from the trunk: 4 steps, a snapshot every 2
        ckpt = os.path.join(tmp, "ckpt")
        argv = (["--cfg", cfg_file, "--device", dev] + CASCADE_TRAIN_OPTS + data
                + ["CKPT", ckpt, "TRAIN.WEIGHTS", trunk_pth])
        history, _ = counted_run(tag, "train_net 4 steps", lambda: train_net.main(argv),
                                 {"multilevel_roi_align": 4 * sites,
                                  "multilevel_roi_align_backward": 4 * sites}, card)
        tally(launch_counts())
        for r in history:
            got = sorted(k for k in r if k in losses or k.startswith("loss_"))
            if got != sorted(losses) or not all(math.isfinite(r[k]) for k in losses):
                raise AssertionError(f"{tag} train_net iter {r['iter']}: {r}")
            print(f"{tag} train_net iter {r['iter']}: step {r['step_s'] * 1e3:.1f} ms, loader wait "
                  f"{r['wait_s'] * 1e3:.1f} ms, total_loss {r['total_loss']:.4f}, "
                  + ", ".join(f"{k} {r[k]:.4f}" for k in losses))
        steps = [r["step_s"] * 1e3 for r in history]
        print(f"{tag} train_net step wall time median {statistics.median(steps):.1f} ms "
              f"({min(steps):.1f}-{max(steps):.1f}; the first plans cuDNN), batch 2 at 800x1344 "
              f"| {card}")
        if sorted(os.listdir(ckpt)) != sorted(["model_iter2", "model_iter4", "model_latest",
                                               os.path.basename(cfg_file)]):
            raise AssertionError(f"{tag} {ckpt} holds {sorted(os.listdir(ckpt))}")
        after = torch.load(os.path.join(ckpt, "model_latest"), map_location="cpu",
                           weights_only=True)["model"]
        moved = [k for k in frozen if not torch.equal(after[k], port_sd[k])]
        if moved or not any(k.startswith("backbone.layer1.") for k in frozen):
            raise AssertionError(f"{tag} frozen trunk tensors moved from the import: {moved[:5]}")
        print(f"{tag} train_net: {len(frozen)} frozen trunk tensors bit-equal to the import after "
              f"4 steps")
        del after, port_sd

        # 3. test_net from the checkpoint over the 16 images at batch 1,
        # every forward's detections checked
        test_cfg = train_net.load_config(cfg_file, CASCADE_TEST_OPTS + data)
        (test_set,) = build_dataset(test_cfg, test_cfg.TEST.DATASETS, is_train=False)
        n = len(test_set)
        checked = []
        real_make = engine.make_forward_fn

        def checking(cfg_, model_):
            forward = real_make(cfg_, model_)

            def run(images, sizes):
                dets = forward(images, sizes)
                checked.extend(check_detections(
                    dets, np.asarray(sizes), len(sizes), cfg.MODEL.NUM_CLASSES,
                    cfg.FAST_RCNN.DETECTIONS_PER_IMG, allow_empty=True))
                return dets
            return run

        engine.make_forward_fn = checking
        try:
            out, _ = counted_run(tag, "test_net over the 16 images", lambda: test_net.main(
                ["--cfg", cfg_file, "--device", dev, "CKPT", ckpt] + data + CASCADE_TEST_OPTS),
                {"multilevel_roi_align": sites * n}, card)
        finally:
            engine.make_forward_fn = real_make
        tally(launch_counts())
        with open(os.path.join(ckpt, "test", "bbox.json")) as f:
            if json.load(f) != out["results"]:
                raise AssertionError(f"{tag} bbox.json does not hold the results")
        seconds = out["seconds"]
        if len(checked) != n or len(seconds) != n:
            raise AssertionError(f"{tag} test_net: {len(checked)} forwards, {len(seconds)} batches")
        print(f"{tag} test_net: {sum(checked)} detections over {n} images ({checked}), finite, "
              f"inside each image, labels in 1..{cfg.MODEL.NUM_CLASSES - 1}, bbox.json parses; "
              f"AP {out['stats']['AP']:.6f} (seeded weights after 4 steps, not a target)")
        print(f"{tag} test_net: the first image {seconds[0] * 1e3:.1f} ms, the other {n - 1} at "
              f"{(n - 1) / sum(seconds[1:]):.2f} img/s ({statistics.median(seconds[1:]) * 1e3:.1f} ms "
              f"median) | {card}")
        del out

    # 4. the cascade at full width through the entry points: batch-1 eval
    # latency, then kernel 1 at its three eval sites and kernels 1 and 2 at
    # its training step's
    eval_cfg = train_net.load_config(cfg_file, CASCADE_TEST_OPTS)
    model, optimizer, state = create_train_state(cfg, dev, cfg.SEED)
    fold_batch_statistics(model, first["images"])
    forward = engine.make_forward_fn(eval_cfg, model)
    # ISM merged multiplies a score by an IoU logit near 0 of either sign:
    # random weights may leave an image no detection
    request = eval_latency(f"{tag} cascade", forward, lambda d, s: check_detections(
        d, s, 1, cfg.MODEL.NUM_CLASSES, cfg.FAST_RCNN.DETECTIONS_PER_IMG, allow_empty=True),
        sites, card)
    tally(launch_counts())
    reset_launch_counts()

    with capture_calls(ops()["multilevel"], "multilevel_roi_align", keep_forward) as eval_calls:
        forward(*request)
    step_fn = make_train_step(cfg, model, optimizer)
    batch = synthetic_batch(2, 800, 1344, max_gt=32, num_classes=cfg.MODEL.NUM_CLASSES, seed=100,
                            uint8=True)
    with capture_calls(ops()["multilevel"], "multilevel_roi_align", keep_forward) as step_calls, \
            capture_calls(ops()["multilevel"].KERNEL, "backward", keep_backward) as bwd_calls:
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
    if (len(eval_calls), len(step_calls), len(bwd_calls)) != (sites, sites, sites):
        raise AssertionError(f"{tag} pooler calls captured: eval {len(eval_calls)}, step "
                             f"{len(step_calls)}, backward {len(bwd_calls)}; want {sites} each")
    tally(launch_counts())  # the forward and the step; the checks' own launches count not
    del model, optimizer, state, step_fn, forward
    torch.cuda.empty_cache()
    names = [f"stage {s + 1} 7x7" for s in range(cc.NUM_STAGE)] + ["rescore 7x7"]
    summed([check_kernel(f"cascade eval {n_}", *c, card, rescale=True)
            for n_, c in zip(names, eval_calls)], sites,
           f"{tag} kernel 1: the {sites} pooler calls of one batch-1 eval forward", card)
    summed([check_kernel(f"cascade step {n_}", *c, card, rescale=True)
            for n_, c in zip(names, step_calls)], sites,
           f"{tag} kernel 1: the {sites} pooler calls of one batch-2 training step", card)
    # autograd runs the sites backwards: rescore first
    summed([check_backward_kernel(f"cascade step {n_}", *c, card, rescale=True)
            for n_, c in zip(names, reversed(bwd_calls))], sites,
           f"{tag} kernel 2: the {sites} backward calls of one batch-2 training step", card)
    del eval_calls, step_calls, bwd_calls

    # 5. the Faster R-CNN YAML through build_model / make_forward_fn /
    # make_train_step at 800x1344
    ftag = "[faster]"
    fcfg = train_net.load_config(os.path.join(repo, FASTER_YAML),
                                 ["FAST_RCNN.SCORE_THRESH", "0.0", "SOLVER.BASE_LR", "0.0025"])
    print(f"{ftag} {FASTER_YAML}: {fcfg.MODEL.NUM_CLASSES} classes, 1 pooler call a forward at "
          f"{tuple(fcfg.FAST_RCNN.ROI_XFORM_RESOLUTION)}; FAST_RCNN.SCORE_THRESH 0.0, BASE_LR 0.0025")
    model = build_model(fcfg, dev, seed=0)
    eval_latency(ftag, engine.make_forward_fn(fcfg, model), lambda d, s: check_detections(
        d, s, 1, fcfg.MODEL.NUM_CLASSES, fcfg.FAST_RCNN.DETECTIONS_PER_IMG), 1, card)
    tally(launch_counts())
    del model
    model, optimizer, state = create_train_state(fcfg, dev, seed=0)
    step_fn = make_train_step(fcfg, model, optimizer)

    def batch_for(seed):
        return synthetic_batch(2, 800, 1344, max_gt=32, num_classes=fcfg.MODEL.NUM_CLASSES,
                               seed=seed, uint8=True)

    fold_batch_statistics(model, batch_for(99)["images"])
    state, _ = step_fn(state, batch_for(100))  # warm-up: cuDNN plans the shapes
    batches = [batch_for(101 + i) for i in range(2)]
    times = []
    for i, batch in enumerate(batches):
        (state, metrics), seconds = counted_run(
            ftag, f"training step {i}", lambda: step_fn(state, batch),
            {"multilevel_roi_align": 1, "multilevel_roi_align_backward": 1}, card)
        tally(launch_counts())
        times.append(seconds * 1e3)
        values = {k: float(v) for k, v in metrics.items() if k.startswith("loss_")}
        if len(values) != 4 or not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"{ftag} step {i}: losses {values}")
        print(f"{ftag} step {i}: {times[-1]:.1f} ms, total_loss {float(metrics['total_loss']):.4f}, "
              + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
    print(f"{ftag} training step median {statistics.median(times):.1f} ms over 2 after a warm-up, "
          f"batch 2 at 800x1344 | {card}")
    del model, optimizer, state, step_fn
    torch.cuda.empty_cache()

    phase_cascade_reference(dev)
    print(f"{tag} phase took {time.perf_counter() - t_phase:.1f} s | {card}")
    return launched["forward"], launched["backward"]


def phase_cascade_reference(dev):
    """The tiny Cascade R-CNN (3 stages, ISM, RSM) and the tiny Fast R-CNN
    in f32 on the card against the CPU port: eval detections
    (same_detections), and one training forward's losses on the same batch
    and draws (1e-4 relative). The CPU port is held against the JAX package
    by the CPU tests."""
    import os

    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools.profile_eval import make_request
    from cpm_tpu_torch.tools.train_net import load_config
    from cpm_tpu_torch.utils.sampler import Draws

    repo = os.path.dirname(os.path.abspath(__file__))
    for name, opts in (
        ("tiny_cascade", ["CASCADE_RCNN.IOU_HELPER", "True", "CASCADE_RCNN.IOU_HELPER_MERGE", "True",
                          "CASCADE_RCNN.RESCORE_ON", "True"]),
        ("tiny_fast_rcnn", []),
    ):
        cfg = load_config(os.path.join(repo, "cfgs", "debug", f"{name}.yaml"),
                          opts + ["TPU.COMPUTE_DTYPE", "float32", "FAST_RCNN.SCORE_THRESH", "0.0"])
        images, sizes = make_request(np.random.RandomState(1), [(64, 64), (56, 48)], padded_hw=(64, 64))
        batch = synthetic_batch(2, 64, 64, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES, seed=5)
        dets, losses = {}, {}
        for d in ("cpu", dev):
            model = build_model(cfg, d, seed=0)
            if cfg.CASCADE_RCNN.IOU_HELPER:
                # seeded weights give IoU logits near 0 of either sign; a
                # positive fg bias keeps ISM's scores above the threshold
                with torch.no_grad():
                    model.roi_head.outputs[-1].iou_pred.bias.copy_(torch.tensor([0.0, 0.5]))
            dets[d] = make_forward_fn(cfg, model)(images, sizes)
            tb = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
            out = model(tb["images"], tb["image_sizes"], train=True,
                        draws=Draws(torch.Generator().manual_seed(3)),
                        gt=dict(boxes=tb["gt_boxes"], labels=tb["gt_labels"], mask=tb["gt_mask"]))
            losses[d] = {k: float(v.detach()) for k, v in out.items()}
        same_detections(dets[dev], dets["cpu"], f"[cascade reference] {name}")
        worst = max(abs(losses[dev][k] - v) / abs(v) for k, v in losses["cpu"].items())
        if sorted(losses[dev]) != sorted(losses["cpu"]) or worst > 1e-4:
            raise AssertionError(f"[cascade reference] {name}: losses {losses[dev]} vs the CPU "
                                 f"port's {losses['cpu']}")
        print(f"[cascade reference] {name}: {[int(m.sum()) for m in dets['cpu'].mask]} detections "
              f"match the CPU port (labels exact, boxes 1e-2 px, scores 1e-4); {len(losses['cpu'])} "
              f"losses within {worst:.2g} relative (bound 1e-4)")


# Phase 15: the grid-cascade options of the paper's ablation YAMLs, as
# shipped (R-50-FPN, 81 classes, the 600x1000 bucket: maps of 608x1024)
OPTION_DIR = "cfgs/rcnn/mscoco/grid_cascade/"
OPTION_YAMLS = tuple(OPTION_DIR + y for y in (
    "offset_on/e2e_grid_cascade@56_rcnn_R-50-FPN-600_0.5x.yaml",
    "enhance_features/e2e_grid_cascade@56_rcnn_R-50-FPN-600_0.5x.yaml",
    "extend_roi/e2e_grid_cascade@56_rcnn_R-50-FPN-600_0.5x.yaml",
    "extend_roi/e2e_grid_cascade@5_rcnn_R-50-FPN-600_0.5x.yaml",
    "finest_level_roi/e2e_grid_cascade@56_rcnn_R-50-FPN-600_0.5x.yaml",
    "resize_roi/e2e_grid_cascade@56_rcnn_R-50-FPN-600_0.5x.yaml",
    "se/e2e_grid_cascade@56_rcnn_R-50-FPN-600_0.5x.yaml",
    "random_jitter/e2e_grid_cascade_rcnn_RJ_R-50-FPN-600_0.5x.yaml",
    "random_jitter/iou_strategy/e2e_grid_cascade@555_rcnn_RJ_R-50-FPN-600_0.5x.yaml",
    "bretter_roi/e2e_grid_cascade@56_rcnn_R-50-FPN-600_0.5x.yaml",
    "bretter_roi/0.125/e2e_grid_cascade@56_rcnn_R-50-FPN-600_0.5x.yaml",
))
FINEST_YAML, RESIZE_YAML = OPTION_YAMLS[4], OPTION_YAMLS[5]
# random weights score near 1/81, below the YAMLs' GRID_RCNN.SCORE_THRESH
# 0.03; their SOLVER.BASE_LR 0.02 is for 16 images, scaled to 2
OPTION_OPTS = ["GRID_RCNN.SCORE_THRESH", "0.0", "SOLVER.BASE_LR", "0.0025"]
OPTION_BUCKET = (608, 1024)
# R-50-C4 Faster R-CNN: cfgs/debug/tiny_fast_rcnn_c4.yaml taken to the values
# of Detectron's public configs/12_2017_baselines/e2e_faster_rcnn_R-50-C4_1x.yaml
# (ResNet-50 to C4 at stride 16, 81 classes, RPN.SIZES (32, 64, 128, 256,
# 512) at one stride of 16, 14x14 RoIAlign into the res5 head, 512 rois an
# image, test proposals 6000 before NMS and 1000 after, the 800x1333 scale,
# caffe's BGR means) and, where that YAML keeps Detectron's defaults, to
# those (train proposals 12000 / 2000). Cut for one card: batch 2 at
# SOLVER.BASE_LR 0.0025 (0.02 for 16 images, scaled), FAST_RCNN.SCORE_THRESH
# 0.0 (random weights score near 1/81, below 0.05). The 2mlp head runs
# stage 5 at C5_DILATION 2 (stride 1, so its 7x7 pool keeps the C4 scale).
C4_YAML = "cfgs/debug/tiny_fast_rcnn_c4.yaml"
C4_OPTS = ["BACKBONE.RESNET.LAYERS", "(3, 4, 6, 3)", "BACKBONE.RESNET.WIDTH", "64",
           "MODEL.NUM_CLASSES", "81", "RPN.ANCHOR_STRIDE", "(16,)",
           "RPN.ANCHOR_SIZES", "(32, 64, 128, 256, 512)",
           "FAST_RCNN.ROI_XFORM_RESOLUTION", "(14, 14)", "FAST_RCNN.BATCH_SIZE_PER_IMAGE", "512",
           "RPN.PRE_NMS_TOP_N_TEST", "6000", "RPN.POST_NMS_TOP_N_TEST", "1000",
           "RPN.PRE_NMS_TOP_N_TRAIN", "12000", "RPN.POST_NMS_TOP_N_TRAIN", "2000",
           "TRAIN.SCALES", "(800,)", "TRAIN.MAX_SIZE", "1333", "TEST.SCALE", "800",
           "TEST.MAX_SIZE", "1333", "TO_BGR255", "True",
           "PIXEL_MEANS", "(102.9801, 115.9465, 122.7717)", "PIXEL_STDS", "(1.0, 1.0, 1.0)",
           "SOLVER.BASE_LR", "0.0025", "FAST_RCNN.SCORE_THRESH", "0.0"]
C4_HEADS = {
    "resnet_c5_head": [],
    "resnet_2mlp_head": ["FAST_RCNN.ROI_BOX_HEAD", "resnet_2mlp_head",
                         "BACKBONE.RESNET.C5_DILATION", "2", "FAST_RCNN.ROI_XFORM_RESOLUTION",
                         "(7, 7)"],
}
C4_BUCKET = (800, 1344)
# resize_roi/ through the CLIs over the synthetic set, as phase 14 runs them
RESIZE_TRAIN_OPTS = ["TRAIN.DATASETS", "('coco_debug_synthetic',)", "TRAIN.BATCH_SIZE", "2",
                     "SOLVER.BASE_LR", "0.0025", "SOLVER.MAX_ITER", "4",
                     "SOLVER.SNAPSHOT_ITERS", "2"]
RESIZE_TEST_OPTS = ["TEST.DATASETS", "('coco_debug_synthetic',)", "GRID_RCNN.SCORE_THRESH", "0.0"]


def pooler_sites(cfg):
    """(eval launches, training-step launches) that one forward of cfg's
    model makes: the kernel of each pooler call, one a call; a step adds one
    backward (kernel 2) a call. FINEST_LEVEL_ROI's stages and the C4 heads
    pool one level (kernel 5); every other site is kernel 1."""
    if not cfg.MODEL.FPN_ON:
        return {"roi_align": 1}, {"roi_align": 1, "multilevel_roi_align_backward": 1}
    if cfg.MODEL.FASTER_RCNN and not cfg.MODEL.CASCADE_ON:
        return ({"multilevel_roi_align": 1},
                {"multilevel_roi_align": 1, "multilevel_roi_align_backward": 1})
    g = cfg.GRID_RCNN
    opt = g.CASCADE_MAPPING_OPTION
    stages = opt.STAGE_NUM if g.CASCADE_MAPPING_ON else 1
    test_stages = opt.TEST_STAGE if g.CASCADE_MAPPING_ON else 1
    branch = 1 + int(g.RESCORE_ON)
    stage_kernel = "roi_align" if g.FINEST_LEVEL_ROI else "multilevel_roi_align"

    def counts(n):
        out = {"multilevel_roi_align": branch}
        out[stage_kernel] = out.get(stage_kernel, 0) + n
        return out

    return counts(test_stages), dict(counts(stages), multilevel_roi_align_backward=branch + stages)


def keep_forward(features, rois, levels, valid, output_size, *_):
    """What one call of the kernel-1 wrapper was given (the maps cloned in
    their layout)."""
    return ([f.detach().clone() for f in features], rois.clone(), levels.clone(), valid.clone(),
            tuple(output_size))


def keep_backward(shapes, rois, levels, valid, g, *_):
    """What one launch of kernel 2 was given."""
    return ([tuple(s) for s in shapes], rois.clone(), levels.clone(), valid.clone(), g.clone())


def keep_single_level(features, rois, output_size, spatial_scale, sampling_ratio, roi_mask=None):
    """What one call of the kernel-5 wrapper was given."""
    return (features.detach().clone(), rois.detach().clone(), tuple(output_size),
            float(spatial_scale), sampling_ratio,
            None if roi_mask is None else roi_mask.detach().clone())


def drive_model(tag, cfg, padded, card, timed=False, dev="cuda", latency=False, must_move=(),
                keep_calls=False):
    """One of phase 15's or 17's models at full width from seed 0 (bf16 over
    f32 masters, the trunk's frozen affines folded from one batch): one
    batch-1 eval forward and one batch-2 training step, each held to its
    predicted launches; finite losses that sum to total_loss, finite
    detections, boxes inside their images, labels 1..80, frozen tensors
    bit-equal, a tensor of every group moved and one whose name holds each
    of `must_move`. With `latency`: 10 more batch-1 requests timed. With
    `timed`: those, 3 more steps, the peaks, and what the kernel-5 calls of
    one eval forward and one step were given. With `keep_calls`: what the
    kernel-1 calls of one more eval forward and step, and the kernel-2
    launches of that step, were given (out["kept"]: eval, step, backward),
    held to the predicted launches. Returns (launches of its runs, the
    captured kernel-5 calls, timings, the step's peak memory)."""
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.solver.optimizer import classify_params
    from cpm_tpu_torch.tools.profile_eval import make_request
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics

    ph, pw = padded
    nc = cfg.MODEL.NUM_CLASSES
    max_dets = cfg.GRID_RCNN.TEST_MAX_DETECTIONS if cfg.MODEL.GRID_ON else cfg.FAST_RCNN.DETECTIONS_PER_IMG
    eval_want, step_want = pooler_sites(cfg)
    t0 = time.perf_counter()
    model, optimizer, state = create_train_state(cfg, dev, seed=0)
    step_fn = make_train_step(cfg, model, optimizer)

    def batch_for(seed):
        return synthetic_batch(2, ph, pw, max_gt=32, num_classes=nc, seed=seed, uint8=True)

    fold_batch_statistics(model, batch_for(99)["images"])
    labels = classify_params(model, int(cfg.BACKBONE.RESNET.FREEZE_AT))
    forward = make_forward_fn(cfg, model)
    launched = {}

    def tally():
        for k, v in launch_counts().items():
            launched[k] = launched.get(k, 0) + v

    def check(dets, sizes):
        return check_detections(dets, np.asarray(sizes), len(sizes), nc, max_dets)

    request = make_request(np.random.RandomState(5), [(ph - 8, pw - 24)], padded)
    dets, eval_s = counted_run(tag, "batch-1 eval forward", lambda: forward(*request), eval_want,
                               card)
    tally()
    counts = check(dets, request[1])
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    (state, metrics), step_s = counted_run(tag, "batch-2 training step",
                                           lambda: step_fn(state, batch_for(100)), step_want, card)
    tally()
    step_peak = torch.cuda.max_memory_allocated() / 2**20
    losses = {k: float(v) for k, v in metrics.items() if k.startswith("loss_")}
    if not losses or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{tag} losses {losses}")
    total = float(metrics["total_loss"])
    if abs(sum(losses.values()) - total) > 1e-5 * abs(total):
        raise AssertionError(f"{tag} losses {losses} do not sum to total_loss {total}")
    moved = {g["name"]: 0 for g in optimizer.param_groups}
    group_of = {id(p): g["name"] for g in optimizer.param_groups for p in g["params"]}
    for k, p in model.named_parameters():
        if labels[k] == "frozen":
            if p.requires_grad or not torch.equal(p, before[k]):
                raise AssertionError(f"{tag} frozen parameter {k} changed")
            continue
        if not torch.isfinite(p).all() or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{tag} parameter or gradient of {k} not finite")
        moved[group_of[id(p)]] += int(not torch.equal(p, before[k]))
    if not all(moved.values()):
        raise AssertionError(f"{tag} a group moved nothing: {moved}")
    for part in must_move:
        if not any(part in k and labels[k] != "frozen" and not torch.equal(p, before[k])
                   for k, p in model.named_parameters()):
            raise AssertionError(f"{tag} no parameter of {part} moved")
    frozen = sum(v == "frozen" for v in labels.values())
    print(f"{tag} {time.perf_counter() - t0:.1f} s built, folded, run and checked; eval "
          f"{counts} detections (finite, inside the image, labels 1..{nc - 1}); step losses "
          + ", ".join(f"{k[5:]} {v:.4f}" for k, v in losses.items())
          + f"; {frozen} frozen tensors bit-equal, tensors moved by group {moved}"
          + (f", and of each of {list(must_move)}" if must_move else ""))
    out = dict(launched=launched, sites=[], eval_ms=None, step_ms=None, step_peak_mib=step_peak)
    if latency and not timed:
        eval_latency(tag, forward, check, eval_want, card, padded)
        tally()
    if keep_calls:
        multilevel = ops()["multilevel"]
        with capture_calls(multilevel, "multilevel_roi_align", keep_forward) as eval_calls:
            counted_run(tag, "batch-1 eval forward, kernel-1 calls kept",
                        lambda: forward(*request), eval_want, card)
        tally()
        with capture_calls(multilevel, "multilevel_roi_align", keep_forward) as step_calls, \
                capture_calls(multilevel.KERNEL, "backward", keep_backward) as bwd_calls:
            state, _ = counted_run(tag, "batch-2 training step, kernel-1 and -2 calls kept",
                                   lambda: step_fn(state, batch_for(101)), step_want, card)
        tally()
        out["kept"] = dict(eval=eval_calls, step=step_calls, backward=bwd_calls)
        want = (eval_want["multilevel_roi_align"], step_want["multilevel_roi_align"],
                step_want["multilevel_roi_align_backward"])
        if tuple(len(v) for v in out["kept"].values()) != want:
            raise AssertionError(f"{tag} kernel-1 and -2 calls kept: "
                                 f"{ {k: len(v) for k, v in out['kept'].items()} }, want {want}")
    if timed:
        single = ops()["single"]
        with capture_calls(single, "roi_align_cuda", keep_single_level) as eval_calls:
            forward(*request)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eval_latency(tag, forward, check, eval_want, card, padded)
        out["eval_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        tally()
        with capture_calls(single, "roi_align_cuda", keep_single_level) as step_calls:
            state, _ = step_fn(state, batch_for(101))
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(3):
            batch = batch_for(102 + i)
            reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            if {k: v for k, v in launch_counts().items() if v} != step_want:
                raise AssertionError(f"{tag} timed step {i}: launched {launch_counts()}")
            tally()
        out["train_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        print(f"{tag} training step median {statistics.median(times):.1f} ms "
              f"({min(times):.1f}-{max(times):.1f}) over 3 after a warm-up, batch 2 at {ph}x{pw}; "
              f"peak device memory {out['train_peak_mib']:.1f} MiB | {card}")
        out["sites"] = [("eval", c) for c in eval_calls] + [("step", c) for c in step_calls]
    del model, optimizer, state, step_fn, forward
    torch.cuda.empty_cache()
    return out


def check_single_level_site(name, site, card):
    """Kernel 5 on what one model site gave its wrapper: against its plain
    version (f32, atol 1e-5), its CUDA-event and device time, the plain
    version's time, its bound (every roi pooled, as the kernel does), and the
    time of the wrapper's cast of the bf16 map to f32."""
    from cpm_tpu_torch.ops.roi_align import roi_align as plain
    from cpm_tpu_torch.tools.bench_roi_align import roi_align_bounds
    from cpm_tpu_torch.tools.compare_kernels import device_ms

    half, rois, pool, scale, sr, mask = site
    kernel = ops()["single"].KERNEL
    feats = half.float().contiguous()
    got = kernel(feats, rois, pool, scale, sr)
    want = torch.cat([plain(feats, r, pool, scale, sr) for r in rois.split(256)])
    err = (got - want).abs().max().item() if len(rois) else 0.0
    if not torch.isfinite(got).all() or err > F32_ATOL:
        raise AssertionError(f"{name}: kernel 5 vs plain max |err| {err}")
    del got, want
    n = rois.shape[0]
    everyone = torch.ones(n, dtype=torch.bool, device=rois.device)
    zeros = torch.zeros(n, dtype=torch.int32, device=rois.device)
    ms = cuda_ms(lambda: kernel(feats, rois, pool, scale, sr))
    dev_ms = device_ms([(feats, rois, pool, scale, sr)], kernel, or_none=True)
    cast_ms = cuda_ms(lambda: half.float())
    plain_ms = cuda_ms(lambda: torch.cat([plain(feats, r, pool, scale, sr)
                                          for r in rois.split(256)]), reps=3)
    (bound_ms, bound_by), _ = roi_align_bounds([tuple(feats.shape)], rois, zeros, everyone, pool, 4,
                                               scales=(scale,))
    valid = n if mask is None else int(mask.sum())
    print(f"[kernel 5 site] {name}: map {tuple(half.shape)} {half.dtype} -> f32, R={n} ({valid} "
          f"valid) {pool[0]}x{pool[1]} at 1/{round(1 / scale)}: max|err| {err:.3g} (atol "
          f"{F32_ATOL}); event {ms:.4f} ms, device {device_text(dev_ms, bound_ms)}, bound "
          f"{bound_ms:.4f} ms ({bound_by}); the wrapper's bf16->f32 cast of "
          f"the map {cast_ms:.4f} ms; plain {plain_ms:.4f} ms | {card}")
    return dict(err=err, ms=ms, device_ms=dev_ms, cast_ms=cast_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def masked_row_check(card):
    """A one-level Pooler on a bf16 C4 map with NaN boxes in masked rows:
    the forward writes zeros there, and the map's gradient (kernel 2 at one
    level, handed the mask) is finite and bit-equal to the gradient without
    those rows."""
    from cpm_tpu_torch.ops.pooler import Pooler

    rng = np.random.RandomState(13)
    rois, _ = synthetic_rois(512, rng, "cuda")
    rois = rois.clone()
    mask = torch.ones(512, dtype=torch.bool, device="cuda")
    mask[::7] = False
    rois[::7, 1:] = float("nan")
    feats = torch.randn(C4_SHAPE, generator=torch.Generator().manual_seed(8)).cuda().bfloat16()
    g = torch.randn(512, 14, 14, C4_SHAPE[3], generator=torch.Generator().manual_seed(9))
    g = g.cuda().bfloat16()
    pooler = Pooler((14, 14), (C4_SCALE,), 2)
    grads = []
    for r, m, gg in ((rois, mask, g), (rois[mask].contiguous(), mask[mask], g[mask])):
        f = feats.clone().requires_grad_()
        out = pooler([f], r, m)
        (out.float() * gg.float()).sum().backward()
        if not torch.isfinite(out).all() or out[~m].any():
            raise AssertionError("masked-row check: the forward is not zero on masked rows")
        grads.append(f.grad)
    torch.cuda.synchronize()
    if not (torch.isfinite(grads[0]).all() and grads[0].any() and torch.equal(*grads)):
        raise AssertionError("masked-row check: a masked row's NaN box reached the map gradient")
    print(f"[kernel 5 masked rows] one-level Pooler, bf16 map {C4_SHAPE}, 512 rois at 14x14 with "
          f"{int((~mask).sum())} masked rows holding NaN boxes: forward zero there, map gradient "
          f"finite and bit-equal to the gradient without those rows | {card}")


def phase_options_cli(dev, card):
    """resize_roi/ through train_net (4 steps at batch 2, from a seeded
    caffe-style trunk .pth with folded affines) and test_net over the 16
    synthetic images. Returns the launches of its runs."""
    import os
    import tempfile

    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.data.loader import TrainLoader
    from cpm_tpu_torch.engine.train import create_train_state
    from cpm_tpu_torch.tools import test_net, train_net
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics

    tag = "[options cli]"
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(repo, RESIZE_YAML)
    data = ["DATA_DIR", os.path.join(repo, "data")]
    cfg = train_net.load_config(cfg_file, RESIZE_TRAIN_OPTS + data)
    eval_want, step_want = pooler_sites(cfg)
    launched = {}

    def tally():
        for k, v in launch_counts().items():
            launched[k] = launched.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="cpm_resize_") as tmp:
        model, _, _ = create_train_state(cfg, dev, cfg.SEED)
        (dataset,) = build_dataset(cfg, cfg.TRAIN.DATASETS, is_train=True)
        first = next(iter(TrainLoader(cfg, dataset, cfg.TRAIN.BATCH_SIZE, seed=cfg.SEED, prefetch=0)))
        fold_batch_statistics(model, first["images"])
        port_sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        del model
        trunk_pth = os.path.join(tmp, "trunk.pth")
        torch.save(reference_trunk(port_sd, cfg.MODEL.CONV1_RGB2BGR), trunk_pth)
        ckpt = os.path.join(tmp, "ckpt")
        argv = (["--cfg", cfg_file, "--device", dev] + RESIZE_TRAIN_OPTS + data
                + ["CKPT", ckpt, "TRAIN.WEIGHTS", trunk_pth])
        history, _ = counted_run(tag, "train_net 4 steps", lambda: train_net.main(argv),
                                 {k: 4 * v for k, v in step_want.items()}, card)
        tally()
        names = {"loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_grid_1",
                 "loss_grid_2"}
        for r in history:
            values = {k: r[k] for k in r if k.startswith("loss_")}
            if set(values) != names or not all(math.isfinite(v) for v in values.values()):
                raise AssertionError(f"{tag} train_net iter {r['iter']}: {r}")
        steps = [r["step_s"] * 1e3 for r in history]
        print(f"{tag} train_net: losses finite, step wall time median {statistics.median(steps):.1f} "
              f"ms ({min(steps):.1f}-{max(steps):.1f}; the first plans cuDNN) | {card}")
        n = 16
        out, _ = counted_run(tag, "test_net over the 16 images", lambda: test_net.main(
            ["--cfg", cfg_file, "--device", dev, "CKPT", ckpt] + data + RESIZE_TEST_OPTS),
            {k: n * v for k, v in eval_want.items()}, card)
        tally()
        with open(os.path.join(ckpt, "test", "bbox.json")) as f:
            if json.load(f) != out["results"]:
                raise AssertionError(f"{tag} bbox.json does not hold the results")
        sizes = {r["image_id"]: None for r in out["results"]}
        if not out["results"] or not all(
                all(math.isfinite(v) for v in r["bbox"]) and r["bbox"][2] >= 0 and r["bbox"][3] >= 0
                for r in out["results"]):
            raise AssertionError(f"{tag} test_net results")
        seconds = out["seconds"]
        print(f"{tag} test_net: {len(out['results'])} detections over {len(sizes)} of {n} images, "
              f"bbox.json parses; the other {n - 1} images at {(n - 1) / sum(seconds[1:]):.2f} img/s "
              f"| {card}")
    return launched


def tiny_option_cfgs():
    """The tiny models of tests/test_torch_grid_options.py and
    tests/test_torch_c4.py, in f32, from the port's own configs."""
    import os

    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.tools.train_net import load_config

    out = {}
    for which in ("finest_offset", "enhance_se"):
        cfg = flagship_cfg(tiny=True)
        cfg.TPU.COMPUTE_DTYPE = "float32"
        g = cfg.GRID_RCNN
        opt = g.CASCADE_MAPPING_OPTION
        opt.STAGE_NUM = opt.TEST_STAGE = 2
        opt.STAGE_WEIGHTS, opt.STAGE_MAPPING_RATIO = (1.0, 0.5), (1.0, 0.5)
        opt.FG_IOU_THRESHOLD = opt.BG_IOU_THRESHOLD = (0.5, 0.6)
        if which == "finest_offset":
            opt.GRID_NUM, opt.RESIZE_ROI = (4, 4), True
            g.FUSED_ON = g.OFFSET_ON = True
            g.FINEST_LEVEL_ROI = g.EXTEND_ROI = g.BETTER_ROI = g.RANDOM_JITTER = True
            g.RESCORE_ON = g.RESCORE_OPTION.KEEP_RATIO = True
        else:
            opt.GRID_NUM = (9, 9)
            g.FUSED_ON = False
            g.ENHANCE_FEATURES = g.SE_ON = True
        out[which] = cfg
    repo = os.path.dirname(os.path.abspath(__file__))
    for head, extra in (("resnet_c5_head", ["FAST_RCNN.ROI_XFORM_RESOLUTION", "(14, 14)"]),
                        ("resnet_2mlp_head", ["FAST_RCNN.ROI_XFORM_RESOLUTION", "(7, 7)",
                                              "BACKBONE.RESNET.C5_DILATION", "2"])):
        out[head] = load_config(os.path.join(repo, C4_YAML), [
            "FAST_RCNN.ROI_BOX_HEAD", head, "BACKBONE.RESNET.BASE_PLANES", "8",
            "MODEL.NUM_CLASSES", "5", "FAST_RCNN.MLP_HEAD.MLP_DIM", "64",
            "FAST_RCNN.SCORE_THRESH", "0.0", "TPU.COMPUTE_DTYPE", "float32"] + extra)
    return out


def spread_c4_scores(model):
    """Seeded weights leave the tiny C4 models' scores near-tied: the one-level
    RPN's objectness logits sit within 0.02 of 0 over 144 anchors, and the
    2mlp head's fcs are drawn N(0, 1e-4), as in the reference, so every roi
    scores alike to 1e-8. The card's f32 sums then flip the order of
    near-ties against the CPU's: a proposal set 31 px apart on an H100, which
    moves a loss by up to 2e-3 (a 3e-5 perturbation of the weights on the
    CPU does the same). Redrawn from a seed, the RPN's objectness conv at
    unit scale and the 2mlp head's fcs at the MLP heads' kaiming-uniform
    scale with a unit-scale classifier, the scores separate."""
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        w = model.rpn_head.cls_logits.weight
        w.copy_(torch.randn(w.shape, generator=g))
        head = model.roi_head.head
        if hasattr(head, "fc1"):
            for fc in (head.fc1, head.fc2):
                bound = math.sqrt(3.0 / fc.in_features)
                fc.weight.copy_(torch.rand(fc.weight.shape, generator=g) * 2 * bound - bound)
            w = model.roi_head.output.cls_score.weight
            w.copy_(torch.randn(w.shape, generator=g))


def phase_options_reference(dev):
    """The tiny option and C4 models in f32 on the card against the CPU
    port, with phase 14's tolerances: eval detections (same_detections) and
    one training forward's losses on the same batch and draws (1e-4
    relative); the C4 models' scores spread first (`spread_c4_scores`). The
    CPU port is held against the JAX package by the CPU tests."""
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools.profile_eval import make_request
    from cpm_tpu_torch.utils.sampler import Draws

    for name, cfg in tiny_option_cfgs().items():
        size = 128 if cfg.MODEL.GRID_ON else 64
        images, sizes = make_request(np.random.RandomState(1), [(64, 64), (56, 48)], (64, 64))
        batch = synthetic_batch(2, size, size, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES, seed=5)
        if cfg.MODEL.GRID_ON:
            # large gt boxes, so that RESIZE_ROI acts on refined boxes
            batch["gt_boxes"][:, 0] = [[6.0, 9.0, 121.0, 118.0], [12.0, 4.0, 117.0, 124.0]]
            batch["gt_mask"][:, 0] = True
            batch["gt_labels"][:, 0] = [3, 5]
        dets, losses = {}, {}
        for d in ("cpu", dev):
            model = build_model(cfg, d, seed=0)
            if not cfg.MODEL.FPN_ON:
                spread_c4_scores(model)
            dets[d] = make_forward_fn(cfg, model)(images, sizes)
            tb = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
            out = model(tb["images"], tb["image_sizes"], train=True,
                        draws=Draws(torch.Generator().manual_seed(3)),
                        gt=dict(boxes=tb["gt_boxes"], labels=tb["gt_labels"], mask=tb["gt_mask"]))
            losses[d] = {k: float(v.detach()) for k, v in out.items()}
        same_detections(dets[dev], dets["cpu"], f"[options reference] {name}")
        worst = max(abs(losses[dev][k] - v) / abs(v) for k, v in losses["cpu"].items())
        if sorted(losses[dev]) != sorted(losses["cpu"]) or worst > 1e-4:
            raise AssertionError(f"[options reference] {name}: losses {losses[dev]} vs the CPU "
                                 f"port's {losses['cpu']}")
        print(f"[options reference] {name}: {[int(m.sum()) for m in dets['cpu'].mask]} detections "
              f"match the CPU port (labels exact, boxes 1e-2 px, scores 1e-4); {len(losses['cpu'])} "
              f"losses within {worst:.2g} relative (bound 1e-4)")


def phase_options(dev, card):
    """Phase 15: the eleven grid-cascade option YAMLs and R-50-C4 Faster
    R-CNN with both C4 heads at full width, each through one eval forward
    and one training step with its launches predicted; FINEST_LEVEL_ROI and
    the C5 head timed, and kernel 5 checked and timed at their sites; the
    masked-row check of kernel 5's backward; resize_roi/ through the CLIs;
    the tiny models on the card against the CPU port. Returns the launches of
    its driven runs and kernel 5's result at the FINEST_LEVEL_ROI model's
    eval sites."""
    import os

    from cpm_tpu_torch.tools.train_net import load_config

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    launched = {}
    timed = {}
    for yaml in OPTION_YAMLS:
        cfg = load_config(os.path.join(repo, yaml), OPTION_OPTS)
        name = (yaml[len(OPTION_DIR):].replace("e2e_grid_cascade", "").replace("_rcnn", "")
                .replace("_R-50-FPN-600_0.5x.yaml", ""))
        out = drive_model(f"[options {name}]", cfg, OPTION_BUCKET, card, timed=yaml == FINEST_YAML,
                          dev=dev)
        for k, v in out["launched"].items():
            launched[k] = launched.get(k, 0) + v
        if out["sites"]:
            timed["finest_level_roi"] = out
    for head, extra in C4_HEADS.items():
        cfg = load_config(os.path.join(repo, C4_YAML), C4_OPTS + extra)
        out = drive_model(f"[c4 {head}]", cfg, C4_BUCKET, card, timed=head == "resnet_c5_head",
                          dev=dev)
        for k, v in out["launched"].items():
            launched[k] = launched.get(k, 0) + v
        if out["sites"]:
            timed["r50_c4"] = out
    print(f"[options] launches of the 13 models' runs: "
          f"{ {k: v for k, v in launched.items() if v} }")

    results = {}
    for model_name, out in timed.items():
        per = {"eval": [], "step": []}
        for i, (where, site) in enumerate(out["sites"]):
            per[where].append(check_single_level_site(f"{model_name} {where} site {i}", site, card))
        for where, rs in per.items():
            total = {k: sum(r[k] for r in rs) for k in ("ms", "cast_ms", "plain_ms", "bound_ms")}
            devices = [r["device_ms"] for r in rs]
            total["device_ms"] = None if None in devices else sum(devices)
            print(f"[kernel 5 sites] {model_name} {where}: {len(rs)} calls, event "
                  f"{total['ms']:.4f} ms, device {device_text(total['device_ms'])}, bound "
                  f"{total['bound_ms']:.4f} ms, cast {total['cast_ms']:.4f} ms, plain "
                  f"{total['plain_ms']:.4f} ms | {card}")
            results[(model_name, where)] = dict(total, err=max(r["err"] for r in rs),
                                                 bound_by=rs[0]["bound_by"])
    masked_row_check(card)
    for k, v in phase_options_cli(dev, card).items():
        launched[k] = launched.get(k, 0) + v
    phase_options_reference(dev)
    print(f"[options] phase took {time.perf_counter() - t_phase:.1f} s | {card}")
    return launched, results[("finest_level_roi", "eval")], results



# Phase 16: data parallelism (cpm_tpu_torch/parallel/mesh.py) on the headline YAML
DP_STEPS = 3  # the ranks' steps: the first held against one process, each bit-equal across ranks
# ADAM and RMSPROP on the card against the CPU port: the losses of two steps
# (phase 14's 1e-4 relative), and the optimizer alone on the same seeded
# gradients (tests/test_torch_optimizers.py's rtol 1e-5 / atol 1e-6)
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6


def data_parallel_rank(rank, world_size, workdir, spec):
    """A spawned rank of phase 16a: loads the libraries phase 1 built (and
    says which, if any, it had to compile), then the tool's rank_steps on
    its image, over gloo on cuda:0, with its launch counts."""
    from cpm_tpu_torch.ops.cuda import _build
    from cpm_tpu_torch.tools.check_data_parallel import rank_steps

    built = _build.compile_sources([m.SOURCE for m in ops().values()])
    for m in ops().values():
        m.KERNEL.build()
    reset_launch_counts()
    out = rank_steps(rank, world_size, workdir, spec, backend="gloo", local_rank=0)
    out["launches"] = {k: v for k, v in launch_counts().items() if v}
    out["compiled"] = sorted(s.name for s, b in built.items() if b.log)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_data_parallel(dev, card):
    """Phase 16: (a) two ranks sharing the card over gloo, one image each,
    against one process on the batch of two; (b) train_net under a world-1
    NCCL group against train_net without one, bit for bit; (c) ADAM and
    RMSPROP on the card against the CPU port. Returns the launches of
    kernels 1 and 2 in its driven runs."""
    import os
    import tempfile

    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.solver.optimizer import build_optimizer
    from cpm_tpu_torch.tools import check_data_parallel as dp, train_net

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(repo, HEADLINE_YAML)
    opts = CLI_TRAIN_OPTS + ["DATA_DIR", os.path.join(repo, "data")]
    cfg = train_net.load_config(cfg_file, opts + ["TPU.COMPUTE_DTYPE", "float32"])
    sites = 2 + cfg.GRID_RCNN.CASCADE_MAPPING_OPTION.STAGE_NUM  # cls, the CMM stages, rescore
    per_step = {"multilevel_roi_align": sites, "multilevel_roi_align_backward": sites}
    launched = dict(forward=0, backward=0)

    def count(launches, steps, what):
        want = {k: v * steps for k, v in per_step.items()}
        if launches != want:
            raise AssertionError(f"[dp] {what}: launched {launches}, want {want}")
        launched["forward"] += launches["multilevel_roi_align"]
        launched["backward"] += launches["multilevel_roi_align_backward"]

    # step-0 weights: seeded, the frozen affines folded from the loader's
    # first batch, which is also the batch of two that the steps take; (b)
    # starts from them too, as checkpoints (the compute dtype is the
    # config's, not the checkpoint's)
    ckpt_root = tempfile.TemporaryDirectory(prefix="cpm_dp_")
    ckpts = {name: os.path.join(ckpt_root.name, name) for name in ("plain", "nccl")}
    state, batch = dp.step0_state(cfg, dev, 2)
    state_dict = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    for ckpt in ckpts.values():
        CheckPointer(ckpt).save(state, 0)
    del state
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    spec = dict(cfg=cfg, device=dev, seed=cfg.SEED, batch=batch, state_dict=state_dict)
    n_trainable = sum(t.numel() for g in build_optimizer(cfg, build_model(cfg, "meta")).param_groups
                      for t in g["params"])

    # (a) one process on the batch of two, then two ranks of one image each
    # (the parent's launches are the one process's)
    reset_launch_counts()
    held = dp.hold_ranks(spec, 2, DP_STEPS, "[dp] two ranks", data_parallel_rank, timeout_s=300)
    one, ranks = held["one"], held["ranks"]
    count({k: v for k, v in launch_counts().items() if v}, 1, "one process")
    for r, out in enumerate(ranks):
        if out["compiled"]:
            raise AssertionError(f"[dp] rank {r} compiled {out['compiled']} again")
        count(out["launches"], DP_STEPS, f"rank {r}")
    n_losses = sum(k.startswith("loss_") or k == "total_loss" for k in one["metrics"][0])
    print(f"[dp] two gloo ranks on one card, one image each, against one process on the batch "
          f"of two (f32, TF32 off): {n_losses} losses of step 1 within {held['worst_loss']:.3g} "
          f"relative (bound {dp.LOSS_RTOL}), {len(one['params'][1])} parameters within "
          f"{held['worst_param']:.3g} (rtol {dp.PARAM_RTOL}, atol {dp.PARAM_ATOL}); the ranks' "
          f"parameters bit-equal after each of {DP_STEPS} steps; each rank launched "
          f"{ranks[0]['launches']} and loaded the libraries phase 1 built")
    print(f"[dp] two ranks sharing one card over gloo: not a scaling figure: step 2 wall time "
          f"{ranks[0]['step_s'][1] * 1e3:.1f} ms (rank 1 {ranks[1]['step_s'][1] * 1e3:.1f} ms), "
          f"train_step/allreduce span {ranks[0]['allreduce_s'] * 1e3:.1f} ms on the host clock "
          f"(step {DP_STEPS}, torch.profiler; {n_trainable} f32 gradients), "
          f"{ranks[0]['collectives']} torch.distributed calls in that step taking "
          f"{ranks[0]['collective_s'] * 1e3:.1f} ms on the host clock, the one process's "
          f"batch-2 step {one['step_s'][0] * 1e3:.1f} ms (its first); the ranks' spawn to their "
          f"results {held['spawn_s']:.1f} s; (a) took {time.perf_counter() - t_a:.1f} s, the "
          f"step-0 weights and checkpoints before it {t_a - t_phase:.1f} s | {card}")
    del one, ranks
    torch.cuda.empty_cache()
    t_b = time.perf_counter()

    # (b) train_net from the same step-0 weights, 2 steps, without a group
    # and under torchrun's variables with WORLD_SIZE 1: NCCL on the card
    env_keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    with ckpt_root:
        histories, latest = {}, {}
        for name, ckpt in ckpts.items():
            argv = (["--cfg", cfg_file, "--device", dev] + opts
                    + ["CKPT", ckpt, "SOLVER.MAX_ITER", "2"])
            saved = {k: os.environ.get(k) for k in env_keys}
            if name == "nccl":
                os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                                  MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
            try:
                reset_launch_counts()
                t0 = time.perf_counter()
                histories[name] = train_net.main(argv)
                seconds = time.perf_counter() - t0
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            count({k: v for k, v in launch_counts().items() if v}, 2, f"train_net {name}")
            latest[name] = torch.load(os.path.join(ckpt, "model_latest"), map_location="cpu",
                                      weights_only=True)
            print(f"[dp] train_net {name}: 2 steps in {seconds:.2f} s in the call, step wall "
                  f"times {[round(r['step_s'] * 1e3, 1) for r in histories[name]]} ms | {card}")
        plain, nccl = ([{k: v for k, v in r.items() if k not in ("step_s", "wait_s")}
                        for r in histories[name]] for name in ("plain", "nccl"))
        if plain != nccl:
            raise AssertionError("[dp] train_net under a world-1 NCCL group: other losses")
        a, b = latest["plain"], latest["nccl"]
        differ = [k for k in a["model"] if not torch.equal(a["model"][k], b["model"][k])]
        differ += [f"optimizer {i}" for i, st in a["optimizer"]["state"].items()
                   if not torch.equal(st["momentum_buffer"],
                                      b["optimizer"]["state"][i]["momentum_buffer"])]
        if differ or a["step"] != b["step"]:
            raise AssertionError(f"[dp] train_net under a world-1 NCCL group differs: {differ[:5]}")
        print(f"[dp] train_net under a world-1 NCCL group (torchrun's variables, cuda:0): its 2 "
              f"steps' losses and its model_latest ({len(a['model'])} tensors, "
              f"{len(a['optimizer']['state'])} momentum buffers) bit-equal to the run without a "
              f"group; (b) took {time.perf_counter() - t_b:.1f} s")
    t_c = time.perf_counter()

    # (c) ADAM and RMSPROP on the tiny model, the card against the CPU port
    for name in ("ADAM", "RMSPROP"):
        tiny = flagship_cfg(tiny=True)
        tiny.TPU.COMPUTE_DTYPE = "float32"
        tiny.SOLVER.OPTIMIZER = name
        tiny_batch = synthetic_batch(2, 128, 160, max_gt=4, num_classes=tiny.MODEL.NUM_CLASSES,
                                     seed=5)
        losses, stepped = {}, {}
        for d in ("cpu", dev):
            model, optimizer, state = create_train_state(tiny, d, seed=0)
            step_fn = make_train_step(tiny, model, optimizer)
            ms = []
            for _ in range(2):
                state, m = step_fn(state, tiny_batch)
                ms.append({k: float(v) for k, v in m.items()})
            losses[d] = ms
            # the optimizer alone, on the same seeded gradients
            model = build_model(tiny, d, seed=0)
            optimizer = build_optimizer(tiny, model)
            for i, lr in enumerate((1e-3, 2e-3)):
                rng = np.random.RandomState(i)
                for group in optimizer.param_groups:
                    group["lr"] = group["lr_scale"] * lr
                for p in model.parameters():
                    g = rng.standard_normal(tuple(p.shape)).astype(np.float32) * 1e-2
                    p.grad = torch.from_numpy(g).to(d) if p.requires_grad else None
                optimizer.step()
            stepped[d] = [p.detach().cpu() for p in model.parameters()] + [
                v.detach().cpu() for s in optimizer.state.values() for v in s.values() if v.dim()]
        worst = max(abs(g[k] - c[k]) / abs(c[k]) for c, g in zip(losses["cpu"], losses[dev])
                    for k in c if k.startswith("loss_") or k == "total_loss")
        if worst > 1e-4 or not all(math.isfinite(v) for m in losses[dev] for v in m.values()):
            raise AssertionError(f"[dp] {name}: the card's losses {losses[dev]} vs {losses['cpu']}")
        diff = max((g - c).abs().max().item() for c, g in zip(stepped["cpu"], stepped[dev]))
        for c, g in zip(stepped["cpu"], stepped[dev]):
            if not torch.allclose(g, c, rtol=OPT_RTOL, atol=OPT_ATOL):
                raise AssertionError(f"[dp] {name}: the optimizer on the card differs by "
                                     f"{(g - c).abs().max().item()}")
        print(f"[dp] {name} on the tiny model: 2 steps' losses on the card within {worst:.2g} "
              f"relative of the CPU port's (bound 1e-4); 2 updates on the same seeded gradients, "
              f"{len(stepped['cpu'])} parameters and moments within {diff:.3g} (rtol {OPT_RTOL}, "
              f"atol {OPT_ATOL})")
    print(f"[dp] (c) took {time.perf_counter() - t_c:.1f} s; the phase "
          f"{time.perf_counter() - t_phase:.1f} s | {card}")
    return launched["forward"], launched["backward"]

# Phase 17: the trunk and neck zoo (modeling/backbone/resnet.py, modeling/ws.py,
# modeling/context.py, modeling/fpn.py, modeling/necks_extra.py) at full width:
# name -> (base, keys over it, parameters that must move in the step).
# "flagship" is config.flagship_cfg() (CPM R-50-FPN, 81 classes, CMM, ISM,
# RSM, bf16); "faster" is FASTER_YAML.
ZOO_MODELS = {
    # Qiao et al., Weight Standardization, arXiv 1903.10520 (mmdetection gn+ws)
    "gn_ws": ("flagship", {"BACKBONE.RESNET.USE_GN": True, "BACKBONE.RESNET.USE_WS": True,
                           "FPN.USE_GN": True, "FPN.USE_WS": True}, ("fpn.norms.",)),
    # the same paper's "GN+WS all" Faster R-CNN, with the 4conv1fc head
    "faster_gn_ws_convfc": ("faster", {
        "BACKBONE.RESNET.USE_GN": True, "BACKBONE.RESNET.USE_WS": True, "FPN.USE_GN": True,
        "FPN.USE_WS": True, "FAST_RCNN.ROI_BOX_HEAD": "roi_xconv1fc_head",
        "FAST_RCNN.CONVFC_HEAD.USE_WS": True}, ("roi_head.head.convs.",)),
    # Ghiasi et al., NAS-FPN, arXiv 1904.07392 (7 stacks at 256, the JAX defaults)
    "nasfpn": ("flagship", {"FPN.BODY": "nasfpn"}, ("fpn.stage6_sum_77_7.",)),
    # Tan et al., EfficientDet, arXiv 1911.09070 (7 stacks at 256, EPS 1e-4)
    "bifpn": ("flagship", {"FPN.BODY": "bifpn"}, ("_fusion.w",)),
    # Sun et al., HRNet, arXiv 1904.04514 (AVG, one extra pooling)
    "hrfpn": ("flagship", {"FPN.BODY": "hrfpn"}, ("fpn.reduction_conv.",)),
    # He et al., Bag of Tricks (ResNet-D), arXiv 1812.01187; Cao et al.,
    # GCNet r16 c3-c5, arXiv 1904.11492
    "r50d_gcb": ("flagship", {"BACKBONE.RESNET.USE_3x3x3HEAD": True,
                              "BACKBONE.RESNET.AVG_DOWN": True,
                              "BACKBONE.RESNET.STAGE_WITH_CONTEXT": ("none", "gcb", "gcb", "gcb"),
                              "BACKBONE.RESNET.CTX_RATIO": 0.0625,
                              "FPN.EXTRA_CONV_LEVELS": True}, (".context.", "fpn.extra_p6.")),
    # Pet's AlignedResNet
    "aligned": ("flagship", {"BACKBONE.RESNET.USE_ALIGN": True}, (".conv2_3.",)),
    # the ResNet-18 trunk
    "r18": ("flagship", {"BACKBONE.RESNET.BOTTLENECK": False,
                         "BACKBONE.RESNET.LAYERS": (2, 2, 2, 2)}, ("backbone.layer4.",)),
}
ZOO_LATENCY = ("gn_ws", "nasfpn", "bifpn")  # batch-1 latency timed
# kernels 1 and 2 held against their plain versions at these models' pooler
# calls: the GN trunk's and FPN's levels reach the pooler through the model's
# channels_last copy, and BiFPN's through its resizes at 768x1344, shapes no
# other phase gives the kernels
ZOO_POOLER_CHECKED = ("gn_ws", "bifpn")
# BiFPN's resizes (the JAX package's and the reference's formula) need every
# level to halve exactly: an 800-row batch's 25-row C5 pools to a 12-row P6
# that the bottom-up path cannot reach again (ceil(25 / 12) = 3 gives 9
# rows). EfficientDet's inputs are multiples of 128; BiFPN runs at 768x1344.
ZOO_BUCKET = {"bifpn": (768, 1344)}


def _set_keys(cfg, keys):
    for key, value in keys.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


def zoo_cfg(name, tiny=False):
    """Phase 17's model `name` on the port's config; with `tiny`, its twin
    at the widths of tests/test_torch_zoo.py::zoo_cfg, in f32."""
    import os

    from cpm_tpu_torch.config import flagship_cfg
    from cpm_tpu_torch.tools.train_net import load_config

    base, keys, _ = ZOO_MODELS[name]
    repo = os.path.dirname(os.path.abspath(__file__))
    if base == "faster":
        yaml = "cfgs/debug/tiny_fast_rcnn.yaml" if tiny else FASTER_YAML
        cfg = load_config(os.path.join(repo, yaml), ["FAST_RCNN.SCORE_THRESH", "0.0"])
    else:
        cfg = flagship_cfg(tiny=tiny)
        cfg.GRID_RCNN.SCORE_THRESH = 0.0   # random weights score near 1/81
    cfg.SOLVER.BASE_LR = 0.0025
    cfg = _set_keys(cfg, keys)
    if tiny:
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.FPN.DIM = cfg.FPN.NASFPN.DIM = cfg.FPN.BIFPN.DIM = cfg.FPN.HRFPN.DIM = 32
        cfg.FPN.NASFPN.NUM_STACK = cfg.FPN.BIFPN.NUM_STACK = 2
        r = cfg.BACKBONE.RESNET
        if base == "faster":
            cfg.FAST_RCNN.MLP_HEAD.MLP_DIM = 64
            r.WIDTH = 32
            h = cfg.FAST_RCNN.CONVFC_HEAD
            h.CONV_DIM, h.NUM_STACKED_CONVS, h.MLP_DIM = 32, 2, 64
        elif r.USE_GN:
            r.BASE_PLANES = 32
        if not r.BOTTLENECK:
            r.LAYERS = (2, 1, 1, 1)
    return cfg


def fold_images():
    """The seeded batch whose statistics the tiny twins' affines are folded
    from (tests/test_torch_zoo.py folds from the same)."""
    return np.random.RandomState(9).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)


def phase_zoo_reference(dev):
    """The tiny twins in f32 on the card against the CPU port, with phase
    14's tolerances: eval detections (same_detections) and one training
    forward's losses on the same batch and draws (1e-4 relative). Each twin
    is built on the CPU with its frozen affines folded from a seeded batch
    (as tests/test_torch_zoo.py folds them), and the card's copy
    takes the same state. Seeded weights give the ISM branch's IoU logits
    near 0, of either sign, and ISM merged scores a detection by score x
    IoU, which RSM clamps at 0: the twins' fg IoU bias is set to 0.5 first
    (as phase 14 and tests/test_torch_cascade.py::_positive_iou do), so
    that detections score above 0. Those that still score 0 tie, and each
    device breaks the ties its own way: the detections are matched among
    those that score above 0, of which every image must have some, and
    their counts in all. The CPU port is held against the JAX package by
    tests/test_torch_zoo.py."""
    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.test import make_forward_fn
    from cpm_tpu_torch.modeling.model import build_model
    from cpm_tpu_torch.tools.profile_eval import make_request
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics
    from cpm_tpu_torch.utils.sampler import Draws

    for name in ZOO_MODELS:
        cfg = zoo_cfg(name, tiny=True)
        images, sizes = make_request(np.random.RandomState(1), [(64, 64), (56, 48)], (64, 64))
        batch = synthetic_batch(2, 64, 64, max_gt=4, num_classes=cfg.MODEL.NUM_CLASSES, seed=5)
        dets, losses, state = {}, {}, None
        for d in ("cpu", dev):
            model = build_model(cfg, d, seed=0)
            if state is None:
                fold_batch_statistics(model, fold_images())
                if cfg.MODEL.GRID_ON:
                    with torch.no_grad():
                        model.roi_head.grid_outputs[-1].iou_pred.bias.copy_(
                            torch.tensor([0.0, 0.5]))
                state = model.state_dict()
            else:
                model.load_state_dict(state)
            dets[d] = make_forward_fn(cfg, model)(images, sizes)
            tb = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
            out = model(tb["images"], tb["image_sizes"], train=True,
                        draws=Draws(torch.Generator().manual_seed(3)),
                        gt=dict(boxes=tb["gt_boxes"], labels=tb["gt_labels"], mask=tb["gt_mask"]))
            losses[d] = {k: float(v.detach()) for k, v in out.items()}
        for i in range(len(sizes)):
            if int(dets[dev].mask[i].sum()) != int(dets["cpu"].mask[i].sum()):
                raise AssertionError(f"[zoo reference] {name} image {i}: detection counts differ")
        scored = {d: v._replace(mask=v.mask & (v.scores > 0)) for d, v in dets.items()}
        if not all(int(m.sum()) for m in scored["cpu"].mask):
            raise AssertionError(f"[zoo reference] {name}: an image has no detection scoring "
                                 f"above 0 ({[int(m.sum()) for m in scored['cpu'].mask]})")
        same_detections(scored[dev], scored["cpu"], f"[zoo reference] {name}")
        worst = max(abs(losses[dev][k] - v) / abs(v) for k, v in losses["cpu"].items())
        if sorted(losses[dev]) != sorted(losses["cpu"]) or worst > 1e-4:
            raise AssertionError(f"[zoo reference] {name}: losses {losses[dev]} vs the CPU "
                                 f"port's {losses['cpu']}")
        print(f"[zoo reference] {name}: {[int(m.sum()) for m in dets['cpu'].mask]} detections, "
              f"as many as the CPU port's; those scoring above 0 "
              f"({[int(m.sum()) for m in scored['cpu'].mask]}) match it (labels exact, boxes "
              f"1e-2 px, scores 1e-4); {len(losses['cpu'])} losses within {worst:.2g} relative "
              f"(bound 1e-4)")


def check_zoo_sites(tag, kept, card):
    """Kernel 1 at the pooler calls of one of phase 17's eval forwards and
    steps, and kernel 2 at the step's, against their plain versions (the
    maps as the model gave them, scaled by a power of two; phase 1's and
    phase 3's tolerances)."""
    for what, calls in (("eval", kept["eval"]), ("step", kept["step"])):
        summed([check_kernel(f"{tag} {what} call {i}", *c, card, rescale=True)
                for i, c in enumerate(calls)], len(calls),
               f"{tag} kernel 1: the {len(calls)} pooler calls of one "
               f"{'batch-1 eval forward' if what == 'eval' else 'batch-2 training step'}", card)
    n = len(kept["backward"])
    summed([check_backward_kernel(f"{tag} step backward {i}", *c, card, rescale=True)
            for i, c in enumerate(kept["backward"])], n,
           f"{tag} kernel 2: the {n} backward calls of one batch-2 training step", card)
    torch.cuda.empty_cache()


def phase_zoo(dev, card):
    """Phase 17: the eight trunk and neck models of ZOO_MODELS at 800x1344,
    each through one batch-1 eval forward and one batch-2 training step with
    its launches predicted by `pooler_sites` (kernel 1 at every pooler call,
    kernel 2 at every call of a step), its losses, detections and parameters
    checked; three of them timed at batch 1; kernels 1 and 2 held against
    their plain versions on what the pooler calls of ZOO_POOLER_CHECKED's
    models gave them; the tiny twins on the card against the CPU port.
    Returns the launches of its driven runs."""
    t_phase = time.perf_counter()
    launched = {}
    for name, (_, _, must_move) in ZOO_MODELS.items():
        cfg = zoo_cfg(name)
        tag = f"[zoo {name}]"
        out = drive_model(tag, cfg, ZOO_BUCKET.get(name, (800, 1344)), card, dev=dev,
                          latency=name in ZOO_LATENCY, must_move=must_move,
                          keep_calls=name in ZOO_POOLER_CHECKED)
        print(f"{tag} peak device memory of the training step {out['step_peak_mib']:.1f} MiB "
              f"(max_memory_allocated) | {card}")
        for k, v in out["launched"].items():
            launched[k] = launched.get(k, 0) + v
        if "kept" in out:
            check_zoo_sites(tag, out.pop("kept"), card)
    print(f"[zoo] launches of the {len(ZOO_MODELS)} models' runs: "
          f"{ {k: v for k, v in launched.items() if v} }")
    phase_zoo_reference(dev)
    print(f"[zoo] phase took {time.perf_counter() - t_phase:.1f} s | {card}")
    return launched


# Phase 18: the rest of cpm_tpu/ that no model path selects (the loss zoo,
# matrix NMS, RoIPool and point sampling, the rotated ops, the layer zoo),
# SyncBatchNorm across two ranks, the flagship's FLOPs and parameters, and a
# training step under MODEL.INIT_SCHEME tpu. Each op on the card against the
# port on the CPU, on the same inputs, at the CPU tests' tolerances (rtol,
# atol); an atol applies per unit of the CPU result's RMS where that exceeds
# 1, since a full-width reduction (a 9216-term conv, a 1.6e8-term loss) sums
# terms that the tiny CPU tests never reach; a gradient, which sums its terms
# in another order on the card, is held at REST_CONV at least.
REST_F32 = (1e-5, 1e-6)
REST_CONV = (1e-5, 1e-5)
REST_ROT = (0.0, 1e-4)
REST_CPU_ROWS = 16  # rois (or IoU rows) of a full-size op that the CPU also runs


def rest_close(what, got, want, tol):
    """The card's result against the CPU port's (tol: rtol, atol per unit
    of RMS above 1), compared on the card; returns the largest absolute
    difference."""
    rtol, atol = tol
    g, w = got.detach().double(), want.detach().to(got.device, torch.float64)
    if g.shape != w.shape:
        raise AssertionError(f"[rest] {what}: shape {tuple(g.shape)} on the card, "
                             f"{tuple(w.shape)} on the CPU")
    if not torch.isfinite(g).all():
        raise AssertionError(f"[rest] {what}: non-finite values on the card")
    if not w.numel():
        return 0.0
    scale = max(1.0, float(w.pow(2).mean().sqrt()))
    err = (g - w).abs()
    bad = err > atol * scale + rtol * w.abs()
    if bad.any():
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"[rest] {what}: {int(bad.sum())} of {w.numel()} values beyond rtol "
                             f"{rtol} / atol {atol} x {scale:.3g}; e.g. {g.flatten()[i]:.8g} on the "
                             f"card, {w.flatten()[i]:.8g} on the CPU")
    return float(err.max())


def rest_cpu(fn, args, grad_of=(), check_dtype=None):
    """fn(*args) on the CPU (in `check_dtype` when given), and the gradients
    of <out, cotangent> for the args in `grad_of`."""
    xs = [x.to("cpu", check_dtype or x.dtype).detach().requires_grad_(i in grad_of)
          for i, x in enumerate(args)]
    out = fn(*xs)
    if grad_of:
        (out * _rest_cotangent(out.shape)).sum().backward()
    return out.detach(), {i: xs[i].grad for i in grad_of}


def _rest_cotangent(shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0))


def rest_check(what, fn, args, grad_of=(), tol=REST_F32, full=None, reps=10, card="",
               check_dtype=None, cpu=None):
    """fn(*args) on the card against the CPU port (`rest_cpu`, or its
    Future `cpu`), with the gradients of <out, cotangent> for the args in
    `grad_of` (in `check_dtype` when given); with `full` (args and the number
    of leading output rows that `args` gives), fn(*full) is the op timed,
    and its leading rows are held against the CPU's too. Prints one line
    with the CUDA-event times and the card; returns the largest error."""
    t0 = time.perf_counter()
    xs_g = [x.to("cuda", check_dtype or x.dtype).detach().requires_grad_(i in grad_of)
            for i, x in enumerate(args)]
    out_g = fn(*xs_g)
    out_c, grads_c = cpu.result() if cpu is not None else rest_cpu(fn, args, grad_of, check_dtype)
    err = rest_close(what, out_g, out_c, tol)
    if grad_of:
        (out_g * _rest_cotangent(out_g.shape).cuda()).sum().backward()
        # a gradient sums its terms in another order on the card (a gather's
        # backward adds with atomics): the convolution tolerance at least
        tol_g = tuple(max(a, b) for a, b in zip(tol, REST_CONV))
        for i in grad_of:
            err = max(err, rest_close(f"{what} gradient of input {i}", xs_g[i].grad,
                                      grads_c[i], tol_g))
    timed = args if full is None else full[0]
    if full is not None:
        with torch.no_grad():
            rows = fn(*[x.cuda() for x in timed])
        err = max(err, rest_close(f"{what} at full size, first rows", rows[:full[1]], out_c, tol))
    timed = [x.cuda() for x in timed]

    def forward():
        with torch.no_grad():
            fn(*timed)

    def forward_backward():
        xs = [x.detach().requires_grad_(i in grad_of) for i, x in enumerate(timed)]
        out = fn(*xs)
        out.backward(torch.ones_like(out))

    ms = cuda_ms(forward, reps)
    text = f"forward {ms:.3f} ms"
    if grad_of:
        text += f", forward+backward {cuda_ms(forward_backward, reps):.3f} ms"
    print(f"[rest] {what}: {text} (CUDA events, median of {reps}); card against the CPU port: "
          f"max |diff| {err:.3g} (rtol {tol[0]}, atol {tol[1]}); the line took "
          f"{time.perf_counter() - t0:.1f} s of host time | {card}")
    return err


def _rest_boxes(rng, n, hw=(800, 1344), lo=16.0, hi=400.0):
    xy = rng.uniform(0, 1, (n, 2)) * np.array([hw[1], hw[0]])
    wh = rng.uniform(lo, hi, (n, 2))
    return xy, wh


def _rest_rotated(rng, n, n_objects=300):
    """n rotated boxes (cx, cy, w, h, deg) jittered around a few hundred
    objects of an 800x1344 image, so that NMS has clusters to thin."""
    c, wh = _rest_boxes(rng, n_objects, lo=20.0, hi=200.0)
    a = rng.uniform(-90, 90, (n_objects, 1))
    obj = rng.randint(0, n_objects, n)
    boxes = np.concatenate([c[obj] + rng.normal(0, 4, (n, 2)), wh[obj] * rng.uniform(0.9, 1.1, (n, 2)),
                            a[obj] + rng.normal(0, 5, (n, 1))], 1)
    return torch.from_numpy(boxes.astype(np.float32))


def sync_bn_rank(rank, world_size, workdir, x, cot):
    """A spawned rank of phase 18's SyncBatchNorm check: its rows of x on
    cuda:0, the group over gloo; returns its output, input and parameter
    gradients and running statistics."""
    from cpm_tpu_torch.modeling.layers import SyncBatchNorm
    from cpm_tpu_torch.parallel.launch import file_init_method
    from cpm_tpu_torch.parallel.mesh import init_data_group

    init_data_group("cuda", rank=rank, world_size=world_size, local_rank=0, backend="gloo",
                    init_method=file_init_method(workdir, "sync_bn"))
    n = x.shape[0] // world_size
    bn = SyncBatchNorm(x.shape[1]).cuda().train()
    xs = x[rank * n:(rank + 1) * n].cuda().requires_grad_(True)
    out = bn(xs)
    (out * cot[rank * n:(rank + 1) * n].cuda()).sum().backward()
    return {"out": out.detach().cpu(), "grad": xs.grad.cpu(),
            **{k: v.grad.cpu() for k, v in bn.named_parameters()},
            **{k: v.cpu() for k, v in bn.named_buffers()}}


def phase_rest(dev, card):
    """Phase 18: every op and layer that cpm_tpu_torch/ gained for the rest
    of cpm_tpu/ on the card at a realistic size against the CPU port; the
    SyncBatchNorm across two gloo ranks against one process; the flagship's
    eval FLOPs and its parameter count against the JAX package's; one step
    of the flagship under MODEL.INIT_SCHEME tpu. Returns the launches of
    kernels 1 and 2 in the last two (the only model runs)."""
    from cpm_tpu_torch.modeling import initializers as init
    from cpm_tpu_torch.modeling import layers as L
    from cpm_tpu_torch.ops import losses, rotated
    from cpm_tpu_torch.ops.nms import matrix_nms
    from cpm_tpu_torch.ops.roi_pool import pool_points_interp, roi_pool
    from cpm_tpu_torch.parallel.launch import spawn_ranks
    from cpm_tpu_torch.utils.sampler import Draws

    t_phase = time.perf_counter()
    rng = np.random.RandomState(18)
    g = torch.Generator().manual_seed(18)
    k = REST_CPU_ROWS

    # SyncBatchNorm: two gloo ranks sharing the card against one process; the
    # ranks start now, on a thread of their own, and are checked last
    bn_x = torch.randn(4, 8, 5, 6, generator=g) * 2 + 1
    bn_cot = torch.randn(4, 8, 5, 6, generator=g)
    t_spawn = time.perf_counter()
    spawned = concurrent.futures.ThreadPoolExecutor(1)
    ranks_future = spawned.submit(spawn_ranks, sync_bn_rank, 2, bn_x, bn_cot, timeout_s=300)

    # the inputs: the C4 map of phase 7 and 512 rois on it (bins of up to 11
    # cells: some past roi_pool's lattice of 8); 2000 rotated boxes; the
    # anchors of a batch-2 800x1344 RetinaNet (P2-P6, 9 a cell) by 80 classes
    c4 = torch.randn(2, 50, 84, 1024, generator=g)
    xy, wh = _rest_boxes(rng, 512, hi=1200.0)
    rois = torch.from_numpy(np.concatenate([rng.randint(0, 2, (512, 1)), xy, xy + wh], 1)
                            .astype(np.float32))
    boxes = _rest_rotated(rng, 2000)
    scores = torch.rand(2000, generator=g)
    quads = rotated.rotated_box_corners(boxes).reshape(-1, 8)
    n_anchors = 2 * 9 * sum(math.ceil(800 / s) * math.ceil(1344 / s) for s in (4, 8, 16, 32, 64))
    logits = torch.randn(n_anchors, 80, generator=g)
    focal_labels = torch.from_numpy(rng.randint(-1, 81, n_anchors))

    def pool_fn(f, r):
        return roi_pool(f, r, (7, 7), 1 / 16)

    def focal_fn(x):
        return losses.sigmoid_focal_loss(x, focal_labels.to(x.device), 81)

    nms_ops = (("nms_rotated", rotated.nms_rotated, rotated.box_iou_rotated, boxes),
               ("poly_nms", rotated.poly_nms, rotated.poly_iou, quads))
    # the heaviest CPU references run on a thread of their own while the card
    # works (torch's CPU ops release the GIL)
    background = concurrent.futures.ThreadPoolExecutor(1)
    cpu_pool = background.submit(rest_cpu, pool_fn, [c4, rois[:k]], (0,))
    cpu_nms = {name: background.submit(fn, b, scores, 0.7, 1000) for name, fn, _, b in nms_ops}
    cpu_focal = background.submit(rest_cpu, focal_fn, [logits], (0,))

    rest_check("roi_pool 7x7, 512 rois (bins up to 11 cells, lattice 8) on [2, 50, 84, 1024] "
               "f32 at 1/16", pool_fn, [c4, rois[:k]], (0,), full=([c4, rois], k), reps=5,
               card=card, cpu=cpu_pool)
    p2 = torch.randn(2, 256, 200, 336, generator=g).contiguous(memory_format=torch.channels_last)
    pts = torch.from_numpy(np.concatenate([rng.randint(0, 2, (9000, 1)),
                                           rng.uniform(-10, 1354, (9000, 1)),
                                           rng.uniform(-10, 810, (9000, 1))], 1).astype(np.float32))
    rest_check("pool_points_interp, 9000 points on P2 [2, 256, 200, 336] f32 at 1/4",
               lambda f, p: pool_points_interp(f.permute(0, 2, 3, 1), p, 0.25), [p2, pts], (0, 1),
               card=card)
    rrois = torch.cat([torch.from_numpy(rng.randint(0, 2, (512, 1)).astype(np.float32)),
                       boxes[:512]], 1)
    # its sample coordinates come through cos and sin, which round differently
    # on the card: an ulp of a coordinate of up to 84 cells moves a bilinear
    # weight by about 1e-6, so the convolution tolerance
    rest_check("roi_align_rotated 7x7 sampling 2, 512 rotated rois on [2, 50, 84, 1024] f32 at "
               "1/16", lambda f, r: rotated.roi_align_rotated(f, r, (7, 7), 1 / 16, 2),
               [c4, rrois[:k]], (0,), REST_CONV, full=([c4, rrois], k), reps=5, card=card)
    del p2

    # rotated IoU (two sets: a box against itself, every vertex on a clipping
    # line, is ill-conditioned in f32) and the NMS over 2000 boxes, keeping
    # 1000 at IoU 0.7
    others = _rest_rotated(rng, 2000)
    rest_check("box_iou_rotated 2000 x 2000", rotated.box_iou_rotated, [boxes[:k], others], (),
               REST_ROT, full=([boxes, others], k), reps=5, card=card)
    for name, fn, iou_fn, b in nms_ops:
        t0 = time.perf_counter()
        idx_g, keep_g = fn(b.cuda(), scores.cuda(), 0.7, 1000)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        ms = cuda_ms(lambda: fn(b.cuda(), scores.cuda(), 0.7, 1000), 3)
        idx_c, keep_c = cpu_nms[name].result()
        got = set(idx_g[keep_g].tolist())
        want = set(idx_c[keep_c].tolist())
        flipped = sorted(got ^ want)
        if flipped:
            # a keep may flip only where an IoU that decides it lies at the threshold
            near = set(torch.nonzero((iou_fn(b, b) - 0.7).abs() < 1e-5).flatten().tolist())
            if not set(flipped) <= near:
                raise AssertionError(f"[rest] {name}: keeps {flipped} differ between the card "
                                     f"and the CPU away from the threshold")
        print(f"[rest] {name} over 2000 boxes at IoU 0.7, keeping up to 1000: {len(want)} kept, "
              f"the card's set {'equal to' if not flipped else 'within threshold ties of'} the "
              f"CPU's ({len(flipped)} flipped); {ms:.3f} ms (CUDA events, median of 3, host "
              f"reads of the fixed point included; first call {first_s * 1e3:.1f} ms) | {card}")
    xy, wh = _rest_boxes(rng, 500, hi=300.0)
    mboxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 80, 500))
    for method in ("gauss", "linear"):
        rest_check(f"matrix_nms ({method}) over 500 boxes of 80 labels",
                   lambda b, s: matrix_nms(b, s, labels.to(b.device), method=method),
                   [mboxes, torch.rand(500, generator=g)], card=card)

    # the losses: the focal loss over the anchors, Lovasz-softmax over 21
    # classes at 512x512
    rest_check(f"sigmoid_focal_loss over {n_anchors} anchors x 80 classes", focal_fn, [logits],
               (0,), REST_CONV, reps=5, card=card, cpu=cpu_focal)
    background.shutdown()
    del logits, c4
    seg = torch.randn(2, 21, 512, 512, generator=g)
    seg_labels = torch.from_numpy(rng.randint(0, 21, (2, 512, 512)))
    seg_labels[torch.from_numpy(rng.rand(2, 512, 512) < 0.05)] = 255
    rest_check("lovasz_softmax over [2, 21, 512, 512] (5% ignored)",
               lambda x: losses.lovasz_softmax(x, seg_labels.to(x.device), 255), [seg], (0,),
               REST_CONV, reps=3, card=card)
    del seg

    # the layer zoo on a res4 map, forward and backward
    res4 = torch.randn(2, 1024, 50, 84, generator=g)
    for name, fn in (("mish", L.mish), ("swish", L.swish), ("h_swish", L.h_swish),
                     ("h_sigmoid", L.h_sigmoid)):
        rest_check(f"{name} on [2, 1024, 50, 84]", fn, [res4], (0,), card=card)

    def layer(module, draws=None):
        """The module, copied to the device and dtype of its input."""
        copies = {}

        def fn(x):
            m = copies.setdefault((x.device.type, x.dtype),
                                  copy.deepcopy(module).to(x.device, x.dtype))
            return m(x) if draws is None else m(x, draws(x.device))
        return fn

    lg = torch.Generator().manual_seed(1)
    f64 = torch.float64
    zoo = [
        ("SwishX", L.SwishX(), REST_F32, res4, None),
        ("Scale", L.Scale(1.5), REST_F32, res4, None),
        ("L2Norm", L.L2Norm(1024), REST_F32, res4, None),
        # the convolutions are held in f64: a 9216-term f32 sum differs between
        # cuDNN's algorithms and the CPU's by more than 1e-5 of its RMS in the
        # tail of 2M outputs (one output of Conv2dWS in one call); timed in f32
        ("Conv2dWS 3x3 1024->256", L.Conv2dWS(1024, 256, generator=lg), REST_CONV, res4, f64),
        ("Conv2dSamePadding 3x3 s2 1024->256", L.Conv2dSamePadding(1024, 256, strides=(2, 2),
                                                                   generator=lg), REST_CONV, res4,
         f64),
        ("ECA k3", L.ECA(3, generator=lg), REST_F32, res4, None),
        ("NonLocal2d inner 512", L.NonLocal2d(1024, 512, generator=lg), REST_CONV, res4, f64),
        ("SyncBatchNorm (this process's batch)", L.SyncBatchNorm(1024).train(),
         REST_CONV, res4, None),
        ("MixtureNorm gn", L.MixtureNorm(1024, generator=lg), REST_CONV, res4, None),
        ("MixtureNorm bn", L.MixtureNorm(1024, base="bn", generator=lg).train(), REST_CONV, res4,
         None),
        # and SplAtConv2d for its ReLU's kink too, which turns with the sign of
        # a pre-activation within f32 noise of 0 (a few of 17M) and moves a
        # whole 3x3x128 window of the input's gradient
        ("SplAtConv2d 256 radix 2", L.SplAtConv2d(256, 256, generator=lg), REST_CONV,
         torch.randn(2, 256, 100, 168, generator=g), f64),
    ]
    for name, module, tol, x, check_dtype in zoo:
        rest_check(f"{name} on {list(x.shape)}" + (" (held in f64)" if check_dtype else ""),
                   layer(module), [x], (0,), tol, reps=5, card=card, check_dtype=check_dtype)
    rest_check("DropBlock2D p 0.1 block 7 (training; one seeded draw on both devices)",
               layer(L.DropBlock2D(0.1, 7).train(),
                     draws=lambda d: Draws(torch.Generator().manual_seed(7))),
               [res4], (0,), reps=3, card=card)
    del res4

    # the flagship under the tpu scheme: its eval FLOPs and parameters, then a step
    launched = {}

    def counted(fn):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for name, n in launch_counts().items():
            launched[name] = launched.get(name, 0) + n
        return out

    from cpm_tpu_torch.data.synthetic import synthetic_batch
    from cpm_tpu_torch.engine.train import create_train_state, make_train_step
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics, training_cfg
    from cpm_tpu_torch.utils.measure import FLAGSHIP_JAX_PARAMS, flops_and_params

    t0 = time.perf_counter()
    cfg = training_cfg()  # the flagship, with the JAX package's train-time proposal count
    cfg.MODEL.INIT_SCHEME = "tpu"
    model, optimizer, state = create_train_state(cfg, dev, seed=0)
    images = synthetic_batch(1, 800, 1344, num_classes=81, seed=3, uint8=True)
    stats = counted(lambda: flops_and_params(cfg, model, images["images"], images["image_sizes"]))
    if stats["params"] != FLAGSHIP_JAX_PARAMS:
        raise AssertionError(f"[rest] the flagship has {stats['params']} parameters, the JAX "
                             f"package's {FLAGSHIP_JAX_PARAMS}")
    print(f"[rest] flops_and_params of the flagship's batch-1 eval forward at 800x1344 "
          f"({cfg.TPU.COMPUTE_DTYPE}): {stats['eval_forward_flops'] / 1e9:.2f} GFLOP (products "
          f"and convolutions; the RoIAlign kernels count zero), {stats['params']} parameters, "
          f"the JAX package's count; by module {stats['params_by_module']}; built and counted "
          f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    priors = [m.deconv2.bias for m in model.roi_head.modules() if hasattr(m, "deconv2")]
    if not priors or any(not torch.all(b == init.PRIOR_BIAS) for b in priors):
        raise AssertionError("[rest] MODEL.INIT_SCHEME tpu: the heatmap deconvs' biases are not "
                             "the prior")
    batch = synthetic_batch(2, 800, 1344, max_gt=32, num_classes=81, seed=100, uint8=True)
    fold_batch_statistics(model, batch["images"])
    step_fn = make_train_step(cfg, model, optimizer)
    _, metrics = counted(lambda: step_fn(state, batch))
    bad = {k: float(v) for k, v in metrics.items() if k != "lr" and not math.isfinite(float(v))}
    if bad:
        raise AssertionError(f"[rest] MODEL.INIT_SCHEME tpu: non-finite losses {bad}")
    print(f"[rest] one training step of the flagship under MODEL.INIT_SCHEME tpu (lecun_normal "
          f"trunk, {len(priors)} heatmap deconvs at the prior bias): total_loss "
          f"{float(metrics['total_loss']):.4f}, every loss finite, in {time.perf_counter() - t0:.1f}"
          f" s; launches of both model runs { {k: v for k, v in launched.items() if v} }")

    ranks = ranks_future.result()
    spawned.shutdown()
    spawn_s = time.perf_counter() - t_spawn
    bn = L.SyncBatchNorm(8).cuda().train()
    xs = bn_x.cuda().requires_grad_(True)
    out = bn(xs)
    (out * bn_cot.cuda()).sum().backward()
    err = max(rest_close("SyncBatchNorm over two ranks: output", torch.cat([r["out"] for r in ranks]),
                         out, REST_F32),
              rest_close("SyncBatchNorm over two ranks: input gradient",
                         torch.cat([r["grad"] for r in ranks]), xs.grad, REST_F32))
    for name, p in list(bn.named_parameters()) + list(bn.named_buffers()):
        theirs = [r[name] for r in ranks]
        # each rank holds its share of a parameter's gradient; the statistics are every rank's
        got = theirs[0] + theirs[1] if p.requires_grad else theirs[0]
        err = max(err, rest_close(f"SyncBatchNorm over two ranks: {name}", got,
                                  p.grad if p.requires_grad else p, REST_F32))
        if not p.requires_grad and not torch.equal(theirs[0], theirs[1]):
            raise AssertionError(f"[rest] SyncBatchNorm: the ranks' {name} differ")
    print(f"[rest] SyncBatchNorm over two gloo ranks on one card, 2 of 4 images each: output, "
          f"gradients and running statistics equal one process's over the 4 to {err:.3g} "
          f"(rtol 1e-5, atol 1e-6); spawn to results {spawn_s:.1f} s, beside the phase's "
          f"other work | {card}")
    del model, optimizer, state
    print(f"[rest] phase took {time.perf_counter() - t_phase:.1f} s | {card}")
    return launched


class _Tee:
    """A text stream that writes to each of `streams` (to read what a CLI
    prints while it still prints)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def loader_times(cfg, card, batches=6):
    """The host's time to make one train batch and to load one eval image on
    each decode path that builds here: {'native' | 'pil': {'train_batch_ms',
    'eval_image_ms'}}. Host time only: `TrainLoader` on this thread
    (`prefetch=0`), the median of `batches` batches after a first one that
    starts the pool; `TestLoader` over the eval images on this thread
    (`prefetch=0`), the mean an image.
    The PIL path is a loader told `native = None`."""
    import os

    from cpm_tpu_torch import native
    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.data.loader import TestLoader, TrainLoader

    (train_set,) = build_dataset(cfg, cfg.TRAIN.DATASETS, is_train=True)
    (test_set,) = build_dataset(cfg, cfg.TEST.DATASETS, is_train=False)

    def train_batch_ms(path):
        loader = TrainLoader(cfg, train_set, cfg.TRAIN.BATCH_SIZE, seed=cfg.SEED, prefetch=0)
        if path == "pil":
            loader.native, loader.decode_path = None, "pil"
        it = iter(loader)
        try:
            next(it)  # the pool's start and the first reads
            times = []
            for _ in range(batches):
                t0 = time.perf_counter()
                next(it)
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            it.close()
        other = "pil" if path == "native" else "native"
        if loader.decoded[path] == 0 or loader.decoded[other]:
            raise AssertionError(f"[native] the {path} train timing decoded {loader.decoded}")
        return statistics.median(times)

    def eval_image_ms(path):
        loader = TestLoader(cfg, test_set, prefetch=0)
        if path == "pil":
            loader.native, loader.decode_path = None, "pil"
        t0 = time.perf_counter()
        n = sum(item["count"] for item in loader)
        seconds = time.perf_counter() - t0
        if loader.decoded[path] != n:
            raise AssertionError(f"[native] the {path} eval timing decoded {loader.decoded}")
        return seconds * 1e3 / n

    paths = ["native", "pil"] if native.load() is not None else ["pil"]
    bh, bw = TrainLoader(cfg, train_set, 1).buckets["landscape"]
    out = {}
    for path in paths:
        out[path] = dict(train_batch_ms=train_batch_ms(path), eval_image_ms=eval_image_ms(path))
        print(f"[native] {path} decode: one train batch ({cfg.TRAIN.BATCH_SIZE} images, the "
              f"{bh}x{bw} bucket) {out[path]['train_batch_ms']:.2f} ms, median of {batches}; one "
              f"eval image ({cfg.TEST.SCALE}x{cfg.TEST.MAX_SIZE}) "
              f"{out[path]['eval_image_ms']:.2f} ms, mean of {len(test_set)}; "
              f"{os.cpu_count()} host cores | {card}")
    if "native" in out:
        print(f"[native] pil / native: train batch "
              f"{out['pil']['train_batch_ms'] / out['native']['train_batch_ms']:.2f}x, eval image "
              f"{out['pil']['eval_image_ms'] / out['native']['eval_image_ms']:.2f}x | {card}")
    return out


def phase_native(dev, card):
    """Phase 19: the native host decode pool (cpm_tpu_torch/native) under
    both CLIs. Returns the multilevel kernels' launches in its runs."""
    import io
    import os
    import tempfile

    from cpm_tpu_torch import native
    from cpm_tpu_torch.data.coco import build_dataset
    from cpm_tpu_torch.data.loader import TrainLoader
    from cpm_tpu_torch.engine.checkpoint import CheckPointer
    from cpm_tpu_torch.engine.train import create_train_state
    from cpm_tpu_torch.tools import test_net, train_net
    from cpm_tpu_torch.tools.profile_train import fold_batch_statistics

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    missing = native.missing_prerequisites()
    native.load()
    status = native.status()
    if status is None or not status.built:
        if missing is None:
            raise AssertionError(f"[native] g++ and libjpeg / libpng are here, but the native "
                                 f"decode library did not build:\n{status and status.error}")
        print(f"[native] native decode: not built: {missing}")
        loader_times(train_net.load_config(
            os.path.join(repo, HEADLINE_YAML),
            CLI_TRAIN_OPTS + CLI_TEST_OPTS + ["DATA_DIR", os.path.join(repo, "data")]), card)
        print(f"[native] phase took {time.perf_counter() - t_phase:.1f} s")
        return (0, 0)
    print(f"[native] native decode library built: {status.path.name}, linked by the "
          f"{status.route} route, "
          + (f"g++ took {status.seconds:.2f} s" if status.seconds else "found already built")
          + f" ({native.CXX} {' '.join(native.CXX_FLAGS)})")

    cfg_file = os.path.join(repo, HEADLINE_YAML)
    opts = CLI_TRAIN_OPTS + ["DATA_DIR", os.path.join(repo, "data")]
    cfg = train_net.load_config(cfg_file, opts)
    stages = cfg.GRID_RCNN.CASCADE_MAPPING_OPTION.STAGE_NUM
    sites = 1 + stages + int(cfg.GRID_RCNN.RESCORE_ON)
    losses = (["loss_objectness", "loss_rpn_box_reg", "loss_classifier"]
              + [f"loss_grid_{s + 1}" for s in range(stages)]
              + [f"loss_iou_{stages}", "loss_rescore", "total_loss"])
    fwd = ops()["multilevel"].KERNEL

    def run(what, fn, argv, want_fwd, want_bwd):
        """fn(argv) with its output read as it prints; the launches held to
        the multilevel kernels' and the decode path to 'native'."""
        reset_launch_counts()
        printed = io.StringIO()
        with contextlib.redirect_stdout(_Tee(sys.stdout, printed)):
            out = fn(argv)
        got = launch_counts()
        others = {k: v for k, v in got.items() if v and not k.startswith("multilevel_roi_align")}
        if (fwd.launches, fwd.backward_launches) != (want_fwd, want_bwd) or others:
            raise AssertionError(f"[native] {what}: launched {got}, want multilevel_roi_align "
                                 f"{want_fwd} and its backward {want_bwd}, no other")
        paths = [ln.split(":", 1)[1].strip() for ln in printed.getvalue().splitlines()
                 if ln.startswith("decode path:")]
        if len(paths) != 1 or not paths[0].startswith("native"):
            raise AssertionError(f"[native] {what}: decode path lines {paths}, want one native")
        print(f"[native] {what}: decode path {paths[0]}; launches multilevel_roi_align "
              f"{fwd.launches}, backward {fwd.backward_launches}")
        torch.cuda.empty_cache()
        return out

    (dataset,) = build_dataset(cfg, cfg.TRAIN.DATASETS, is_train=True)
    test_cfg = train_net.load_config(cfg_file, opts + CLI_TEST_OPTS)
    (test_set,) = build_dataset(test_cfg, test_cfg.TEST.DATASETS, is_train=False)
    with tempfile.TemporaryDirectory(prefix="cpm_native_") as tmp:
        # a step-0 checkpoint with the frozen affines folded from the
        # loader's first (native) batch, as phase 12 writes one
        model, optimizer, state = create_train_state(cfg, dev, cfg.SEED)
        first_loader = TrainLoader(cfg, dataset, cfg.TRAIN.BATCH_SIZE, seed=cfg.SEED, prefetch=0)
        first = _batches(first_loader, 1)[0]
        if first_loader.decode_path != "native":
            raise AssertionError(f"[native] the TrainLoader decodes on {first_loader.decode_path}")
        fold_batch_statistics(model, first["images"])
        CheckPointer(tmp).save(state, 0)
        del model, optimizer, state
        torch.cuda.empty_cache()

        history = run("train_net 4 steps", train_net.main,
                         ["--cfg", cfg_file, "--device", dev] + opts
                         + ["CKPT", tmp, "SOLVER.MAX_ITER", "4"], 4 * sites, 4 * sites)
        for r in history:
            if not all(math.isfinite(r.get(k, math.nan)) for k in losses):
                raise AssertionError(f"[native] train_net iter {r['iter']}: losses {r}")
        if [r["iter"] for r in history] != [1, 2, 3, 4]:
            raise AssertionError(f"[native] train_net iterations {[r['iter'] for r in history]}")
        waits = [r["wait_s"] for r in history]
        print(f"[native] train_net: losses finite over 4 steps, total_loss "
              f"{[round(r['total_loss'], 4) for r in history]}, loader wait "
              f"{statistics.median(waits) * 1e3:.1f} ms median (max {max(waits) * 1e3:.1f}) | {card}")

        out = run("test_net", test_net.main,
                  ["--cfg", cfg_file, "--device", dev, "DATA_DIR", os.path.join(repo, "data"),
                   "CKPT", tmp] + CLI_TEST_OPTS, sites * len(test_set), 0)
        results = out["results"]
        if not results:
            raise AssertionError("[native] test_net: no detections")
        sizes = {test_set.id_to_img_map[i]: test_set.get_img_info(i) for i in range(len(test_set))}
        for r in results:
            x, y, w, h = r["bbox"]
            info = sizes[r["image_id"]]
            if not (0 <= x and 0 <= y and w >= 0 and h >= 0 and x + w - 1 < info["width"]
                    and y + h - 1 < info["height"]) or not math.isfinite(r["score"]):
                raise AssertionError(f"[native] test_net: result {r} outside its "
                                     f"{info['width']}x{info['height']} image")
        print(f"[native] test_net: {len(results)} detections over {len(test_set)} images, every "
              f"box inside its image")

    loader_times(test_cfg, card)
    print(f"[native] phase took {time.perf_counter() - t_phase:.1f} s")
    return (4 * sites, 4 * sites)


def phase_nms(dev, card):
    """Phase 20: the NMS kernels and the RPN's candidate kernel against their
    plain versions, bit for bit, at the cells' proposal selection
    (`tools/probe_nms.py::probe_cell`, which also holds `select_proposals` to
    the per-level loop) and at the detection filter. Returns the two
    kernels' results as one forward's sites: the serving cell's RPN call and
    one filter call (NMS), the serving cell's call (candidates)."""
    from cpm_tpu_torch.ops.nms import batched_nms
    from cpm_tpu_torch.tools.probe_nms import CELLS, fixed_point_nms, nms_bound_ms, probe_cell

    results = {cell: probe_cell(cell, 7, 10, card, tag="[nms]") for cell in CELLS}
    nms_sites = {cell: r["nms"] for cell, r in results.items()}
    candidate_sites = {cell: r["candidates"] for cell, r in results.items()}

    # the detection filter's call: 1024 candidates of an image, label-aware
    # through coordinate offsets, 100 slots
    rng = np.random.RandomState(8)
    centres = rng.rand(60, 2) * 800
    ctr = centres[rng.randint(0, 60, (1, 1024))] + rng.randn(1, 1024, 2) * 8
    wh = rng.rand(1, 1024, 2) * 120 + 4
    boxes = torch.tensor(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1), dtype=torch.float32,
                         device=dev)
    scores = torch.tensor(rng.rand(1, 1024), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.randint(1, 81, (1, 1024)), device=dev)
    valid = scores > 0.05
    max_coord = torch.amax(boxes, dim=(-2, -1), keepdim=True) + 1.0
    shifted = boxes + labels.to(boxes.dtype)[..., None] * max_coord
    got = batched_nms(boxes, scores, labels, 0.5, 100, mask=valid)
    if not all(torch.equal(a, b) for a, b in zip(got, fixed_point_nms(shifted, scores, 0.5, 100,
                                                                      valid))):
        raise AssertionError("[nms] filter: the NMS kernels differ from the fixed point")
    nms_sites["filter"] = dict(
        err=0.0, bound_by="bytes", bound_ms=nms_bound_ms(1, 1024, 100),
        ms=cuda_ms(lambda: batched_nms(boxes, scores, labels, 0.5, 100, mask=valid)),
        plain_ms=cuda_ms(lambda: fixed_point_nms(shifted, scores, 0.5, 100, valid)))
    print(f"[nms] filter: batched_nms over 1024 candidates, 100 slots: "
          f"{nms_sites['filter']['ms']:.4f} ms with its offsets and sort, fixed point "
          f"{nms_sites['filter']['plain_ms']:.4f} ms, bound {nms_sites['filter']['bound_ms']:.4f} ms "
          f"(bytes) | {card}")
    return (summed([nms_sites["serve"], nms_sites["filter"]], NMS_DRIVEN["nms"],
                   "[kernel] nms: the RPN's and the filter's calls of one batch-1 forward", card),
            summed([candidate_sites["serve"]], NMS_DRIVEN["rpn_candidates"],
                   "[kernel] rpn_candidates: the call of one batch-1 forward", card))


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
    # the native host decode library (g++), which both loaders use
    from cpm_tpu_torch import native

    native.load()
    st = native.status()
    print(f"[build] native decode library: "
          + (f"{st.path.name} ({st.route} route) in {st.seconds:.2f} s" if st.built
             else f"not built: {st.error.splitlines()[0]}"))

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
    torch.cuda.empty_cache()
    cascade = phase_cascade(dev, card)
    torch.cuda.empty_cache()
    options, single_sites, _ = phase_options(dev, card)
    torch.cuda.empty_cache()
    dp = phase_data_parallel(dev, card)
    torch.cuda.empty_cache()
    zoo = phase_zoo(dev, card)
    torch.cuda.empty_cache()
    rest = phase_rest(dev, card)
    torch.cuda.empty_cache()
    nat = phase_native(dev, card)
    torch.cuda.empty_cache()
    nms_stats, candidate_stats = phase_nms(dev, card)

    # launches on the driven paths: eval forwards plus training steps, and
    # the CLIs' runs
    launches = {
        "multilevel_roi_align": (fwd["auto"]["launches"] + bwd["auto"]["launches"][0]
                                 + x101_fwd["pooler_launches"] + x101_bwd["pooler_launches"][0]
                                 + cli[0] + ms[0] + cascade[0] + options["multilevel_roi_align"]
                                 + dp[0] + zoo["multilevel_roi_align"]
                                 + rest["multilevel_roi_align"] + nat[0]),
        "multilevel_roi_align_backward": (bwd["auto"]["launches"][1] + bwd["clustered"]["launches"][1]
                                          + x101_bwd["pooler_launches"][1] + cli[1] + ms[1]
                                          + cascade[1] + options["multilevel_roi_align_backward"]
                                          + dp[1] + zoo["multilevel_roi_align_backward"]
                                          + rest["multilevel_roi_align_backward"] + nat[1]),
        "clustered_roi_align": fwd["clustered"]["launches"] + bwd["clustered"]["launches"][0],
        "cluster_rois": fwd["clustered"]["grouping"]["launches"] + bwd["clustered"]["grouping_launches"],
        "stacked_roi_align": fwd["stacked"]["launches"] + bwd["stacked"]["launches"][0],
        "stacked_roi_align_backward": bwd["stacked"]["launches"][1],
        # phase 7's one-level Pooler and phase 15's model paths
        "roi_align": single["launches"] + options["roi_align"],
        "deform_sample": x101_fwd["launches"] + x101_bwd["launches"][0],
        "deform_sample_backward": x101_bwd["launches"][1],
        "crossroi_roi_align": crossroi["launches"],
        # phases 3 and 5: every flagship and X-101 request and step
        "nms": NMS_DRIVEN["nms"],
        "rpn_candidates": NMS_DRIVEN["rpn_candidates"],
    }
    print(f"[kernels] launches on the driven paths: {launches}")
    stats = {
        "multilevel_roi_align": (fwd["auto"], synthetic["multilevel"]),
        "multilevel_roi_align_backward": (bwd["auto"], synthetic_bwd["multilevel"]),
        "clustered_roi_align": (fwd["clustered"], synthetic["clustered"]),
        "cluster_rois": (fwd["clustered"]["grouping"], [r["grouping"] for r in synthetic["clustered"]]),
        "stacked_roi_align": (fwd["stacked"], synthetic["stacked"]),
        "stacked_roi_align_backward": (bwd["stacked"], synthetic_bwd["stacked"]),
        # timed at the FINEST_LEVEL_ROI model's two eval sites; phase 7's
        # errors count too
        "roi_align": (single_sites, [single]),
        # errors in f32, as for the other kernels (the bf16 ones are held to
        # their own tolerance where they are checked)
        "deform_sample": (x101_fwd, [r for r in sampler["forward"] if r["dtype"] == "float32"]),
        "deform_sample_backward": (
            x101_bwd, [r for r in sampler["backward"] if r["dtype"] == "float32"]),
        "crossroi_roi_align": (crossroi, []),
        # bit-equal to their plain versions wherever phase 20 checks them
        "nms": (nms_stats, []),
        "rpn_candidates": (candidate_stats, []),
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
