"""Proposal selection on one NVIDIA GPU: the batched pass against the
per-level loop it replaced, and the candidate and NMS kernels against their
plain versions.

    python3 -m cpm_tpu_torch.tools.probe_nms [--reps 20]

At the benchmark cells' shapes (`CELLS`: serving, one image at 800x1344 with
1000 candidates a level; training, four images at 864x1408 with 2000), on
seeded bfloat16 head outputs, it checks that `select_proposals` gives the
per-level loop's outputs bit for bit (`per_level_select`: each level's top-k,
decode, clip, size mask and fixed-point NMS in turn, as the port ran them
before one padded batch), and the candidate and NMS kernels their plain
versions' bits, and prints for each cell (`probe_cell`): the ATen ops each
way dispatches and its host time to a synchronise (the median of `--reps`),
the candidate kernel's time beside its plain version's, and the NMS
kernels' time on the padded rows (CUDA events, and device time by kernel
from `torch.profiler`) beside the fixed point's on the same rows. The bounds
are bytes over 3.35 TB/s: for the candidates each slot's reads and writes;
for NMS the mask (N x ceil(N/64) words a row, about N^2/8 bytes) written and
read, the boxes, validity and order read and the output slots written.
Every line that holds a number ends with the card's name and power limit.
"""

import argparse
import collections
import statistics
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cpm_tpu_torch.modeling.rpn import (
    AnchorLayout,
    keep_batch_top_k,
    level_candidates,
    level_candidates_plain,
    select_proposals,
)
from cpm_tpu_torch.ops.box_coder import BoxCoder
from cpm_tpu_torch.ops.nms import greedy_nms, sort_by_score, topk
from cpm_tpu_torch.structures.boxes import box_iou, clip_boxes_to_image, remove_small_boxes_mask

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
STRIDES = (4, 8, 16, 32, 64)
SIZES = (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)
NMS_THRESH = 0.7
CELLS = {
    "serve": dict(batch=1, padded=(800, 1344), images=[(800, 1333)], pre=1000, post=1000,
                  fpn_post=1000, train=False),
    "train": dict(batch=4, padded=(864, 1408), images=[(864, 1152), (768, 1400), (864, 1296),
                                                     (640, 1024)],
                  pre=2000, post=2000, fpn_post=2000, train=True),
}


def fixed_point_nms(boxes, scores, iou_threshold, max_output, mask=None, legacy_plus1=False):
    """`ops/nms.py::nms` by the plain fixed point on any device."""
    return greedy_nms(boxes, scores, iou_threshold, max_output, mask,
                      lambda a, b: box_iou(a, b, legacy_plus1=legacy_plus1))


def per_level_select(layout, objectness, box_regression, image_sizes, *, pre_nms_top_n,
                     post_nms_top_n, nms_thresh, min_size, fpn_post_nms_top_n, box_coder=None,
                     fpn_post_nms_per_batch=True, is_train=False, gt_boxes=None, gt_mask=None):
    """`modeling/rpn.py::select_proposals` as a loop over the levels: each
    level's top-k, gathers, `BoxCoder.decode`, clip, size mask and
    fixed-point NMS, then the levels' slots concatenated and the FPN top-k."""
    if box_coder is None:
        box_coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
    img_w = image_sizes[:, None, 1].float()
    img_h = image_sizes[:, None, 0].float()
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for obj, reg, anchors in zip(objectness, box_regression, layout.on(objectness[0].device)):
        B, H, W, A = obj.shape
        scores = torch.sigmoid(obj.float().reshape(B, H * W * A))
        deltas = reg.float().reshape(B, H * W * A, 4)
        k = min(pre_nms_top_n, scores.shape[1])
        top_scores, top_idx = topk(scores, k)
        top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(B, k, 4))
        proposals = box_coder.decode(top_deltas, anchors[top_idx])
        proposals = clip_boxes_to_image(proposals, (img_w, img_h))
        valid = remove_small_boxes_mask(proposals, min_size)
        idx, keep = fixed_point_nms(proposals, top_scores, nms_thresh, post_nms_top_n, valid)
        lvl_boxes.append(torch.gather(proposals, 1, idx[..., None].expand(*idx.shape, 4)))
        lvl_scores.append(torch.gather(top_scores, 1, idx))
        lvl_valid.append(keep)
    boxes = torch.cat(lvl_boxes, dim=1)
    scores = torch.cat(lvl_scores, dim=1)
    valid = torch.cat(lvl_valid, dim=1)
    if len(objectness) > 1:
        neg_inf = torch.finfo(scores.dtype).min
        masked = torch.where(valid, scores, neg_inf)
        if is_train and fpn_post_nms_per_batch:
            valid = keep_batch_top_k(masked, valid, fpn_post_nms_top_n)
            masked = torch.where(valid, scores, neg_inf)
        _, top_idx = topk(masked, min(fpn_post_nms_top_n, masked.shape[1]))
        boxes = torch.gather(boxes, 1, top_idx[..., None].expand(*top_idx.shape, 4))
        valid = torch.gather(valid, 1, top_idx)
        scores = torch.gather(scores, 1, top_idx)
    if is_train and gt_boxes is not None:
        boxes = torch.cat([boxes, gt_boxes.to(boxes.dtype)], dim=1)
        scores = torch.cat([scores, torch.ones_like(gt_mask, dtype=scores.dtype)], dim=1)
        valid = torch.cat([valid, gt_mask], dim=1)
    return boxes, scores, valid


def rpn_inputs(cell: str, seed: int, device, dtype=torch.bfloat16):
    """(layout, objectness, box_regression, image_sizes, select_proposals'
    keywords) of one cell: seeded head outputs in `dtype` at its padded
    shape, its true image sizes, and in training four ground-truth boxes an
    image."""
    c = CELLS[cell]
    h, w = c["padded"]
    shapes = [(-(-h // s), -(-w // s)) for s in STRIDES]
    layout = AnchorLayout(shapes, STRIDES, SIZES, RATIOS)
    g = torch.Generator().manual_seed(seed)
    b = c["batch"]
    objectness = [torch.randn(b, fh, fw, 3, generator=g).to(device, dtype) for fh, fw in shapes]
    box_regression = [(0.5 * torch.randn(b, fh, fw, 12, generator=g)).to(device, dtype)
                      for fh, fw in shapes]
    sizes = torch.tensor(c["images"], dtype=torch.int32, device=device)
    kw = dict(pre_nms_top_n=c["pre"], post_nms_top_n=c["post"], nms_thresh=NMS_THRESH,
              min_size=0, fpn_post_nms_top_n=c["fpn_post"])
    if c["train"]:
        xy = torch.rand(b, 4, 2, generator=g) * 500
        wh = torch.rand(b, 4, 2, generator=g) * 300 + 8
        kw.update(is_train=True, gt_boxes=torch.cat([xy, xy + wh], -1).to(device),
                  gt_mask=torch.ones(b, 4, dtype=torch.bool, device=device))
    return layout, objectness, box_regression, sizes, kw


class OpCount(TorchDispatchMode):
    """Counts the ATen ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))

    @property
    def total(self) -> int:
        return sum(self.ops.values())


def nms_bound_ms(rows: int, n: int, max_output: int, box_bytes: int = 16) -> float:
    """The least time of one NMS call over `rows` rows of n boxes: the mask
    written and read, the boxes, validity and order read, the slots written."""
    mask = n * -(-n // 64) * 8
    return rows * (2 * mask + n * (box_bytes + 1 + 8) + max_output * 9) / HBM_BYTES_PER_S * 1e3


def host_ms(fn, reps: int) -> float:
    """Median wall time of fn() to a synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms_by_kernel(fn, runs: int = 10) -> dict:
    """Device time of one fn() by kernel name, from `torch.profiler` over
    `runs` calls after a warm-up (the host's time between launches left out);
    empty where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / runs for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def probe_cell(cell: str, seed: int, reps: int, card: str, tag: str = "[probe_nms]") -> dict:
    """One cell's checks and times on the card, printed a line each: raises
    unless `select_proposals`, the candidate kernel and the NMS kernels give
    their plain versions' bits. Returns {"select": ..., "candidates": ...,
    "nms": ...}: the ATen ops and host times of `select_proposals` and the
    per-level loop, and each kernel's event time beside its plain version's
    and its bound (`ms`, `plain_ms`, `bound_ms`, `bound_by`, `err`)."""
    from cpm_tpu_torch.ops.cuda import nms as nms_op
    from cpm_tpu_torch.ops.cuda import rpn_candidates as candidates_op
    from cpm_tpu_torch.tools.bench_roi_align import cuda_ms

    tag = f"{tag} {cell}"
    layout, obj, reg, sizes, kw = rpn_inputs(cell, seed, "cuda")
    if not all(torch.equal(a, b) for a, b in zip(select_proposals(layout, obj, reg, sizes, **kw),
                                                 per_level_select(layout, obj, reg, sizes, **kw))):
        raise AssertionError(f"{tag}: select_proposals differs from the per-level loop")
    select = {}
    for name, fn in (("batched", select_proposals), ("per-level", per_level_select)):
        with OpCount() as count:
            fn(layout, obj, reg, sizes, **kw)
        select[name] = dict(ops=count.total,
                            host_ms=host_ms(lambda fn=fn: fn(layout, obj, reg, sizes, **kw), reps))
    print(f"{tag}: select_proposals equals the per-level loop bit for bit; ATen ops "
          f"{select['batched']['ops']} against {select['per-level']['ops']}; host time to a "
          f"synchronise {select['batched']['host_ms']:.3f} ms against "
          f"{select['per-level']['host_ms']:.3f} ms (median of {reps}) | {card}")

    coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
    pre, post = kw["pre_nms_top_n"], kw["post_nms_top_n"]
    boxes, scores, valid = level_candidates(layout, obj, reg, sizes, pre, 0, coder)
    plain = lambda: level_candidates_plain(layout.on("cuda"), obj, reg, sizes, pre, 0, coder)  # noqa: E731
    if not all(torch.equal(a, b) for a, b in zip((boxes, scores, valid), plain())):
        raise AssertionError(f"{tag}: the candidate kernel differs from its plain version")
    sorted_scores, orders = [], []
    for o in obj:
        vals, idx = torch.sort(torch.sigmoid(o.reshape(o.shape[0], -1).float()), dim=1,
                               descending=True, stable=True)
        sorted_scores.append(vals)
        orders.append(idx)
    level_k = [min(pre, n) for n in layout.level_sizes]
    slots = scores.numel()
    candidates = dict(
        err=0.0, bound_by="bytes",
        ms=cuda_ms(lambda: candidates_op.KERNEL(sorted_scores, orders, reg, layout.on("cuda"),
                                                sizes, level_k, coder, 0)),
        plain_ms=cuda_ms(plain),
        # each slot's sorted index and score, anchor and deltas read, its box,
        # score and flag written
        bound_ms=slots * (8 + 4 + 16 + 4 * reg[0].element_size() + 16 + 4 + 1)
        / HBM_BYTES_PER_S * 1e3)
    path_ms = cuda_ms(lambda: level_candidates(layout, obj, reg, sizes, pre, 0, coder))
    print(f"{tag}: candidate kernel over {slots} slots: {candidates['ms']:.4f} ms, with the "
          f"levels' sigmoids and sorts {path_ms:.4f} ms, plain version "
          f"{candidates['plain_ms']:.4f} ms, bound {candidates['bound_ms']:.4f} ms (bytes) "
          f"(CUDA events) | {card}")

    order, b_sorted, v_sorted = sort_by_score(boxes, scores, valid)
    run = lambda: nms_op.KERNEL(b_sorted, v_sorted, order, NMS_THRESH, post)  # noqa: E731
    got = run()
    if not all(torch.equal(a, b) for a, b in zip(
            got, fixed_point_nms(boxes, scores, NMS_THRESH, post, valid))):
        raise AssertionError(f"{tag}: the NMS kernels differ from the fixed point")
    rows, n = boxes.shape[0] * boxes.shape[1], boxes.shape[2]
    nms = dict(err=0.0, bound_by="bytes", bound_ms=nms_bound_ms(rows, n, post), ms=cuda_ms(run),
               plain_ms=cuda_ms(lambda: fixed_point_nms(boxes, scores, NMS_THRESH, post, valid)))
    device = ", ".join(f"{k.split('(')[0].split()[-1][:40]} {v:.4f} ms"
                       for k, v in device_ms_by_kernel(run).items())
    print(f"{tag}: NMS kernels over {rows} rows of {n}, {int(got[1].sum())} kept: "
          f"{nms['ms']:.4f} ms (CUDA events, the wrapper's host time in it), device time "
          f"{device or 'not measured'}, bound {nms['bound_ms']:.4f} ms (bytes), fixed point "
          f"{nms['plain_ms']:.4f} ms | {card}")
    return dict(select=select, candidates=candidates, nms=nms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_nms: needs a CUDA device")
    from cpm_tpu_torch.tools.profile_eval import card_line

    card = card_line()
    for cell in CELLS:
        probe_cell(cell, 0, args.reps, card)


if __name__ == "__main__":
    main()
