"""Fixed-shape hard NMS.

Port of cpm_tpu/ops/nms.py (`nms`, `batched_nms`, `multiclass_nms`) and of
the detection filter (`filter_results`). Every function takes padded
`[..., N]` inputs with a validity mask and returns a fixed number of output
slots with a validity mask; leading dims are a batch.

The keep mask is the JAX package's fixed point: keep[i] is recomputed as
"no kept, higher-scored box overlaps me" until it stops changing, which is
exactly sequential greedy NMS. The JAX `while_loop` becomes a Python loop
whose convergence test reads one flag from the device per iteration; the
iteration count is the longest suppression chain.

IoU convention: standard (x2-x1)*(y2-y1) with no +1 (`legacy_plus1=False`),
as the reference's NMS kernels use.
"""

import torch

from benchmark.reference.structures.boxes import box_iou


def topk(x: torch.Tensor, k: int):
    """Exact top-k along the last dim; equal values keep index order, as
    `lax.top_k` orders them (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sorted_keep_mask(iou: torch.Tensor, valid: torch.Tensor, thresh: float):
    """Greedy-NMS keep mask for boxes sorted by descending score.

    iou: [..., N, N]; valid: [..., N] bool. Returns keep [..., N] bool.
    """
    n = iou.shape[-1]
    row = torch.arange(n, device=iou.device)
    earlier = row[:, None] < row[None, :]  # j before i (higher score)
    over = (iou > thresh) & earlier & valid[..., :, None] & valid[..., None, :]
    keep = valid
    while True:
        new_keep = ~torch.any(over & keep[..., :, None], dim=-2) & valid
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """Class-agnostic hard NMS over the last box axis.

    Args:
      boxes: [..., N, 4] xyxy; scores: [..., N]; mask: [..., N] validity.
      max_output: number of output slots.

    Returns (indices [..., max_output] int64 into the inputs, keep
    [..., max_output] bool). Kept boxes come in descending score order;
    empty slots hold index 0 and keep False.
    """
    return greedy_nms(boxes, scores, iou_threshold, max_output, mask,
                      lambda a, b: box_iou(a, b, legacy_plus1=legacy_plus1))


def greedy_nms(boxes, scores, iou_threshold: float, max_output: int, mask, pairwise_iou):
    """`nms` over boxes [..., N, D] of any parametrisation, with
    `pairwise_iou(a, b)` -> [..., N, M] (ops/rotated.py runs it on rotated
    boxes and quadrilaterals)."""
    if mask is None:
        mask = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    neg_inf = torch.finfo(scores.dtype).min
    s = torch.where(mask, scores, torch.full_like(scores, neg_inf))
    order = torch.argsort(-s, dim=-1, stable=True)
    b_sorted = torch.gather(boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    valid_sorted = torch.gather(mask, -1, order)
    keep_sorted = _sorted_keep_mask(pairwise_iou(b_sorted, b_sorted), valid_sorted, iou_threshold)

    # compact kept entries to the front; slot max_output collects overflow
    kept_rank = torch.cumsum(keep_sorted.long(), dim=-1) - 1
    slot = torch.where(keep_sorted & (kept_rank < max_output), kept_rank, max_output)
    lead = order.shape[:-1]
    out_idx = torch.zeros(*lead, max_output + 1, dtype=torch.long, device=order.device)
    out_valid = torch.zeros(*lead, max_output + 1, dtype=torch.bool, device=order.device)
    out_idx.scatter_(-1, slot, order)
    out_valid.scatter_(-1, slot, keep_sorted)
    return out_idx[..., :max_output], out_valid[..., :max_output]


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """Category-aware NMS by the coordinate-offset trick: boxes of
    different `idxs` never suppress each other."""
    max_coord = torch.amax(boxes, dim=(-2, -1), keepdim=True) + 1.0  # [..., 1, 1]
    shifted = boxes + idxs.to(boxes.dtype)[..., None] * max_coord
    return nms(shifted, scores, iou_threshold, max_output, mask, legacy_plus1)


def multiclass_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    mask: torch.Tensor = None,
    legacy_plus1: bool = False,
):
    """ml_nms equivalent: label-aware hard NMS."""
    return batched_nms(
        boxes, scores, labels, iou_threshold, max_output, mask, legacy_plus1
    )


def filter_results(boxes, scores, labels, mask, *, score_thresh, nms_thresh, detections_per_img):
    """The reference's filter_results (core/test.py:433-509) over one
    labelled set a row, as the configurations run it (no soft-NMS, no box
    voting): boxes [..., N, 4], scores, labels (1..C-1) and mask [..., N].
    Label-aware hard NMS. Returns (boxes, scores, labels, valid) of
    detections_per_img."""
    valid = mask & (scores > score_thresh)
    idx, keep = multiclass_nms(boxes, scores, labels, nms_thresh, detections_per_img, mask=valid)
    out_scores = torch.where(keep, torch.gather(scores, -1, idx), 0.0)
    out_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    out_labels = torch.gather(labels, -1, idx)
    return out_boxes, out_scores, out_labels, keep
