"""RoI target assignment and roi-set helpers: match -> label -> sample ->
compact.

Port of cpm_tpu/modeling/roi_heads/targets.py (`SampledRois`,
`compact_by_mask`, `assign_targets`, `subsample_rois`,
`rois_with_batch_index`), with the same slot ordering, and `gather_rows`,
the `take_along_axis` of a per-image roi set. Proposals are matched to gt
at (fg, bg) IoU thresholds without low-quality recovery, labelled
background / ignored, balanced-sampled, and the sampled ones compacted to a
fixed [B, S] set with a validity mask.
"""

from typing import NamedTuple

import torch

from cpm_tpu_torch.ops.box_coder import BoxCoder
from cpm_tpu_torch.structures.boxes import box_iou
from cpm_tpu_torch.utils.matcher import (
    BELOW_LOW_THRESHOLD,
    BETWEEN_THRESHOLDS,
    match_boxes,
)
from cpm_tpu_torch.utils.sampler import balanced_sample


class SampledRois(NamedTuple):
    """A fixed-size per-image set of training rois."""

    boxes: torch.Tensor        # [B, S, 4]
    mask: torch.Tensor         # [B, S] sampled-slot validity
    labels: torch.Tensor       # [B, S] int32; 0 = background, -1 = unsampled
    reg_targets: torch.Tensor  # [B, S, 4] box-coder deltas to the matched gt
    matched_gt: torch.Tensor   # [B, S, 4] matched gt box (for grid targets)
    matched_iou: torch.Tensor  # [B, S] IoU with the matched gt (for ISM targets)
    is_pos: torch.Tensor       # [B, S] bool


def compact_by_mask(select: torch.Tensor, out_size: int):
    """Indices that move `select`-True slots to the front, truncated to
    out_size, and their validity. Stable: selected slots keep their order.

    Returns (idx [..., out_size] int64, valid [..., out_size] bool).
    """
    order = torch.argsort((~select).to(torch.uint8), dim=-1, stable=True)
    idx = order[..., :out_size]
    valid = torch.gather(select, -1, order)[..., :out_size]
    return idx, valid


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] indexed along dim 1 by idx [B, M] -> [B, M, ...]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(*idx.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


def rois_with_batch_index(boxes: torch.Tensor) -> torch.Tensor:
    """[B, S, 4] -> [B*S, 5] (batch_idx, x1, y1, x2, y2) for the pooler."""
    B, S = boxes.shape[:2]
    bidx = torch.arange(B, dtype=boxes.dtype, device=boxes.device)
    bidx = bidx[:, None].expand(B, S).reshape(-1, 1)
    return torch.cat([bidx, boxes.reshape(B * S, 4)], dim=1)


def match_to_gt(boxes, gt_boxes, gt_mask, fg_iou_threshold, bg_iou_threshold):
    """(matches [B, K] with sentinels, matched gt boxes [B, K, 4], best IoU
    with a real gt [B, K], quality [B, M, K]) at the given thresholds,
    without low-quality recovery."""
    quality = box_iou(gt_boxes, boxes)
    matches = match_boxes(quality, gt_mask, fg_iou_threshold, bg_iou_threshold)
    matched_gt = gather_rows(gt_boxes, torch.clamp(matches, min=0).long())
    matched_iou = torch.amax(
        torch.where(gt_mask[:, :, None], quality, quality.new_zeros(())), dim=1
    )
    return matches, matched_gt, matched_iou


def assign_targets(
    proposals: torch.Tensor,
    prop_mask: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    *,
    fg_iou_threshold: float,
    bg_iou_threshold: float,
    box_coder: BoxCoder,
):
    """Per-proposal labels, regression targets and matched gt: a dict of
    [B, K] / [B, K, 4] tensors; label -1 marks ignored (between thresholds)
    and invalid proposal slots."""
    matches, matched_gt, matched_iou = match_to_gt(
        proposals, gt_boxes, gt_mask, fg_iou_threshold, bg_iou_threshold
    )
    matched_iou = torch.where(prop_mask, matched_iou, matched_iou.new_zeros(()))
    labels = torch.gather(gt_labels, 1, torch.clamp(matches, min=0).long()).to(torch.int32)
    labels = torch.where(matches == BELOW_LOW_THRESHOLD, 0, labels)
    labels = torch.where(matches == BETWEEN_THRESHOLDS, -1, labels)
    labels = torch.where(prop_mask, labels, -1)
    return dict(
        labels=labels,
        reg_targets=box_coder.encode(matched_gt, proposals),
        matched_gt=matched_gt,
        matched_iou=matched_iou,
    )


def subsample_rois(
    proposals: torch.Tensor,
    prop_mask: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    noise_pos: torch.Tensor,
    noise_neg: torch.Tensor,
    *,
    batch_size_per_image: int,
    positive_fraction: float,
    fg_iou_threshold: float,
    bg_iou_threshold: float,
    box_coder: BoxCoder,
) -> SampledRois:
    """Balanced-sample a fixed [B, S] roi set; noise_pos / noise_neg are
    [B, K] uniform draws for the sampler."""
    t = assign_targets(
        proposals, prop_mask, gt_boxes, gt_labels, gt_mask,
        fg_iou_threshold=fg_iou_threshold, bg_iou_threshold=bg_iou_threshold,
        box_coder=box_coder,
    )
    labels = t["labels"]
    sel_pos, sel_neg = balanced_sample(
        labels > 0, labels == 0, batch_size_per_image, positive_fraction,
        noise_pos, noise_neg,
    )
    idx, valid = compact_by_mask(sel_pos | sel_neg, batch_size_per_image)
    return SampledRois(
        boxes=gather_rows(proposals, idx),
        mask=valid,
        labels=torch.where(valid, torch.gather(labels, 1, idx), -1),
        reg_targets=gather_rows(t["reg_targets"], idx),
        matched_gt=gather_rows(t["matched_gt"], idx),
        matched_iou=torch.gather(t["matched_iou"], 1, idx),
        is_pos=torch.gather(sel_pos, 1, idx) & valid,
    )
