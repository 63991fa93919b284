"""Detections and the fixed-shape multiclass detection filter.

Port of cpm_tpu/modeling/roi_heads/box_head.py (`Detections` and the
hard-NMS path of `filter_detections`): per image, threshold the
foreground class scores, gather the top `pre_nms_candidates` candidates,
run label-aware NMS and keep `detections_per_img` slots.
"""

from typing import NamedTuple

import torch

from cpm_tpu_torch.modeling.roi_heads.targets import gather_rows
from cpm_tpu_torch.ops.nms import batched_nms, topk


class Detections(NamedTuple):
    boxes: torch.Tensor   # [B, D, 4] xyxy, float32
    scores: torch.Tensor  # [B, D] float32
    labels: torch.Tensor  # [B, D] int32, 1-based classes
    mask: torch.Tensor    # [B, D] bool


def filter_detections(
    boxes_per_class: torch.Tensor,
    scores: torch.Tensor,
    prop_mask: torch.Tensor,
    *,
    score_thresh: float,
    nms_thresh: float,
    detections_per_img: int,
    pre_nms_candidates: int = 1024,
) -> Detections:
    """boxes_per_class [B, K, C, 4]; scores [B, K, C] softmax probabilities
    (class 0 is background and skipped); prop_mask [B, K]."""
    B, K, C = scores.shape
    cand_scores = scores[:, :, 1:].reshape(B, K * (C - 1))
    cand_boxes = boxes_per_class[:, :, 1:, :].reshape(B, K * (C - 1), 4)
    cand_labels = torch.arange(1, C, dtype=torch.int32, device=scores.device)
    cand_labels = cand_labels.expand(B, K, C - 1).reshape(B, K * (C - 1))
    cand_valid = (cand_scores > score_thresh) & prop_mask.repeat_interleave(C - 1, dim=1)

    M = min(pre_nms_candidates, cand_scores.shape[1])
    masked = torch.where(cand_valid, cand_scores, torch.finfo(cand_scores.dtype).min)
    top_scores, top_idx = topk(masked, M)
    top_boxes = gather_rows(cand_boxes, top_idx)
    top_labels = torch.gather(cand_labels, 1, top_idx)
    top_valid = torch.gather(cand_valid, 1, top_idx)
    top_scores = torch.where(top_valid, top_scores, 0.0)

    idx, keep = batched_nms(
        top_boxes, top_scores, top_labels, nms_thresh, detections_per_img, mask=top_valid
    )
    ds = torch.gather(top_scores, 1, idx)
    return Detections(
        boxes=gather_rows(top_boxes, idx),
        scores=torch.where(keep, ds, 0.0),
        labels=torch.gather(top_labels, 1, idx),
        mask=keep,
    )
