"""The fixed-shape multiclass detection filter and its `Detections`.

Port of cpm_tpu/modeling/roi_heads/box_head.py (`Detections`,
`filter_detections`), the part that the grid-cascade head runs. The filter,
per image: threshold the foreground class scores, gather the top
`pre_nms_candidates` candidates, then the reference's filter_results
(`ops/nms.py::filter_results`): label-aware hard NMS into
`detections_per_img` slots.
"""

from typing import NamedTuple

import torch

from benchmark.reference.modeling.roi_heads.targets import gather_rows
from benchmark.reference.ops.nms import filter_results, topk


class Detections(NamedTuple):
    boxes: torch.Tensor   # [B, D, 4] xyxy
    scores: torch.Tensor  # [B, D]
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
    **nms_kw,
) -> Detections:
    """boxes_per_class [B, K, C, 4]; scores [B, K, C] softmax probabilities
    (class 0 is background and skipped); prop_mask [B, K]. `nms_kw` are
    filter_results' options."""
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

    boxes, out_scores, labels, keep = filter_results(
        top_boxes, top_scores, top_labels, top_valid, score_thresh=score_thresh,
        nms_thresh=nms_thresh, detections_per_img=detections_per_img, **nms_kw)
    return Detections(boxes=boxes, scores=torch.where(keep, out_scores, 0.0), labels=labels,
                      mask=keep)
