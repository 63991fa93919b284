"""Soft-NMS and the detection filter under it, as the TTA merge runs them.

A frozen copy of cpm_tpu_torch/ops/nms.py's `soft_nms`, `ml_soft_nms` and
the part of `filter_results` that the merge takes under TEST.SOFT_NMS
(no box voting): plain PyTorch, float32 as given. The hard-NMS branch of
the filter is ops/nms.py's `filter_results`.

Soft-NMS takes `max_output` steps whatever the inputs: pick the highest
remaining score (the first of equal ones), then decay the scores of the
boxes that overlap it (linear, gaussian or hard).
"""

import torch

from benchmark.reference.ops import nms
from benchmark.reference.structures.boxes import box_iou


def soft_nms(boxes, scores, max_output: int, sigma: float = 0.5, overlap_thresh: float = 0.3,
             score_thresh: float = 0.001, method: str = "linear", mask=None,
             legacy_plus1: bool = False):
    """Soft-NMS over the last box axis of boxes [..., N, 4], scores and mask
    [..., N]. Returns (indices [..., max_output], their scores when picked,
    valid)."""
    if method not in ("linear", "gaussian", "hard"):
        raise ValueError(method)
    if mask is None:
        mask = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    neg_inf = torch.finfo(scores.dtype).min
    s = torch.where(mask, scores, torch.full_like(scores, neg_inf))
    iou = box_iou(boxes, boxes, legacy_plus1=legacy_plus1)  # [..., N, N]
    sigma_t = torch.tensor(sigma, dtype=iou.dtype, device=iou.device)
    row = (*s.shape[:-1], 1, s.shape[-1])
    picked, picked_scores, picked_ok = [], [], []
    for _ in range(max_output):
        i = torch.argmax(s, dim=-1, keepdim=True)
        si = torch.gather(s, -1, i)
        ok = si > score_thresh
        ov = torch.gather(iou, -2, i[..., None].expand(row)).squeeze(-2)
        if method == "linear":
            decay = torch.where(ov > overlap_thresh, 1.0 - ov, 1.0)
        elif method == "gaussian":
            decay = torch.exp(-(ov * ov) / sigma_t)
        else:
            decay = torch.where(ov > overlap_thresh, 0.0, 1.0)
        s_new = torch.where(s > neg_inf / 2, s * decay, s)
        s_new = s_new.scatter(-1, i, neg_inf)  # the picked box leaves the pool
        s = torch.where(ok, s_new, s)
        picked.append(i)
        picked_scores.append(si)
        picked_ok.append(ok)
    idx = torch.cat(picked, -1)
    out_scores = torch.cat(picked_scores, -1)
    valid = torch.cat(picked_ok, -1) & (out_scores > score_thresh)
    return idx, out_scores, valid


def ml_soft_nms(boxes, scores, labels, max_output: int, sigma: float = 0.5,
                overlap_thresh: float = 0.3, score_thresh: float = 0.001,
                method: str = "linear", mask=None, legacy_plus1: bool = False):
    """Label-aware soft-NMS by the coordinate-offset trick: boxes of
    different labels never decay each other."""
    if mask is None:
        mask = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    max_coord = torch.amax(torch.where(mask[..., None], boxes, 0.0), dim=(-2, -1),
                           keepdim=True) + 1.0
    shifted = boxes + labels.to(boxes.dtype)[..., None] * max_coord
    return soft_nms(shifted, scores, max_output, sigma, overlap_thresh, score_thresh,
                    method, mask, legacy_plus1)


def filter_results(boxes, scores, labels, mask, *, score_thresh, nms_thresh,
                   detections_per_img, use_soft_nms=False, soft_nms_sigma=0.5,
                   soft_nms_method="linear", use_box_voting=False, **unused):
    """The filter of one labelled set a row (core/test.py:433-509):
    boxes [..., N, 4], scores, labels and mask [..., N]. Soft-NMS (score
    floor 1e-4), or without TEST.SOFT_NMS ops/nms.py's label-aware hard
    NMS. Returns (boxes, scores, labels, valid) of detections_per_img; under
    soft-NMS the scores of invalid slots are left as the NMS returned them."""
    if use_box_voting:
        raise NotImplementedError("box voting: no configuration of the benchmark runs it")
    if not use_soft_nms:
        return nms.filter_results(boxes, scores, labels, mask, score_thresh=score_thresh,
                                  nms_thresh=nms_thresh, detections_per_img=detections_per_img)
    valid = mask & (scores > score_thresh)
    idx, out_scores, keep = ml_soft_nms(
        boxes, scores, labels, detections_per_img, sigma=soft_nms_sigma,
        overlap_thresh=nms_thresh, score_thresh=1e-4, method=soft_nms_method, mask=valid)
    out_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    out_labels = torch.gather(labels, -1, idx)
    return out_boxes, out_scores, out_labels, keep
