"""Box-proposal average recall (the RPN_ONLY evaluation).

The port's own copy of cpm_tpu/evaluation/proposal_eval.py (after the
reference's evaluate_box_proposals): for each image take the top-k proposals
by objectness, match them greedily to the ground truth by IoU, and report
the recall averaged over IoU thresholds 0.5:0.05:0.95, for an area range and
a proposal limit. numpy only.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

AREA_RANGES = {
    "all": (0**2, 1e5**2),
    "small": (0**2, 32**2),
    "medium": (32**2, 96**2),
    "large": (96**2, 1e5**2),
}


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes, with the +1 pixel convention."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def evaluate_box_proposals(
    proposals_per_image: List[Dict],
    area: str = "all",
    limit: int = 1000,
    thresholds: Optional[Sequence[float]] = None,
) -> Dict:
    """proposals_per_image: dicts of 'boxes' [N, 4] xyxy, 'scores' [N]
    objectness and 'gt_boxes' [M, 4] xyxy, in one coordinate frame.

    Returns {'ar', 'recalls', 'thresholds', 'num_pos'}."""
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    thresholds = np.asarray(thresholds)
    lo, hi = AREA_RANGES[area]

    gt_overlaps = []
    num_pos = 0
    for rec in proposals_per_image:
        boxes = np.asarray(rec["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(rec["scores"], np.float64).reshape(-1)
        gt = np.asarray(rec["gt_boxes"], np.float64).reshape(-1, 4)

        boxes = boxes[np.argsort(-scores)][:limit]
        gt_areas = (gt[:, 2] - gt[:, 0] + 1) * (gt[:, 3] - gt[:, 1] + 1)
        gt = gt[(gt_areas >= lo) & (gt_areas <= hi)]
        num_pos += len(gt)
        if len(gt) == 0 or len(boxes) == 0:
            continue

        overlaps = _iou_xyxy(boxes, gt)
        covered = np.zeros(len(gt))
        for _ in range(min(len(boxes), len(gt))):
            # the gt best covered by any box takes that box
            max_overlaps = overlaps.max(axis=0)
            gt_ind = max_overlaps.argmax()
            if max_overlaps[gt_ind] < 0:
                break
            box_ind = overlaps[:, gt_ind].argmax()
            covered[gt_ind] = overlaps[box_ind, gt_ind]
            overlaps[box_ind, :] = -1
            overlaps[:, gt_ind] = -1
        gt_overlaps.append(covered)

    if num_pos == 0:
        return dict(ar=0.0, recalls=np.zeros_like(thresholds), thresholds=thresholds, num_pos=0)
    gt_overlaps = np.sort(np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0))
    recalls = np.array([(gt_overlaps >= t).sum() / float(num_pos) for t in thresholds])
    return dict(ar=float(recalls.mean()), recalls=recalls, thresholds=thresholds, num_pos=num_pos)
