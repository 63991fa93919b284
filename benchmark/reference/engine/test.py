"""The TTA passes and merge of the eval loop.

A frozen copy of cpm_tpu_torch/engine/test.py's `tta_passes`,
`_unflip_boxes` and `merge_tta_detections`, with the mapping of one pass's
detections to the original image that its `run_inference_on_dataset`
makes (`to_original`): plain PyTorch, float32, the filter of
ops/soft_nms.py.
"""

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.ops.soft_nms import filter_results


def tta_passes(cfg) -> List[dict]:
    """The eval passes (core/test.py:34-48): the base pass, then with
    TEST.BBOX_AUG its flip, then each scale and its flip."""
    passes = [dict(scale=None, max_size=None, hflip=False)]
    aug = cfg.TEST.BBOX_AUG
    if aug.ENABLED:
        if aug.H_FLIP:
            passes.append(dict(scale=None, max_size=None, hflip=True))
        for s in aug.SCALES:
            passes.append(dict(scale=s, max_size=aug.MAX_SIZE, hflip=False))
            if aug.H_FLIP:
                passes.append(dict(scale=s, max_size=aug.MAX_SIZE, hflip=True))
    return passes


def _unflip_boxes(boxes: torch.Tensor, resized_w: torch.Tensor) -> torch.Tensor:
    """Boxes [B, K, 4] of h-flipped images of widths resized_w [B] mapped
    back (BoxList.transpose, TO_REMOVE = 1)."""
    w = resized_w[:, None]
    x1 = w - boxes[..., 2] - 1
    x2 = w - boxes[..., 0] - 1
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)


def to_original(dets: Dict[str, torch.Tensor], hflip: bool, image_sizes, scale_hw):
    """One pass's detections of one image (fields [1, K, ...], boxes in the
    pass's resized frame) in the original image's frame: unflipped at the
    resized width `image_sizes[:, 1]`, then divided by its scale
    (`scale_hw` = (h, w), the loader's)."""
    boxes = dets["boxes"].float()
    device = boxes.device
    if hflip:
        boxes = _unflip_boxes(boxes, torch.as_tensor(np.asarray(image_sizes)[:, 1],
                                                     device=device))
    scale = torch.as_tensor(np.array([[scale_hw[1], scale_hw[0]] * 2], np.float32), device=device)
    return dict(dets, boxes=boxes / scale[:, None, :], scores=dets["scores"].float())


def detection_filter_kwargs(cfg) -> dict:
    """FAST_RCNN's thresholds and TEST's soft-NMS and box voting."""
    f, t = cfg.FAST_RCNN, cfg.TEST
    return dict(score_thresh=f.SCORE_THRESH, nms_thresh=f.NMS,
                detections_per_img=f.DETECTIONS_PER_IMG, use_soft_nms=t.SOFT_NMS.ENABLED,
                soft_nms_sigma=t.SOFT_NMS.SIGMA, soft_nms_method=t.SOFT_NMS.METHOD,
                use_box_voting=t.BBOX_VOTE.ENABLED)


def merge_tta_detections(cfg, per_pass_dets: List[Dict[str, torch.Tensor]]):
    """Concatenate the passes' detections (fields [..., K] in one frame)
    and filter them once (core/test.py:46-48)."""
    cat = {f: torch.cat([d[f] for d in per_pass_dets], dim=-1 if f != "boxes" else -2)
           for f in ("boxes", "scores", "labels", "mask")}
    boxes, scores, labels, keep = filter_results(
        cat["boxes"], cat["scores"], cat["labels"], cat["mask"], **detection_filter_kwargs(cfg))
    return dict(boxes=boxes, scores=scores, labels=labels, mask=keep)
