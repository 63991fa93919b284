"""Box ops on padded `[..., N, 4]` xyxy tensors.

Port of cpm_tpu/structures/boxes.py (`box_area`, `box_iou`,
`clip_boxes_to_image`, `remove_small_boxes_mask`), keeping the reference's
integer-coordinate convention (`legacy_plus1`, TO_REMOVE = 1).
"""

import torch


def box_area(boxes: torch.Tensor, legacy_plus1: bool = True) -> torch.Tensor:
    """Area of xyxy boxes [..., 4] -> [...]."""
    off = 1.0 if legacy_plus1 else 0.0
    w = boxes[..., 2] - boxes[..., 0] + off
    h = boxes[..., 3] - boxes[..., 1] + off
    return w * h


def box_iou(
    boxes1: torch.Tensor, boxes2: torch.Tensor, legacy_plus1: bool = True
) -> torch.Tensor:
    """Pairwise IoU of [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    off = 1.0 if legacy_plus1 else 0.0
    area1 = box_area(boxes1, legacy_plus1)
    area2 = box_area(boxes2, legacy_plus1)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    denom = area1[..., :, None] + area2[..., None, :] - inter
    return inter / torch.clamp(denom, min=torch.finfo(inter.dtype).tiny)


def clip_boxes_to_image(boxes: torch.Tensor, image_size, legacy_plus1: bool = True):
    """Clip xyxy boxes to [0, W-1] x [0, H-1].

    image_size is (w, h): numbers or tensors broadcastable over the
    leading box dims.
    """
    w, h = image_size
    off = 1.0 if legacy_plus1 else 0.0

    def clip(v, hi):
        v = torch.clamp(v, min=0.0)
        if isinstance(hi, torch.Tensor):
            return torch.minimum(v, hi.to(v.dtype) - off)
        return torch.clamp(v, max=hi - off)

    return torch.stack(
        [
            clip(boxes[..., 0], w),
            clip(boxes[..., 1], h),
            clip(boxes[..., 2], w),
            clip(boxes[..., 3], h),
        ],
        dim=-1,
    )


def remove_small_boxes_mask(
    boxes: torch.Tensor, min_size: float, legacy_plus1: bool = True
) -> torch.Tensor:
    """Mask of boxes with both sides >= min_size."""
    off = 1.0 if legacy_plus1 else 0.0
    w = boxes[..., 2] - boxes[..., 0] + off
    h = boxes[..., 3] - boxes[..., 1] + off
    return (w >= min_size) & (h >= min_size)
