"""Box ops on padded `[..., N, 4]` xyxy tensors.

Port of cpm_tpu/structures/boxes.py, keeping the reference's
integer-coordinate convention (`legacy_plus1`, TO_REMOVE = 1). `Boxes` is a
plain container of tensors: padded boxes, their validity mask, and named
per-box fields.
"""

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class Boxes:
    """A padded, masked set of boxes plus named extra fields.

    boxes: [..., N, 4] xyxy; mask: [..., N] bool (False = padding slot);
    fields: extra per-box tensors (scores, labels, ...), each [..., N, ...].
    """

    boxes: torch.Tensor
    mask: torch.Tensor
    fields: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def num_slots(self) -> int:
        return self.boxes.shape[-2]

    def num_valid(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)

    def with_fields(self, **kw) -> "Boxes":
        return dataclasses.replace(self, fields={**self.fields, **kw})

    def field(self, name: str) -> torch.Tensor:
        return self.fields[name]

    @classmethod
    def empty(cls, n: int, batch_shape=(), dtype=torch.float32, device="cuda") -> "Boxes":
        shape = tuple(batch_shape) + (n,)
        return cls(boxes=torch.zeros(shape + (4,), dtype=dtype, device=device),
                   mask=torch.zeros(shape, dtype=torch.bool, device=device))


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


def nonempty_boxes_mask(boxes: torch.Tensor) -> torch.Tensor:
    """Mask of boxes with x2 > x1 and y2 > y1."""
    return (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])


def flip_boxes_horizontal(boxes: torch.Tensor, image_width, legacy_plus1: bool = True):
    """Horizontal flip in xyxy: x1' = W - x2 - TO_REMOVE, x2' = W - x1 - TO_REMOVE."""
    off = 1.0 if legacy_plus1 else 0.0
    x1 = image_width - boxes[..., 2] - off
    x2 = image_width - boxes[..., 0] - off
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)


def resize_boxes(boxes: torch.Tensor, scale_xy) -> torch.Tensor:
    """Scale boxes by per-axis ratios (sx, sy): numbers, or tensors
    broadcastable over the leading box dims."""
    sx, sy = (torch.as_tensor(v, dtype=boxes.dtype, device=boxes.device) for v in scale_xy)
    sx, sy = torch.broadcast_tensors(sx, sy)
    return boxes * torch.stack([sx, sy, sx, sy], dim=-1)


def convert_xywh_to_xyxy(boxes: torch.Tensor, legacy_plus1: bool = True) -> torch.Tensor:
    """COCO xywh -> xyxy: x2 = x + max(w - TO_REMOVE, 0)."""
    off = 1.0 if legacy_plus1 else 0.0
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + (w - off).clamp(min=0.0), y + (h - off).clamp(min=0.0)], dim=-1)


def convert_xyxy_to_xywh(boxes: torch.Tensor, legacy_plus1: bool = True) -> torch.Tensor:
    """xyxy -> COCO xywh: w = x2 - x1 + TO_REMOVE."""
    off = 1.0 if legacy_plus1 else 0.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1 + off, y2 - y1 + off], dim=-1)


def pad_boxes_to(boxes: torch.Tensor, n: int, mask: Optional[torch.Tensor] = None):
    """Pad with zero boxes, or truncate, a [M, 4] box tensor to [n, 4], with
    its mask [n] (False on the padding)."""
    m = boxes.shape[0]
    if mask is None:
        mask = torch.ones(m, dtype=torch.bool, device=boxes.device)
    if m >= n:
        return boxes[:n], mask[:n]
    return (torch.cat([boxes, boxes.new_zeros(n - m, 4)]),
            torch.cat([mask, mask.new_zeros(n - m)]))


def concat_boxes(a: Boxes, b: Boxes) -> Boxes:
    """Two padded box sets joined along the slot axis; the fields that both
    hold are joined too, the others dropped."""
    axis = a.mask.dim() - 1
    return Boxes(
        boxes=torch.cat([a.boxes, b.boxes], dim=-2),
        mask=torch.cat([a.mask, b.mask], dim=-1),
        fields={k: torch.cat([a.fields[k], b.fields[k]], dim=axis)
                for k in a.fields if k in b.fields},
    )
