"""Detectron-style box encode/decode with the reference's numerics.

Port of cpm_tpu/ops/box_coder.py: widths and heights use TO_REMOVE = 1,
decode subtracts 1 from x2/y2 (the reference's "-1 is correct" quirk), and
dw/dh are clamped at log(1000/16).
"""

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)


class BoxCoder:
    def __init__(self, weights, bbox_xform_clip: float = BBOX_XFORM_CLIP):
        self.weights = tuple(float(w) for w in weights)
        self.bbox_xform_clip = bbox_xform_clip

    def encode(self, reference_boxes: torch.Tensor, proposals: torch.Tensor):
        """Regression targets mapping proposals -> reference boxes, both
        [..., N, 4] -> [..., N, 4]."""
        ex_w = proposals[..., 2] - proposals[..., 0] + 1.0
        ex_h = proposals[..., 3] - proposals[..., 1] + 1.0
        ex_cx = proposals[..., 0] + 0.5 * ex_w
        ex_cy = proposals[..., 1] + 0.5 * ex_h
        gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + 1.0
        gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + 1.0
        gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
        gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
        # keep the denominators of degenerate (padding) boxes finite
        ex_w, ex_h = torch.clamp(ex_w, min=1e-6), torch.clamp(ex_h, min=1e-6)
        gt_w, gt_h = torch.clamp(gt_w, min=1e-6), torch.clamp(gt_h, min=1e-6)
        wx, wy, ww, wh = self.weights
        return torch.stack(
            [
                wx * (gt_cx - ex_cx) / ex_w,
                wy * (gt_cy - ex_cy) / ex_h,
                ww * torch.log(gt_w / ex_w),
                wh * torch.log(gt_h / ex_h),
            ],
            dim=-1,
        )

    def decode(self, rel_codes: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Apply deltas [..., N, 4K] to boxes [..., N, 4] -> [..., N, 4K]."""
        boxes = boxes.to(rel_codes.dtype)
        widths = boxes[..., 2] - boxes[..., 0] + 1.0
        heights = boxes[..., 3] - boxes[..., 1] + 1.0
        ctr_x = boxes[..., 0] + 0.5 * widths
        ctr_y = boxes[..., 1] + 0.5 * heights

        wx, wy, ww, wh = self.weights
        dx = rel_codes[..., 0::4] / wx
        dy = rel_codes[..., 1::4] / wy
        dw = torch.clamp(rel_codes[..., 2::4] / ww, max=self.bbox_xform_clip)
        dh = torch.clamp(rel_codes[..., 3::4] / wh, max=self.bbox_xform_clip)

        pred_cx = dx * widths[..., None] + ctr_x[..., None]
        pred_cy = dy * heights[..., None] + ctr_y[..., None]
        pred_w = torch.exp(dw) * widths[..., None]
        pred_h = torch.exp(dh) * heights[..., None]
        out = torch.stack(
            [
                pred_cx - 0.5 * pred_w,
                pred_cy - 0.5 * pred_h,
                pred_cx + 0.5 * pred_w - 1.0,  # -1 matches the reference decode
                pred_cy + 0.5 * pred_h - 1.0,
            ],
            dim=-1,
        )  # [..., N, K, 4]
        return out.reshape(rel_codes.shape)
