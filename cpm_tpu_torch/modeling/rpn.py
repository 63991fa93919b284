"""Region Proposal Network: anchors, head and test-time proposal selection.

Port of cpm_tpu/modeling/rpn.py (`generate_cell_anchors`, `grid_anchors`,
`AnchorLayout`, `RPNHead`, and the test branch of `select_proposals`).
Anchors use Detectron's rounding and are laid out in (h, w, a) order to
match the NHWC flattening of the head outputs. Pre-NMS selection is an
exact top-k (index-ordered on ties, as `lax.top_k`); NMS is the fixed-point
kernel of ops/nms.py.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.ops.box_coder import BoxCoder
from cpm_tpu_torch.ops.nms import nms, topk
from cpm_tpu_torch.structures.boxes import clip_boxes_to_image, remove_small_boxes_mask


def generate_cell_anchors(
    stride: int = 16,
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """[A, 4] xyxy anchors centered on the (0, 0) cell, Detectron rounding."""
    scales = np.array(sizes, dtype=np.float64) / stride
    ratios = np.array(aspect_ratios, dtype=np.float64)
    anchor = np.array([1, 1, stride, stride], dtype=np.float64) - 1

    def whctrs(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mkanchors(ws, hs, x_ctr, y_ctr):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack((
            x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1),
        ))

    w, h, x_ctr, y_ctr = whctrs(anchor)
    size_ratios = (w * h) / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = mkanchors(ws, hs, x_ctr, y_ctr)
    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, x_ctr, y_ctr = whctrs(ratio_anchors[i])
        out.append(mkanchors(w * scales, h * scales, x_ctr, y_ctr))
    return np.vstack(out).astype(np.float32)


def grid_anchors(cell_anchors: np.ndarray, feat_h: int, feat_w: int, stride: int) -> np.ndarray:
    """[H*W*A, 4] anchors for one level in (h, w, a) order."""
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    return (shifts[:, None, :] + cell_anchors[None, :, :]).reshape(-1, 4)


class AnchorLayout:
    """Per-level anchor sets for one set of feature shapes; `per_level`
    holds numpy arrays, `on(device)` the same as tensors."""

    def __init__(
        self,
        feat_shapes: Sequence[Tuple[int, int]],
        strides: Sequence[int],
        sizes: Sequence[float],
        aspect_ratios: Sequence[float],
    ):
        if len(strides) == 1:
            cell = [generate_cell_anchors(strides[0], sizes, aspect_ratios)]
        else:
            if len(strides) != len(sizes):
                raise ValueError("FPN needs one anchor size per stride")
            cell = [
                generate_cell_anchors(
                    s, sz if isinstance(sz, (tuple, list)) else (sz,), aspect_ratios
                )
                for s, sz in zip(strides, sizes)
            ]
        self.per_level = [
            grid_anchors(c, h, w, s) for c, (h, w), s in zip(cell, feat_shapes, strides)
        ]
        self.level_sizes = [a.shape[0] for a in self.per_level]
        self._tensors = {}

    def on(self, device) -> List[torch.Tensor]:
        device = torch.device(device)
        if device not in self._tensors:
            self._tensors[device] = [torch.from_numpy(a).to(device) for a in self.per_level]
        return self._tensors[device]


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness and box heads, applied per level."""

    def __init__(self, in_channels: int, num_anchors: int, generator: torch.Generator = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)
        for m in (self.conv, self.cls_logits, self.bbox_pred):
            init.normal_(m.weight, 0.01, generator)
            nn.init.zeros_(m.bias)

    def forward(self, features: Sequence[torch.Tensor]):
        """NCHW levels -> per-level NHWC ([B, H, W, A], [B, H, W, 4A])."""
        logits, bbox_reg = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1))
            bbox_reg.append(self.bbox_pred(t).permute(0, 2, 3, 1))
        return logits, bbox_reg


def select_proposals(
    layout: AnchorLayout,
    objectness: Sequence[torch.Tensor],
    box_regression: Sequence[torch.Tensor],
    image_sizes: torch.Tensor,
    *,
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    min_size: float,
    fpn_post_nms_top_n: int,
    box_coder: BoxCoder = None,
):
    """Test-time fixed-shape proposal selection.

    Args:
      objectness / box_regression: per-level NHWC head outputs.
      image_sizes: [B, 2] true (h, w).

    Returns (proposals [B, K, 4], scores [B, K], mask [B, K]) with
    K = min(fpn_post_nms_top_n, levels x post_nms_top_n).
    """
    if box_coder is None:
        box_coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
    dev = objectness[0].device
    img_w = image_sizes[:, None, 1].float()
    img_h = image_sizes[:, None, 0].float()
    anchors_per_level = layout.on(dev)

    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for obj, reg, anchors in zip(objectness, box_regression, anchors_per_level):
        B, H, W, A = obj.shape
        # box decode and NMS IoU in f32 (bf16 coordinates quantize to ~8 px)
        scores = torch.sigmoid(obj.float().reshape(B, H * W * A))
        deltas = reg.float().reshape(B, H * W * A, 4)
        k = min(pre_nms_top_n, scores.shape[1])
        top_scores, top_idx = topk(scores, k)
        top_anchors = anchors[top_idx]  # [B, k, 4]
        top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(B, k, 4))
        proposals = box_coder.decode(top_deltas, top_anchors)
        proposals = clip_boxes_to_image(proposals, (img_w, img_h))
        valid = remove_small_boxes_mask(proposals, min_size)
        idx, keep = nms(proposals, top_scores, nms_thresh, post_nms_top_n, mask=valid)
        lvl_boxes.append(torch.gather(proposals, 1, idx[..., None].expand(*idx.shape, 4)))
        lvl_scores.append(torch.gather(top_scores, 1, idx))
        lvl_valid.append(keep)

    boxes = torch.cat(lvl_boxes, dim=1)
    scores = torch.cat(lvl_scores, dim=1)
    valid = torch.cat(lvl_valid, dim=1)
    if len(objectness) > 1:
        masked = torch.where(valid, scores, torch.finfo(scores.dtype).min)
        k = min(fpn_post_nms_top_n, masked.shape[1])
        _, top_idx = topk(masked, k)
        boxes = torch.gather(boxes, 1, top_idx[..., None].expand(*top_idx.shape, 4))
        valid = torch.gather(valid, 1, top_idx)
        scores = torch.gather(scores, 1, top_idx)
    return boxes, scores, valid
