"""Grid R-CNN heatmap targets and decode.

Port of cpm_tpu/modeling/roi_heads/grid_ops.py (`calc_sub_regions`,
`_point_factors`, `expand_boxes`, `grid_targets`, `grid_decode`). Targets:
per grid point, a disc of radius POS_RADIUS around the gt point's position
in the mapping-ratio expansion of the box, cropped to the point's
sub-region. Decode: per grid point, the argmax of its sub-region heatmap,
mapped back through the expansion, then confidence-weighted border voting
and a clamp of the refined box into the image.
"""

from typing import List, Tuple

import numpy as np
import torch


def calc_sub_regions(grid_points: int, grid_size: int, whole_map_size: int
                     ) -> List[Tuple[int, int, int, int]]:
    """Per-point (x1, y1, x2, y2) crops of the whole heatmap."""
    half_size = whole_map_size // 4 * 2
    sub_regions = []
    for i in range(grid_points):
        x_idx = i // grid_size
        y_idx = i % grid_size
        if x_idx == 0:
            sub_x1 = 0
        elif x_idx == grid_size - 1:
            sub_x1 = half_size
        else:
            sub_x1 = max(int((x_idx / (grid_size - 1) - 0.25) * whole_map_size), 0)
        if y_idx == 0:
            sub_y1 = 0
        elif y_idx == grid_size - 1:
            sub_y1 = half_size
        else:
            sub_y1 = max(int((y_idx / (grid_size - 1) - 0.25) * whole_map_size), 0)
        sub_regions.append((sub_x1, sub_y1, sub_x1 + half_size, sub_y1 + half_size))
    return sub_regions


def _point_factors(grid_points: int, grid_size: int) -> np.ndarray:
    """[P, 2] (factor_x, factor_y) interpolation factors."""
    f = np.zeros((grid_points, 2), np.float32)
    for j in range(grid_points):
        f[j, 0] = 1 - (j // grid_size) / (grid_size - 1)
        f[j, 1] = 1 - (j % grid_size) / (grid_size - 1)
    return f


def expand_boxes(boxes: torch.Tensor, mapping_ratio: float) -> torch.Tensor:
    """CMM expansion: each side grows by mapping_ratio * half-extent."""
    w2 = (boxes[..., 2] - boxes[..., 0]) * 0.5
    h2 = (boxes[..., 3] - boxes[..., 1]) * 0.5
    return torch.stack([
        boxes[..., 0] - mapping_ratio * w2,
        boxes[..., 1] - mapping_ratio * h2,
        boxes[..., 2] + mapping_ratio * w2,
        boxes[..., 3] + mapping_ratio * h2,
    ], dim=-1)


def grid_targets(
    pos_bboxes: torch.Tensor,
    pos_gt_bboxes: torch.Tensor,
    valid: torch.Tensor,
    *,
    mapping_ratio: float = 1.0,
    grid_points: int = 9,
    roi_feat_size: int = 14,
    pos_radius: int = 1,
    target_refine: bool = False,
) -> torch.Tensor:
    """Heatmap targets [N, P, half, half] float32 (half = 2 * roi_feat_size)
    for proposals [N, 4] (before expansion) and their matched gt [N, 4];
    invalid rois and rois whose expanded size does not exceed the grid get
    all-zero targets. target_refine: a grid point whose centre falls outside
    the whole map also marks the centre clamped into the map."""
    grid_size = int(np.sqrt(grid_points))
    whole = roi_feat_size * 4
    half = whole // 4 * 2
    dev = pos_bboxes.device
    subs = torch.tensor(calc_sub_regions(grid_points, grid_size, whole), dtype=torch.int32, device=dev)
    factors = torch.from_numpy(_point_factors(grid_points, grid_size)).to(dev)

    exp = expand_boxes(pos_bboxes, mapping_ratio)
    ws = exp[:, 2] - exp[:, 0]
    hs = exp[:, 3] - exp[:, 1]
    ok = valid & (ws > grid_size) & (hs > grid_size)

    fx = factors[None, :, 0]
    fy = factors[None, :, 1]
    gx = fx * pos_gt_bboxes[:, 0:1] + (1 - fx) * pos_gt_bboxes[:, 2:3]
    gy = fy * pos_gt_bboxes[:, 1:2] + (1 - fy) * pos_gt_bboxes[:, 3:4]
    safe_w = torch.clamp(ws, min=1e-6)[:, None]
    safe_h = torch.clamp(hs, min=1e-6)[:, None]
    # truncation toward zero, as int() in the reference
    cx = torch.trunc((gx - exp[:, 0:1]) / safe_w * whole).to(torch.int32)
    cy = torch.trunc((gy - exp[:, 1:2]) / safe_h * whole).to(torch.int32)

    # sub-region pixel (y, x) of point p is whole-map (y + sub_y1[p], x + sub_x1[p])
    ar = torch.arange(half, dtype=torch.int32, device=dev)
    map_x = (ar[None, None, :] + subs[:, 0, None, None])[None]  # [1, P, 1, half]
    map_y = (ar[None, :, None] + subs[:, 1, None, None])[None]  # [1, P, half, 1]
    dx = map_x - cx[:, :, None, None]
    dy = map_y - cy[:, :, None, None]
    inside = (dx * dx + dy * dy) <= pos_radius * pos_radius
    if target_refine:
        oob = (cx < 0) | (cx >= whole) | (cy < 0) | (cy >= whole)
        ccx = torch.clamp(cx, 0, whole - 1)[:, :, None, None]
        ccy = torch.clamp(cy, 0, whole - 1)[:, :, None, None]
        inside = inside | (oob[:, :, None, None] & (map_x == ccx) & (map_y == ccy))
    return (inside & ok[:, None, None, None]).to(torch.float32)


def grid_decode(
    proposals: torch.Tensor,
    heatmaps: torch.Tensor,
    image_sizes: torch.Tensor,
    *,
    mapping_ratio: float = 1.0,
    grid_points: int = 9,
    roi_feat_size: int = 14,
    apply_sigmoid: bool = True,
) -> torch.Tensor:
    """Refined boxes [N, 4] from proposals [N, 4], heatmap logits
    [N, P, half, half] and per-roi image sizes [N, 2] (h, w)."""
    grid_size = int(np.sqrt(grid_points))
    whole = roi_feat_size * 4
    half = whole // 4 * 2
    subs = torch.tensor(
        calc_sub_regions(grid_points, grid_size, whole), dtype=torch.long,
        device=heatmaps.device,
    )
    hm = torch.sigmoid(heatmaps) if apply_sigmoid else heatmaps
    N, P = hm.shape[:2]
    pred_scores, pos = torch.max(hm.reshape(N, P, half * half), dim=-1)
    xs = (pos % half) + subs[None, :, 0]
    ys = (pos // half) + subs[None, :, 1]

    widths = (proposals[:, 2] - proposals[:, 0])[:, None]
    heights = (proposals[:, 3] - proposals[:, 1])[:, None]
    x1 = proposals[:, 0, None] - mapping_ratio * (widths / 2)
    y1 = proposals[:, 1, None] - mapping_ratio * (heights / 2)
    abs_xs = (xs.to(hm.dtype) + 0.5) / (2 * half) * (1 + mapping_ratio) * widths + x1
    abs_ys = (ys.to(hm.dtype) + 0.5) / (2 * half) * (1 + mapping_ratio) * heights + y1

    x1_inds = list(range(grid_size))
    y1_inds = [i * grid_size for i in range(grid_size)]
    x2_inds = [grid_points - grid_size + i for i in range(grid_size)]
    y2_inds = [(i + 1) * grid_size - 1 for i in range(grid_size)]

    def vote(coords, inds):
        s = pred_scores[:, inds]
        denom = torch.clamp(s.sum(dim=1), min=1e-12)
        return (coords[:, inds] * s).sum(dim=1) / denom

    h = image_sizes[:, 0].to(hm.dtype)
    w = image_sizes[:, 1].to(hm.dtype)
    zero = torch.zeros((), dtype=hm.dtype, device=hm.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - 1)

    return torch.stack([
        clip(vote(abs_xs, x1_inds), w),
        clip(vote(abs_ys, y1_inds), h),
        clip(vote(abs_xs, x2_inds), w),
        clip(vote(abs_ys, y2_inds), h),
    ], dim=-1)
