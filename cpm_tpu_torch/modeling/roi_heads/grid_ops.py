"""Grid R-CNN heatmap targets and decode.

Port of cpm_tpu/modeling/roi_heads/grid_ops.py (`calc_sub_regions`,
`_point_factors`, `expand_boxes`, `grid_targets`, `grid_decode`, and the
grid-cascade options' box and feature transforms `resize_large_rois`,
`extend_rois`, `enhance_features`, `random_jitter_boxes`,
`better_roi_mask`). Targets:
per grid point, a disc of radius POS_RADIUS around the gt point's position
in the mapping-ratio expansion of the box, cropped to the point's
sub-region. Decode: per grid point, the argmax of its sub-region heatmap,
mapped back through the expansion, then confidence-weighted border voting
and a clamp of the refined box into the image.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from cpm_tpu_torch.utils.spans import sync


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
    with sync("consts"):
        subs = torch.tensor(calc_sub_regions(grid_points, grid_size, whole), dtype=torch.int32,
                            device=dev)
    with sync("consts"):
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
    with sync("consts"):
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
        # a list index is copied from the host
        with sync("consts"):
            s = pred_scores[:, inds]
        denom = torch.clamp(s.sum(dim=1), min=1e-12)
        with sync("consts"):
            picked = coords[:, inds]
        return (picked * s).sum(dim=1) / denom

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


def resize_large_rois(boxes: torch.Tensor, thresh: float = 96.0 ** 2,
                      delta_ratio: float = 0.7) -> torch.Tensor:
    """CASCADE_MAPPING_OPTION.RESIZE_ROI: a box of area above `thresh`
    shrinks by delta_ratio * half its extent on each side."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    dx = delta_ratio * 0.5 * w
    dy = delta_ratio * 0.5 * h
    shrunk = torch.stack([boxes[..., 0] + dx, boxes[..., 1] + dy,
                          boxes[..., 2] - dx, boxes[..., 3] - dy], dim=-1)
    return torch.where(((w * h) > thresh)[..., None], shrunk, boxes)


def _clip(v: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.clamp(v, min=0.0), hi)


def extend_rois(boxes: torch.Tensor, image_sizes: torch.Tensor) -> torch.Tensor:
    """EXTEND_ROI: each side grows by half the box's extent (twice the
    width and height), clamped to [0, image width or height]. `image_sizes`
    (h, w) broadcasts against boxes[..., :2]."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    ih = image_sizes[..., 0].to(boxes.dtype)
    iw = image_sizes[..., 1].to(boxes.dtype)
    return torch.stack([
        _clip(boxes[..., 0] - 0.5 * w, iw), _clip(boxes[..., 1] - 0.5 * h, ih),
        _clip(boxes[..., 2] + 0.5 * w, iw), _clip(boxes[..., 3] + 0.5 * h, ih),
    ], dim=-1)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """The source index of each output row of a nearest resize, with half-pixel
    centres as jax.image.resize computes them: floor((i + 0.5) * n_in / n_out)
    in float32. (`F.interpolate(mode="nearest")` reads floor(i * n_in /
    n_out), a cell off on a 2x downsample.)"""
    i = np.arange(n_out, dtype=np.float32)
    idx = np.floor((i + np.float32(0.5)) * np.float32(n_in) / np.float32(n_out)).astype(np.int64)
    return torch.from_numpy(idx).to(device)


def _resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, h, w, C], nearest with half-pixel centres."""
    if x.shape[1] != h:
        x = x.index_select(1, _nearest_index(x.shape[1], h, x.device))
    if x.shape[2] != w:
        x = x.index_select(2, _nearest_index(x.shape[2], w, x.device))
    return x


def enhance_features(features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """ENHANCE_FEATURES cross-level mixing over NHWC levels (P2..P6):
    out[i] = f[i] + nearest_down(out[i - 1]) + nearest_up(f[i + 1]) for every
    level but the last, which only feeds the one before it; returns the
    RoI levels (P2..P5)."""
    out: List[torch.Tensor] = []
    for i, feat in enumerate(features[:-1]):
        h, w = feat.shape[1], feat.shape[2]
        if i > 0:
            feat = feat + _resize_nearest(out[i - 1], h, w)
        out.append(feat + _resize_nearest(features[i + 1], h, w))
    return out


def random_jitter_boxes(boxes: torch.Tensor, u: torch.Tensor, image_sizes: torch.Tensor,
                        amplitude: float = 0.15) -> torch.Tensor:
    """RANDOM_JITTER: each box's centre moves by up to `amplitude` of its
    width and height, and its width and height scale by 1 +- amplitude;
    clamped to the image. `u` [..., 4] holds uniform [0, 1) draws, mapped to
    [-amplitude, amplitude) as u * 2 * amplitude - amplitude; `image_sizes`
    (h, w) broadcasts against boxes[..., :2]."""
    off = u * (2 * amplitude) - amplitude
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    w = (boxes[..., 2] - boxes[..., 0]).abs()
    h = (boxes[..., 3] - boxes[..., 1]).abs()
    ncx = cx + w * off[..., 0]
    ncy = cy + h * off[..., 1]
    nw = w * (1 + off[..., 2])
    nh = h * (1 + off[..., 3])
    ih = image_sizes[..., 0].to(boxes.dtype) - 1
    iw = image_sizes[..., 1].to(boxes.dtype) - 1
    return torch.stack([
        _clip(ncx - nw / 2, iw), _clip(ncy - nh / 2, ih),
        _clip(ncx + nw / 2, iw), _clip(ncy + nh / 2, ih),
    ], dim=-1)


def better_roi_mask(boxes: torch.Tensor, gt_boxes: torch.Tensor, ratio: float = 0.25
                    ) -> torch.Tensor:
    """BETTER_ROI: True where the box's centre lies within `ratio` of its
    matched gt box's extent (a squared-distance test) of the gt's centre."""
    bx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    by = (boxes[..., 1] + boxes[..., 3]) * 0.5
    gx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5
    gy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
    dist = (gx - bx) ** 2 + (gy - by) ** 2
    max_dist = ((ratio * (gt_boxes[..., 2] - gt_boxes[..., 0])) ** 2
                + (ratio * (gt_boxes[..., 3] - gt_boxes[..., 1])) ** 2)
    return (max_dist - dist) >= 0
