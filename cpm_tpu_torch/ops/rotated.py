"""Rotated-box ops: IoU, NMS and RoIAlign for (cx, cy, w, h, angle) boxes,
and IoU and NMS for free quadrilaterals.

Port of cpm_tpu/ops/rotated.py (the reference's box_iou_rotated,
nms_rotated, ROIAlignRotated and poly_nms CUDA ops). Plain PyTorch on both
devices: no model path runs them, and the JAX package runs them as XLA ops,
not as Pallas kernels.

The pairwise intersection is the JAX package's vectorised Sutherland-Hodgman
clip: one convex quadrilateral clipped against the four half-planes of the
other, vertex buffers padded to a static 8 slots, every pair at once. The
clip runs in f32 in another order of operations than XLA's, so an IoU can
differ from the JAX package's by float noise near tangency, and an NMS keep
can flip where an IoU lies at the threshold.

Angles are in degrees, counter-clockwise positive, as in the reference.
Feature maps are NHWC `[B, H, W, C]`.
"""

import math
from typing import Optional, Tuple

import torch

from cpm_tpu_torch.ops.nms import greedy_nms
from cpm_tpu_torch.ops.roi_pool import bilinear_gather

V = 8  # vertex slots: a quadrilateral clipped by a quadrilateral has at most 8


def rotated_box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (cx, cy, w, h, angle_deg) -> [..., 4, 2] corners (ccw)."""
    cx, cy, w, h, a = boxes.unbind(-1)
    theta = a * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    dx, dy = w / 2.0, h / 2.0
    lx = torch.stack([dx, -dx, -dx, dx], dim=-1)
    ly = torch.stack([dy, dy, -dy, -dy], dim=-1)
    px = cx[..., None] + lx * cos - ly * sin
    py = cy[..., None] + lx * sin + ly * cos
    return torch.stack([px, py], dim=-1)


def polygon_area(pts: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shoelace area of padded polygons [..., V, 2] whose padding slots
    repeat the last valid vertex (the clip keeps that invariant), so the
    unmasked sum is exact. `valid` is unused, as in the JAX package."""
    x, y = pts[..., 0], pts[..., 1]
    cross = x * torch.roll(y, -1, dims=-1) - torch.roll(x, -1, dims=-1) * y
    return 0.5 * torch.abs(cross.sum(dim=-1))


def clip_by_halfplane(pts: torch.Tensor, count: torch.Tensor, a, b, c):
    """Clip padded convex polygons pts [..., V, 2] (the first `count` [...]
    vertices in cyclic order, the padding repeating the last) by the
    half-plane a*x + b*y + c >= 0 (a, b, c broadcast to the batch shape).
    Returns the clipped polygons and their counts, with the same invariant."""
    nv = pts.shape[-2]
    d = a[..., None] * pts[..., 0] + b[..., None] * pts[..., 1] + c[..., None]  # [..., V]
    inside = d >= 0
    slot = torch.arange(nv, device=pts.device)
    nxt = torch.where(slot + 1 >= count[..., None], 0, slot + 1)  # [..., V]
    p_j = torch.gather(pts, -2, nxt[..., None].expand(*nxt.shape, 2))
    d_j = torch.gather(d, -1, nxt)
    in_j = torch.gather(inside, -1, nxt)
    active = slot < count[..., None]

    denom = d - d_j
    t = d / torch.where(denom.abs() < 1e-12, denom.new_tensor(1e-12), denom)
    inter = pts + (p_j - pts) * t[..., None]

    emit_v = inside & active
    emit_x = (inside ^ in_j) & active
    n_emit = emit_v.long() + emit_x.long()
    start = torch.cumsum(n_emit, dim=-1) - n_emit
    pos_v = torch.where(emit_v, start, nv)
    pos_x = torch.where(emit_x, start + emit_v.long(), nv)
    new_count = n_emit.sum(dim=-1)

    # slot nv collects what is not emitted and is dropped
    out = pts.new_zeros(pts.shape[:-2] + (nv + 1, 2))
    out = out.scatter(-2, pos_v[..., None].expand(*pos_v.shape, 2), pts)
    out = out.scatter(-2, pos_x[..., None].expand(*pos_x.shape, 2), inter)[..., :nv, :]
    last_i = torch.clamp(new_count - 1, min=0)[..., None, None].expand(*new_count.shape, 1, 2)
    last = torch.gather(out, -2, last_i)
    out = torch.where((slot >= new_count[..., None])[..., None], last, out)
    return out, new_count


def _clipped_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Intersection areas [N, M] of convex quadrilaterals c1 [N, 4, 2] and
    c2 [M, 4, 2] (either orientation)."""
    N, M = c1.shape[0], c2.shape[0]
    pts = c1[:, None].expand(N, M, 4, 2)
    pts = torch.cat([pts, pts[..., 3:4, :].expand(N, M, V - 4, 2)], dim=-2)
    count = torch.full((N, M), 4, dtype=torch.long, device=c1.device)
    center = c2.mean(dim=1)  # [M, 2]
    for k in range(4):
        p, q = c2[:, k], c2[:, (k + 1) % 4]
        a = -(q[:, 1] - p[:, 1])
        b = q[:, 0] - p[:, 0]
        c = -(a * p[:, 0] + b * p[:, 1])
        # the inward side is the one that holds the polygon's centre
        s = a * center[:, 0] + b * center[:, 1] + c
        sgn = torch.where(s >= 0, 1.0, -1.0).to(a.dtype)
        pts, count = clip_by_halfplane(pts, count, (a * sgn).expand(N, M), (b * sgn).expand(N, M),
                                       (c * sgn).expand(N, M))
    return torch.where(count >= 3, polygon_area(pts), pts.new_zeros(()))


def rotated_pair_intersection_area(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection areas of rotated boxes [N, 5] x [M, 5] -> [N, M]."""
    return _clipped_area(rotated_box_corners(boxes1), rotated_box_corners(boxes2))


def _iou(inter, a1, a2):
    union = a1[:, None] + a2[None, :] - inter
    return torch.where(union > 0, inter / union, inter.new_zeros(()))


def box_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[N, 5] x [M, 5] -> [N, M] IoU of rotated boxes."""
    return _iou(rotated_pair_intersection_area(boxes1, boxes2),
                boxes1[:, 2] * boxes1[:, 3], boxes2[:, 2] * boxes2[:, 3])


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_output: int,
                mask: Optional[torch.Tensor] = None):
    """Greedy NMS over rotated boxes [N, 5]; returns (indices [max_output],
    keep [max_output]) as ops/nms.py::nms does."""
    return greedy_nms(boxes, scores, iou_threshold, max_output, mask, box_iou_rotated)


def quad_area(quads: torch.Tensor) -> torch.Tensor:
    """[..., 8] (x1 y1 ... x4 y4) -> shoelace area."""
    return polygon_area(quads.reshape(quads.shape[:-1] + (4, 2)))


def poly_iou(quads1: torch.Tensor, quads2: torch.Tensor) -> torch.Tensor:
    """IoU of convex quadrilaterals [N, 8] x [M, 8] -> [N, M]."""
    inter = _clipped_area(quads1.reshape(-1, 4, 2), quads2.reshape(-1, 4, 2))
    return _iou(inter, quad_area(quads1), quad_area(quads2))


def poly_nms(quads: torch.Tensor, scores: torch.Tensor, iou_threshold: float, max_output: int,
             mask: Optional[torch.Tensor] = None):
    """Greedy NMS over quadrilaterals [N, 8], as `nms_rotated`."""
    return greedy_nms(quads, scores, iou_threshold, max_output, mask, poly_iou)


def roi_align_rotated(features: torch.Tensor, rois: torch.Tensor, output_size: Tuple[int, int],
                      spatial_scale: float, sampling_ratio: int = 0) -> torch.Tensor:
    """RoIAlign over rotated rois [R, 6] (batch index, cx, cy, w, h,
    angle_deg): the axis-aligned grid of `sampling_ratio` (2 when 0)
    samples a bin side, rotated about the roi's centre. features [B, H, W,
    C] -> [R, ph, pw, C]."""
    ph, pw = output_size
    sr = sampling_ratio if sampling_ratio > 0 else 2
    B, H, W, C = features.shape
    R = rois.shape[0]
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    rw = torch.clamp(rois[:, 3] * spatial_scale, min=1.0)
    rh = torch.clamp(rois[:, 4] * spatial_scale, min=1.0)
    theta = rois[:, 5] * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    # divisions by tensors on the device, not by numbers, which CUDA turns
    # into products with their reciprocals
    n = rois.new_tensor([float(sr), float(pw), float(ph), 2.0])
    ix = (torch.arange(pw * sr, device=rois.device, dtype=rois.dtype) + 0.5) / n[0]
    iy = (torch.arange(ph * sr, device=rois.device, dtype=rois.dtype) + 0.5) / n[0]
    lx = (ix[None, :] * (rw / n[1])[:, None] - rw[:, None] / n[3])[:, None, :]  # [R, 1, pw*sr]
    ly = (iy[None, :] * (rh / n[2])[:, None] - rh[:, None] / n[3])[:, :, None]  # [R, ph*sr, 1]
    xs = cx[:, None, None] + lx * cos - ly * sin  # [R, ph*sr, pw*sr]
    ys = cy[:, None, None] + lx * sin + ly * cos
    base = (rois[:, 0].long() * H * W)[:, None, None]
    vals = bilinear_gather(features.reshape(B * H * W, C), base, xs, ys, H, W)
    return vals.reshape(R, ph, sr, pw, sr, C).mean(dim=(2, 4))
