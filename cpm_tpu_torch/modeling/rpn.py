"""Region Proposal Network: anchors, head, proposal selection and losses.

Port of cpm_tpu/modeling/rpn.py (`generate_cell_anchors`, `grid_anchors`,
`AnchorLayout`, `RPNHead`, `select_proposals`, `rpn_losses`). Anchors use
Detectron's rounding and are laid out in (h, w, a) order to match the NHWC
flattening of the head outputs. Pre-NMS selection is an exact top-k
(index-ordered on ties, as `lax.top_k`; the JAX package's approximate top-k
is a TPU knob that CPU JAX also runs exactly); NMS is ops/nms.py's, once
over every level and image.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.ops.box_coder import BoxCoder
from cpm_tpu_torch.ops.losses import bce_with_logits_elementwise, global_count, smooth_l1_loss
from cpm_tpu_torch.ops.nms import nms, topk
from cpm_tpu_torch.parallel.mesh import concat_ranks
from cpm_tpu_torch.structures.boxes import (
    box_iou,
    clip_boxes_to_image,
    remove_small_boxes_mask,
)
from cpm_tpu_torch.utils.matcher import BETWEEN_THRESHOLDS, match_boxes
from cpm_tpu_torch.utils.sampler import balanced_sample


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
        straddle_thresh: float = 0.0,
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
        self.straddle_thresh = straddle_thresh
        self._tensors = {}

    def on(self, device) -> List[torch.Tensor]:
        device = torch.device(device)
        if device not in self._tensors:
            self._tensors[device] = [torch.from_numpy(a).to(device) for a in self.per_level]
        return self._tensors[device]

    def visibility(self, image_sizes: torch.Tensor) -> torch.Tensor:
        """[B, N] bool over all levels' anchors: the anchor lies inside the
        true image, give or take straddle_thresh; a negative threshold means
        all visible."""
        a = torch.cat(self.on(image_sizes.device), dim=0)
        if self.straddle_thresh < 0:
            return torch.ones((image_sizes.shape[0], a.shape[0]), dtype=torch.bool, device=a.device)
        t = self.straddle_thresh
        h = image_sizes[:, 0:1].to(a.dtype)
        w = image_sizes[:, 1:2].to(a.dtype)
        return (
            (a[None, :, 0] >= -t) & (a[None, :, 1] >= -t)
            & (a[None, :, 2] < w + t) & (a[None, :, 3] < h + t)
        )


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
    fpn_post_nms_per_batch: bool = True,
    is_train: bool = False,
    gt_boxes: Optional[torch.Tensor] = None,
    gt_mask: Optional[torch.Tensor] = None,
):
    """Fixed-shape proposal selection.

    Every level's candidates (`level_candidates`) form one padded batch,
    and one NMS call runs over all its rows (images x levels): on a card
    the kernels of ops/cuda, with no wait of the host. Each level keeps
    `post_nms_top_n` slots, levels in order, as a per-level loop would.

    Args:
      objectness / box_regression: per-level NHWC head outputs.
      image_sizes: [B, 2] true (h, w).
      gt_boxes / gt_mask: [B, G, 4] / [B, G], appended when training.

    Returns (proposals [B, K, 4], scores [B, K], mask [B, K]) with
    K = min(fpn_post_nms_top_n, levels x post_nms_top_n), plus G in training.
    """
    if box_coder is None:
        box_coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
    B = objectness[0].shape[0]
    boxes, scores, valid = level_candidates(
        layout, objectness, box_regression, image_sizes, pre_nms_top_n, min_size, box_coder)
    idx, keep = nms(boxes, scores, nms_thresh, post_nms_top_n, mask=valid)  # [B, L, post]
    boxes = torch.gather(boxes, 2, idx[..., None].expand(*idx.shape, 4)).reshape(B, -1, 4)
    scores = torch.gather(scores, 2, idx).reshape(B, -1)
    valid = keep.reshape(B, -1)
    if len(objectness) > 1:
        neg_inf = torch.finfo(scores.dtype).min
        masked = torch.where(valid, scores, neg_inf)
        if is_train and fpn_post_nms_per_batch:
            valid = keep_batch_top_k(masked, valid, fpn_post_nms_top_n)
            masked = torch.where(valid, scores, neg_inf)
        k = min(fpn_post_nms_top_n, masked.shape[1])
        _, top_idx = topk(masked, k)
        boxes = torch.gather(boxes, 1, top_idx[..., None].expand(*top_idx.shape, 4))
        valid = torch.gather(valid, 1, top_idx)
        scores = torch.gather(scores, 1, top_idx)
    if is_train and gt_boxes is not None:
        boxes = torch.cat([boxes, gt_boxes.to(boxes.dtype)], dim=1)
        scores = torch.cat([scores, torch.ones_like(gt_mask, dtype=scores.dtype)], dim=1)
        valid = torch.cat([valid, gt_mask], dim=1)
    return boxes, scores, valid


def level_candidates(layout, objectness, box_regression, image_sizes, pre_nms_top_n: int,
                     min_size: float, box_coder: BoxCoder):
    """Each level's pre-NMS candidates as one padded batch: (boxes
    [B, L, K, 4], scores [B, L, K], valid [B, L, K]), K the largest
    k = min(pre_nms_top_n, a level's anchors). A level's slots hold its k
    best anchors in descending score order, ties in index order, decoded,
    clipped to the image and valid where neither side is under min_size;
    its slots past k hold zeros and are invalid. CPU tensors take
    `level_candidates_plain`; tensors on a card the CUDA kernel of
    ops/cuda/rpn_candidates.py, or raise."""
    dev = objectness[0].device
    if dev.type == "cpu":
        return level_candidates_plain(layout.on(dev), objectness, box_regression, image_sizes,
                                      pre_nms_top_n, min_size, box_coder)
    from cpm_tpu_torch.ops.cuda.rpn_candidates import rpn_candidates_cuda

    return rpn_candidates_cuda(layout.on(dev), objectness, box_regression, image_sizes,
                               pre_nms_top_n, min_size, box_coder)


def level_candidates_plain(anchors_per_level, objectness, box_regression, image_sizes,
                           pre_nms_top_n: int, min_size: float, box_coder: BoxCoder):
    """`level_candidates` level by level in PyTorch ops: the plain version
    of the CUDA kernel."""
    img_w = image_sizes[:, None, 1].float()
    img_h = image_sizes[:, None, 0].float()
    K = max(min(pre_nms_top_n, a.shape[0]) for a in anchors_per_level)
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
        lvl_boxes.append(F.pad(proposals, (0, 0, 0, K - k)))
        lvl_scores.append(F.pad(top_scores, (0, K - k)))
        lvl_valid.append(F.pad(valid, (0, K - k)))
    return torch.stack(lvl_boxes, 1), torch.stack(lvl_scores, 1), torch.stack(lvl_valid, 1)


def keep_batch_top_k(masked: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Detectron's train-time quirk: the top-k runs over the whole batch.
    Slots at or above the k-th score of the batch stay valid (ties keep more
    than k); each image is then compacted as usual.

    The batch is the global one, every rank's images (the JAX program's
    batch is global): each rank's own top-k scores, padded to k with the
    masked value where it holds fewer slots, are gathered in rank order, and
    the k-th of them is the k-th of the global batch, whatever the ranks'
    candidate counts (a padded k-th keeps every valid slot, as the k-th of
    fewer than k slots does). masked: [B, N] scores, the masked value (the
    dtype's lowest) at invalid slots; valid: [B, N]. Returns this rank's
    valid slots."""
    flat = masked.reshape(-1)
    top = topk(flat, min(k, flat.shape[0]))[0]
    top = F.pad(top, (0, k - top.shape[0]), value=torch.finfo(top.dtype).min)
    kth = topk(concat_ranks(top), k)[0][-1]
    return valid & (masked >= kth)


def rpn_losses(
    layout: AnchorLayout,
    objectness: Sequence[torch.Tensor],
    box_regression: Sequence[torch.Tensor],
    image_sizes: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    noise_pos: torch.Tensor,
    noise_neg: torch.Tensor,
    *,
    fg_iou_threshold: float = 0.7,
    bg_iou_threshold: float = 0.3,
    batch_size_per_image: int = 256,
    positive_fraction: float = 0.5,
    smooth_l1_beta: float = 1.0 / 9,
    box_coder: BoxCoder = None,
):
    """(loss_objectness, loss_rpn_box_reg): smooth-L1 summed over the sampled
    positives and BCE summed over the sampled anchors, both over the total
    sampled count of the batch. noise_pos / noise_neg: [B, N] uniform draws
    for the balanced sampler. Losses and box targets are f32 whatever the
    compute dtype. The sampled count is the global batch's (every rank's)."""
    if box_coder is None:
        box_coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
    B = objectness[0].shape[0]
    obj_flat = torch.cat([o.float().reshape(B, -1) for o in objectness], dim=1)  # [B, N]
    reg_flat = torch.cat([r.float().reshape(B, -1, 4) for r in box_regression], dim=1)
    anchors = torch.cat(layout.on(obj_flat.device), dim=0)  # [N, 4]

    quality = box_iou(gt_boxes, anchors[None])  # [B, M, N]
    matches = match_boxes(
        quality, gt_mask, fg_iou_threshold, bg_iou_threshold, allow_low_quality_matches=True,
    )
    labels = (matches >= 0).to(torch.float32)
    discard = ~layout.visibility(image_sizes) | (matches == BETWEEN_THRESHOLDS)
    matched_gt = torch.gather(
        gt_boxes, 1, torch.clamp(matches, min=0).long()[..., None].expand(-1, -1, 4)
    )
    reg_targets = box_coder.encode(matched_gt, anchors[None])

    positive = matches >= 0
    sel_pos, sel_neg = balanced_sample(
        positive & ~discard, ~positive & ~discard,
        batch_size_per_image, positive_fraction, noise_pos, noise_neg,
    )
    sampled = sel_pos | sel_neg
    n_sampled = global_count(sampled.sum().to(torch.float32))
    box_loss = smooth_l1_loss(
        reg_flat, reg_targets, beta=smooth_l1_beta,
        weights=sel_pos[..., None].to(reg_flat.dtype), normalizer=n_sampled,
    )
    bce = bce_with_logits_elementwise(obj_flat, labels)
    objectness_loss = (bce * sampled.to(bce.dtype)).sum() / n_sampled
    return objectness_loss, box_loss
