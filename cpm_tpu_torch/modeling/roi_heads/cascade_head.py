"""Cascade R-CNN head, with the ISM IoU branch and RSM rescoring.

Port of cpm_tpu/modeling/roi_heads/cascade_head.py (`CascadeStageOutput`,
`CascadeRCNNHead`): NUM_STAGE box stages at rising IoU thresholds, each with
its own box coder (CASCADE_RCNN.BBOX_REG_WEIGHTS) and loss weight
(STAGE_WEIGHTS).

Training, stage by stage: sample BATCH_SIZE_PER_IMAGE rois at the stage's
thresholds, pool them at 7x7, take the cross entropy and the smooth-L1 of
the class-agnostic deltas; between stages decode the deltas (no gradient,
the boxes not clipped), drop the rows that are degenerate or equal a gt
box, and append the gt boxes, so that from stage 2 on the sampler draws
over [B, S + G]. ISM: an L2 loss on the last stage's IoU branch. RSM: a
second 7x7 cls branch (the grid head's `ClsHead` / `ClsOutput`) trained on
stage 1's negatives and the last stage's positives.

Test: the stages run on their own refined boxes up to TEST_STAGE; the last
one's softmax is taken over the mean of every stage's logits
(TEST_ENSEMBLE), multiplied by (IOU_HELPER_MERGE) or replaced with the IoU
prediction when the test stage is the last stage; then per-class decode,
the detection filter, and RSM's score^0.8 * rescore^0.2.

As in the JAX package, the stage outputs are not upcast: under bf16 compute
the cascade's logits, deltas and IoU logits, and the boxes decoded from
them, are bf16.
"""

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.modeling.roi_heads.box_head import (
    build_box_head,
    decode_boxes_per_class,
    detection_filter_kwargs,
    fast_rcnn_losses,
    filter_detections,
)
from cpm_tpu_torch.modeling.roi_heads.grid_modules import ClsHead, ClsOutput, rescore_detections
from cpm_tpu_torch.modeling.roi_heads.targets import rois_with_batch_index, subsample_rois
from cpm_tpu_torch.ops.box_coder import BoxCoder
from cpm_tpu_torch.ops.losses import l2_loss, softmax_cross_entropy


class CascadeStageOutput(nn.Module):
    """cls score, box deltas (8 if class-agnostic, else 4C) and, with
    `iou_helper`, the ISM branch iou_fc1 -> iou_fc2 -> iou_pred (2 logits);
    all in the compute dtype."""

    def __init__(self, in_features: int, num_classes: int, cls_agnostic_bbox_reg: bool = True,
                 iou_helper: bool = False, generator: torch.Generator = None):
        super().__init__()
        g = generator
        self.cls_score = nn.Linear(in_features, num_classes)
        self.bbox_pred = nn.Linear(in_features, 8 if cls_agnostic_bbox_reg else 4 * num_classes)
        init.normal_(self.cls_score.weight, 0.01, g)
        init.normal_(self.bbox_pred.weight, 0.001, g)
        self.iou_helper = iou_helper
        if iou_helper:
            self.iou_fc1 = nn.Linear(in_features, 1024)
            self.iou_fc2 = nn.Linear(1024, 1024)
            self.iou_pred = nn.Linear(1024, 2)
            init.mlp_fc(self.iou_fc1.weight, g)
            init.mlp_fc(self.iou_fc2.weight, g)
            init.normal_(self.iou_pred.weight, 0.01, g)
        for m in self.children():
            nn.init.zeros_(m.bias)

    def forward(self, x):
        iou_logits = None
        if self.iou_helper:
            iou_logits = self.iou_pred(F.relu(self.iou_fc2(F.relu(self.iou_fc1(x)))))
        return self.cls_score(x), self.bbox_pred(x), iou_logits


class CascadeRCNNHead(nn.Module):
    def __init__(self, cfg, in_channels: int, generator: torch.Generator = None):
        super().__init__()
        c = cfg
        cc = c.CASCADE_RCNN
        self.cfg = cfg
        self.num_stage = cc.NUM_STAGE
        self.test_stage = cc.TEST_STAGE
        self.stage_weights = tuple(cc.STAGE_WEIGHTS)
        self.fg_thresholds = tuple(cc.FG_IOU_THRESHOLD)
        self.bg_thresholds = tuple(cc.BG_IOU_THRESHOLD)
        self.box_coders = tuple(BoxCoder(weights=tuple(w)) for w in cc.BBOX_REG_WEIGHTS)
        self.num_levels = c.FPN.ROI_MAX_LEVEL - c.FPN.ROI_MIN_LEVEL + 1
        scales = tuple(0.5 ** (c.FPN.ROI_MIN_LEVEL + i) for i in range(self.num_levels))
        self.box_heads = nn.ModuleList()
        self.outputs = nn.ModuleList()
        for s in range(self.num_stage):
            head, dim = build_box_head(c, cc.ROI_BOX_HEAD, in_channels, scales, generator,
                                       sized_by_cfg=False)
            self.box_heads.append(head)
            self.outputs.append(CascadeStageOutput(
                dim, c.MODEL.NUM_CLASSES, c.MODEL.CLS_AGNOSTIC_BBOX_REG,
                iou_helper=bool(cc.IOU_HELPER and s == self.num_stage - 1), generator=generator,
            ))
        self.rescore_on = bool(cc.RESCORE_ON)
        if self.rescore_on:
            g = c.GRID_RCNN
            self.rescore_head = ClsHead(
                in_channels, tuple(g.ROI_XFORM_RESOLUTION_CLS), scales,
                g.ROI_XFORM_SAMPLING_RATIO, g.MLP_HEAD.MLP_DIM, generator,
            )
            self.rescore_output = ClsOutput(g.MLP_HEAD.MLP_DIM, c.MODEL.NUM_CLASSES, generator)

    def _stage(self, s, features, boxes, mask):
        return self.outputs[s](
            self.box_heads[s](features, rois_with_batch_index(boxes), mask.reshape(-1)))

    def _decode_agnostic(self, box_reg, boxes, s):
        """The refinement decode of stage s: the foreground columns 4:8."""
        return self.box_coders[s].decode(box_reg[..., 4:8], boxes)

    # ---------------- train ----------------

    def _train(self, features, proposals, prop_mask, gt, draws):
        c = self.cfg
        cc = c.CASCADE_RCNN
        losses = {}
        boxes, mask = proposals, prop_mask
        for s in range(self.num_stage):
            sampled = subsample_rois(
                boxes.detach(), mask, gt["boxes"], gt["labels"], gt["mask"],
                draws(mask.shape, mask.device), draws(mask.shape, mask.device),
                batch_size_per_image=c.FAST_RCNN.BATCH_SIZE_PER_IMAGE,
                positive_fraction=c.FAST_RCNN.POSITIVE_FRACTION,
                fg_iou_threshold=self.fg_thresholds[s], bg_iou_threshold=self.bg_thresholds[s],
                box_coder=self.box_coders[s],
            )
            if s == 0:
                first = sampled
            sample_mask = sampled.mask.reshape(-1)
            cls_logits, box_reg, iou_logits = self._stage(s, features, sampled.boxes, sampled.mask)
            loss_cls, loss_box = fast_rcnn_losses(
                cls_logits, box_reg, sampled.labels.reshape(-1), sampled.reg_targets.reshape(-1, 4),
                sample_mask.to(cls_logits.dtype), smooth_l1_beta=c.FAST_RCNN.SMOOTH_L1_BETA,
                cls_agnostic_bbox_reg=c.MODEL.CLS_AGNOSTIC_BBOX_REG,
            )
            w = self.stage_weights[s]
            losses[f"s{s + 1}_cls_loss"] = loss_cls * w
            losses[f"s{s + 1}_bbox_loss"] = loss_box * w
            if iou_logits is not None:
                iou = sampled.matched_iou
                iou_t = torch.stack([1.0 - iou, iou], dim=-1).reshape(-1, 2)
                losses[f"loss_iou_{self.num_stage}"] = cc.IOU_LOSS_WEIGHT * l2_loss(
                    iou_logits, iou_t, mask=sample_mask[:, None])
            if s < self.num_stage - 1:
                # refine under no gradient, unclipped; drop the degenerate rows
                # and those equal to a gt box, then append the gt boxes
                B, S = sampled.boxes.shape[:2]
                refined = self._decode_agnostic(box_reg.detach().reshape(B, S, -1),
                                                sampled.boxes, s)
                ok = ((refined[..., 2] - refined[..., 0] + 1.0 > 0)
                      & (refined[..., 3] - refined[..., 1] + 1.0 > 0))
                same = (sampled.boxes[:, :, None, :] - gt["boxes"][:, None, :, :]).abs() < 1e-5
                eq_gt = (same.all(dim=-1) & gt["mask"][:, None, :]).any(dim=-1)
                boxes = torch.cat([refined, gt["boxes"]], dim=1)
                mask = torch.cat([sampled.mask & ok & ~eq_gt, gt["mask"]], dim=1)
        if self.rescore_on:
            losses["loss_rescore"] = self._train_rescore(features, first, sampled, gt, draws)
        return losses

    def _train_rescore(self, features, first, last, gt, draws):
        """RSM's loss: stage 1's sampled negatives and the last stage's
        sampled positives, sampled again at GRID_RCNN's settings."""
        c = self.cfg
        g = c.GRID_RCNN
        union_boxes = torch.cat([first.boxes, last.boxes], dim=1)
        union_mask = torch.cat([first.mask & (first.labels == 0),
                                last.mask & (last.labels > 0)], dim=1)
        sampled = subsample_rois(
            union_boxes, union_mask, gt["boxes"], gt["labels"], gt["mask"],
            draws(union_mask.shape, union_mask.device), draws(union_mask.shape, union_mask.device),
            batch_size_per_image=g.BATCH_SIZE_PER_IMAGE, positive_fraction=g.POSITIVE_FRACTION,
            fg_iou_threshold=g.FG_IOU_THRESHOLD, bg_iou_threshold=g.BG_IOU_THRESHOLD,
            box_coder=self.box_coders[0],
        )
        x = self.rescore_head(features, rois_with_batch_index(sampled.boxes),
                              sampled.mask.reshape(-1))
        loss = softmax_cross_entropy(self.rescore_output(x), sampled.labels.reshape(-1),
                                     sampled.mask.reshape(-1))
        return c.CASCADE_RCNN.RESCORE_LOSS_WEIGHT * loss

    # ---------------- test ----------------

    def _test(self, features, proposals, prop_mask, image_sizes):
        c = self.cfg
        cc = c.CASCADE_RCNN
        nc = c.MODEL.NUM_CLASSES
        B, K = proposals.shape[:2]
        boxes = proposals
        stage_logits = []
        for s in range(self.test_stage):
            cls_logits, box_reg, iou_logits = self._stage(s, features, boxes, prop_mask)
            stage_logits.append(cls_logits)
            box_reg = box_reg.reshape(B, K, -1)
            if s < self.test_stage - 1:
                # each stage pools the boxes the one before it refined
                boxes = self._decode_agnostic(box_reg, boxes, s)
        if cc.TEST_ENSEMBLE:
            cls_logits = sum(stage_logits) / len(stage_logits)
        probs = torch.softmax(cls_logits, dim=-1).reshape(B, K, nc)
        if iou_logits is not None:  # the test stage is the last stage
            iou = iou_logits[:, 1].reshape(B, K, 1)
            probs = probs * iou if cc.IOU_HELPER_MERGE else iou.expand(B, K, nc)
        boxes_pc = decode_boxes_per_class(box_reg, boxes, image_sizes,
                                          self.box_coders[self.test_stage - 1], nc,
                                          c.MODEL.CLS_AGNOSTIC_BBOX_REG)
        dets = filter_detections(boxes_pc, probs, prop_mask, **detection_filter_kwargs(c))
        if self.rescore_on:
            dets = rescore_detections(self.rescore_head, self.rescore_output, features, dets)
        return dets

    def forward(self, features, proposals, prop_mask, image_sizes, gt=None,
                train: bool = False, draws=None):
        """features: NHWC levels [B, H_l, W_l, C], P2..P5 first. Train (gt:
        dict of boxes / labels / mask; draws: the samplers' source of
        uniform draws) returns the loss dict, test `Detections`."""
        features = list(features[: self.num_levels])
        if train:
            return self._train(features, proposals, prop_mask, gt, draws)
        return self._test(features, proposals, prop_mask, image_sizes)
