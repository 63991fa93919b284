"""CPM Grid-Cascade R-CNN head: the test path.

Port of cpm_tpu/modeling/roi_heads/grid_cascade_head.py
(`GridCascadeRCNNHead._test_cls`, `_test_cascade`, `_test_rescore`):

* cls branch: 7x7 pooling of the RPN proposals, 2 FC, softmax, then the
  fixed-shape multiclass filter (score threshold, NMS, TEST_MAX_DETECTIONS);
* CMM: STAGE_NUM grid stages, each pooling the current boxes at 14x14,
  running its conv tower and grouped deconvs, and decoding refined boxes at
  its mapping ratio;
* ISM: on the last stage, scores become scores * iou (IOU_HELPER_MERGE) or
  the IoU prediction;
* RSM: a second 7x7 cls branch rescoring the refined boxes, fused as
  score^0.8 * rescore^0.2.

The JAX package runs the eval towers in size buckets (EVAL_TOWER_BUCKETS
and `nn.switch`), a TPU shape device. Here the detection set is compacted
once, valid detections first, and each stage's tower runs on the prefix that
holds every valid detection; the valid detections get the same numbers.
Pooling runs over the whole padded set, as in the JAX package: the kernel
writes zeros for masked rois without reading features.
"""

import torch
from torch import nn

from cpm_tpu_torch.modeling.roi_heads.box_head import Detections, filter_detections
from cpm_tpu_torch.modeling.roi_heads.grid_modules import (
    ClsHead,
    ClsOutput,
    GridHead,
    GridOutput,
)
from cpm_tpu_torch.modeling.roi_heads.grid_ops import grid_decode
from cpm_tpu_torch.modeling.roi_heads.targets import (
    compact_by_mask,
    gather_rows,
    rois_with_batch_index,
)


class GridCascadeRCNNHead(nn.Module):
    """CPM head; with one stage and no ISM/RSM it is plain Grid R-CNN."""

    def __init__(self, cfg, in_channels: int, generator: torch.Generator = None):
        super().__init__()
        c = cfg
        g = c.GRID_RCNN
        if g.FUSED_ON and g.OFFSET_ON:
            raise NotImplementedError("OFFSET_ON is not ported")
        if g.ENHANCE_FEATURES or g.EXTEND_ROI or g.FINEST_LEVEL_ROI or g.SE_ON:
            raise NotImplementedError(
                "ENHANCE_FEATURES, EXTEND_ROI, FINEST_LEVEL_ROI and SE_ON are not ported"
            )
        self.cfg = cfg
        cascade_on = bool(g.CASCADE_MAPPING_ON)
        opt = g.CASCADE_MAPPING_OPTION
        self.stage_num = opt.STAGE_NUM if cascade_on else 1
        self.test_stage = opt.TEST_STAGE if cascade_on else 1
        self.mapping_ratios = tuple(opt.STAGE_MAPPING_RATIO) if cascade_on else (1.0,)
        self.grid_nums = tuple(opt.GRID_NUM) if cascade_on else (g.GRID_POINTS,)
        self.num_levels = c.FPN.ROI_MAX_LEVEL - c.FPN.ROI_MIN_LEVEL + 1
        scales = tuple(0.5 ** (c.FPN.ROI_MIN_LEVEL + i) for i in range(self.num_levels))
        mlp = g.MLP_HEAD.MLP_DIM
        gen = generator

        self.cls_head = ClsHead(
            in_channels, tuple(g.ROI_XFORM_RESOLUTION_CLS), scales,
            g.ROI_XFORM_SAMPLING_RATIO, mlp, gen,
        )
        self.cls_output = ClsOutput(mlp, c.MODEL.NUM_CLASSES, gen)
        self.grid_heads = nn.ModuleList()
        self.grid_outputs = nn.ModuleList()
        for s in range(self.stage_num):
            self.grid_heads.append(GridHead(
                in_channels, grid_points=self.grid_nums[s],
                roi_feat_size=g.ROI_FEAT_SIZE, num_convs=g.GRID_HEAD.NUM_CONVS,
                point_feat_channels=g.GRID_HEAD.POINT_FEAT_CHANNELS,
                scales=scales, sampling_ratio=g.ROI_XFORM_SAMPLING_RATIO,
                fused_on=g.FUSED_ON, generator=gen,
            ))
            self.grid_outputs.append(GridOutput(
                grid_points=self.grid_nums[s],
                point_feat_channels=g.GRID_HEAD.POINT_FEAT_CHANNELS,
                roi_feat_size=g.ROI_FEAT_SIZE,
                iou_helper=bool(g.IOU_HELPER and s == self.stage_num - 1),
                fused_on=g.FUSED_ON, generator=gen,
            ))
        self.rescore_on = bool(g.RESCORE_ON)
        if self.rescore_on:
            self.rescore_head = ClsHead(
                in_channels, tuple(g.ROI_XFORM_RESOLUTION_CLS), scales,
                g.ROI_XFORM_SAMPLING_RATIO, mlp, gen,
            )
            self.rescore_output = ClsOutput(mlp, c.MODEL.NUM_CLASSES, gen)

    def _test_cls(self, features, proposals, prop_mask):
        g = self.cfg.GRID_RCNN
        nc = self.cfg.MODEL.NUM_CLASSES
        B, K = proposals.shape[:2]
        x = self.cls_head(features, rois_with_batch_index(proposals), prop_mask.reshape(-1))
        probs = torch.softmax(self.cls_output(x), dim=-1).reshape(B, K, nc)
        # the same box for every class, then ml_nms
        boxes_pc = proposals[:, :, None, :].expand(B, K, nc, 4)
        return filter_detections(
            boxes_pc, probs, prop_mask, score_thresh=g.SCORE_THRESH,
            nms_thresh=g.NMS, detections_per_img=g.TEST_MAX_DETECTIONS,
        )

    def _test_cascade(self, features, dets: Detections, image_sizes):
        g = self.cfg.GRID_RCNN
        B, S = dets.boxes.shape[:2]
        # valid detections first, every field permuted alike; the mask is
        # the same at every stage
        cidx, mask = compact_by_mask(dets.mask, S)
        boxes = gather_rows(dets.boxes, cidx)
        scores = torch.gather(dets.scores, 1, cidx)
        labels = torch.gather(dets.labels, 1, cidx)
        # the tower's roi count: the prefix covering every valid detection
        K = max(int(mask.sum(dim=1).max()), 1)
        sizes_k = image_sizes.repeat_interleave(K, dim=0)
        for stage in range(self.test_stage):
            head, out = self.grid_heads[stage], self.grid_outputs[stage]
            pooled = head.pooler(features, rois_with_batch_index(boxes), mask.reshape(B * S))
            pK = pooled.reshape(B, S, *pooled.shape[1:])[:, :K].reshape(B * K, *pooled.shape[1:])
            x, x_so, _ = head(pooled=pK)
            heatmaps, iou_logits = out(x, x_so, train=False)
            hm = heatmaps["fused"] if g.FUSED_ON else heatmaps["unfused"]
            refined = grid_decode(
                boxes[:, :K].reshape(B * K, 4), hm, sizes_k,
                mapping_ratio=self.mapping_ratios[stage],
                grid_points=self.grid_nums[stage], roi_feat_size=g.ROI_FEAT_SIZE,
            ).reshape(B, K, 4)
            refined = torch.cat([refined, refined.new_zeros(B, S - K, 4)], dim=1)
            # ISM: only the last configured stage has the IoU branch, as in
            # the reference
            if out.iou_helper:
                iou = iou_logits[:, 1].reshape(B, K)
                iou = torch.cat([iou, iou.new_zeros(B, S - K)], dim=1)
                scores = scores * iou if g.IOU_HELPER_MERGE else iou
                scores = torch.where(mask, scores, 0.0)
            boxes = refined
        return Detections(boxes=boxes, scores=scores, labels=labels, mask=mask)

    def _test_rescore(self, features, dets: Detections):
        nc = self.cfg.MODEL.NUM_CLASSES
        B, S = dets.boxes.shape[:2]
        x = self.rescore_head(features, rois_with_batch_index(dets.boxes), dets.mask.reshape(-1))
        probs = torch.softmax(self.rescore_output(x), dim=-1).reshape(B, S, nc)
        rescores = torch.gather(probs, -1, dets.labels.long()[..., None])[..., 0]
        # score^0.8 * rescore^0.2
        fused = torch.clamp(dets.scores, min=0.0) ** 0.8 * torch.clamp(rescores, min=1e-12) ** 0.2
        return dets._replace(scores=torch.where(dets.mask, fused, 0.0))

    def forward(self, features, proposals, prop_mask, image_sizes) -> Detections:
        """features: NHWC RoI levels [B, H_l, W_l, C] (P2..P5 first)."""
        roi_feats = list(features[: self.num_levels])
        dets = self._test_cls(roi_feats, proposals, prop_mask)
        dets = self._test_cascade(roi_feats, dets, image_sizes)
        if self.rescore_on:
            dets = self._test_rescore(roi_feats, dets)
        return dets
