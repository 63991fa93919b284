"""CPM Grid-Cascade R-CNN head: the train and test paths.

Port of cpm_tpu/modeling/roi_heads/grid_cascade_head.py
(`GridCascadeRCNNHead`: `_train_cls`, `_stage_match`, `_train_cascade`,
`_train_rescore`, `_test_cls`, `_test_cascade`; `_test_rescore` is
grid_modules.py::rescore_detections, which the Cascade head shares):

* cls branch: 7x7 pooling of the RPN proposals, 2 FC, softmax, then the
  fixed-shape multiclass filter (score threshold, NMS, TEST_MAX_DETECTIONS);
* CMM: STAGE_NUM grid stages, each pooling the current boxes at 14x14,
  running its conv tower and grouped deconvs, and decoding refined boxes at
  its mapping ratio;
* ISM: on the last stage, scores become scores * iou (IOU_HELPER_MERGE) or
  the IoU prediction;
* RSM: a second 7x7 cls branch rescoring the refined boxes, fused as
  score^0.8 * rescore^0.2.

Training: the cls branch samples BATCH_SIZE_PER_IMAGE rois and takes the
cross entropy; the cascade takes up to MAX_SAMPLE_NUM_GRID of its positives
through the stages (per-stage matching at rising IoU thresholds, heatmap
BCE x LOSS_WEIGHT x stage weight, ISM L2 on the last stage, boxes refined
under no gradient, gt-identical rows dropped and gt re-added between
stages); the RSM head is trained on the cls negatives plus the refined
boxes.

Options (each at its site in the JAX head): ENHANCE_FEATURES mixes the FPN
levels, P6 included, for the grid stages alone (the cls and RSM branches
pool the RoI levels as they are); RANDOM_JITTER jitters the cls sample
before the grid cap; BETTER_ROI clears rois whose centre is far from their
gt's; EXTEND_ROI doubles the boxes after matching in training and before
each stage's pooling in eval; FINEST_LEVEL_ROI pools the stages from P2
alone; CASCADE_MAPPING_OPTION.RESIZE_ROI shrinks large refined boxes
between stages; RESCORE_OPTION.KEEP_RATIO caps the RSM's negatives at three
times the grid positives by a random rank. Their uniform draws come from
`draws` in the JAX package's order: the jitter's before the grid cap's, the
keep ratio's before the RSM sample's.

The JAX package runs the towers in size buckets (TOWER_BUCKETS /
EVAL_TOWER_BUCKETS with `nn.switch` and `nn.remat`), a TPU shape device. Here
the roi set is compacted, valid rois first, and each stage's targets, tower,
outputs, losses and decode run on a prefix that holds every valid roi; the
valid rois get the same numbers and the masked losses are the same. In
training the prefix is rounded up to the caps of TPU.TOWER_BUCKETS, so that
cuDNN sees few shapes. Pooling runs over the whole padded set, as in the
JAX package: the kernel writes zeros for masked rois without reading
features.
"""

import torch
from torch import nn

from cpm_tpu_torch.modeling.roi_heads.box_head import Detections, filter_detections
from cpm_tpu_torch.modeling.roi_heads.grid_modules import (
    ClsHead,
    ClsOutput,
    GridHead,
    GridOutput,
    rescore_detections,
)
from cpm_tpu_torch.modeling.roi_heads.grid_ops import (
    better_roi_mask,
    enhance_features,
    extend_rois,
    grid_decode,
    grid_targets,
    random_jitter_boxes,
    resize_large_rois,
)
from cpm_tpu_torch.modeling.roi_heads.targets import (
    compact_by_mask,
    gather_rows,
    match_to_gt,
    rois_with_batch_index,
    subsample_rois,
)
from cpm_tpu_torch.ops.box_coder import BoxCoder
from cpm_tpu_torch.ops.losses import (
    bce_with_logits_elementwise,
    global_count,
    ism_l2_loss,
    softmax_cross_entropy,
)
from cpm_tpu_torch.utils.sampler import sample_k_from_mask
from cpm_tpu_torch.utils.spans import span, sync


def _masked_bce_means(logits, targets, roi_mask):
    """BCE-with-logits of each of `logits` (a list of like tensors), each a
    mean over the valid rois' elements of the global batch (every rank's):
    one count for all."""
    bces = [bce_with_logits_elementwise(x, targets) for x in logits]
    m = roi_mask.reshape(roi_mask.shape + (1,) * (bces[0].dim() - 1)).to(bces[0].dtype)
    denom = global_count(m.sum() * bces[0][0].numel())
    return [(bce * m).sum() / denom for bce in bces]


class GridCascadeRCNNHead(nn.Module):
    """CPM head; with one stage and no ISM/RSM it is plain Grid R-CNN."""

    def __init__(self, cfg, in_channels: int, generator: torch.Generator = None):
        super().__init__()
        c = cfg
        g = c.GRID_RCNN
        self.cfg = cfg
        cascade_on = bool(g.CASCADE_MAPPING_ON)
        opt = g.CASCADE_MAPPING_OPTION
        self.stage_num = opt.STAGE_NUM if cascade_on else 1
        self.resize_roi = bool(cascade_on and opt.RESIZE_ROI)
        self.keep_ratio = bool(g.RESCORE_ON and g.RESCORE_OPTION.KEEP_RATIO)
        self.test_stage = opt.TEST_STAGE if cascade_on else 1
        self.stage_weights = tuple(opt.STAGE_WEIGHTS) if cascade_on else (1.0,)
        self.fg_thresholds = tuple(opt.FG_IOU_THRESHOLD) if cascade_on else (g.FG_IOU_THRESHOLD,)
        self.bg_thresholds = tuple(opt.BG_IOU_THRESHOLD) if cascade_on else (g.BG_IOU_THRESHOLD,)
        self.box_coder = BoxCoder(weights=(10.0, 10.0, 5.0, 5.0))
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
                fused_on=g.FUSED_ON, finest_level_only=g.FINEST_LEVEL_ROI,
                offset_on=g.OFFSET_ON, generator=gen,
            ))
            self.grid_outputs.append(GridOutput(
                grid_points=self.grid_nums[s],
                point_feat_channels=g.GRID_HEAD.POINT_FEAT_CHANNELS,
                roi_feat_size=g.ROI_FEAT_SIZE,
                iou_helper=bool(g.IOU_HELPER and s == self.stage_num - 1),
                fused_on=g.FUSED_ON, se_on=g.SE_ON, offset_on=g.OFFSET_ON, generator=gen,
            ))
        self.rescore_on = bool(g.RESCORE_ON)
        if self.rescore_on:
            self.rescore_head = ClsHead(
                in_channels, tuple(g.ROI_XFORM_RESOLUTION_CLS), scales,
                g.ROI_XFORM_SAMPLING_RATIO, mlp, gen,
            )
            self.rescore_output = ClsOutput(mlp, c.MODEL.NUM_CLASSES, gen)

    # ---------------- train ----------------

    def _subsample(self, boxes, mask, gt, draws):
        g = self.cfg.GRID_RCNN
        return subsample_rois(
            boxes, mask, gt["boxes"], gt["labels"], gt["mask"],
            draws(mask.shape, mask.device), draws(mask.shape, mask.device),
            batch_size_per_image=g.BATCH_SIZE_PER_IMAGE,
            positive_fraction=g.POSITIVE_FRACTION,
            fg_iou_threshold=g.FG_IOU_THRESHOLD,
            bg_iou_threshold=g.BG_IOU_THRESHOLD,
            box_coder=self.box_coder,
        )

    def _train_cls(self, features, proposals, prop_mask, gt, draws):
        sampled = self._subsample(proposals, prop_mask, gt, draws)
        x = self.cls_head(features, rois_with_batch_index(sampled.boxes), sampled.mask.reshape(-1))
        loss = softmax_cross_entropy(
            self.cls_output(x), sampled.labels.reshape(-1), sampled.mask.reshape(-1)
        )
        return sampled, dict(loss_classifier=loss)

    def _tower_size(self, stage_mask, S: int) -> int:
        """The prefix length the stage's tower runs on: the largest per-image
        valid count (read on the host), rounded up to a cap of
        TPU.TOWER_BUCKETS or to S. Under data parallelism it is this rank's
        maximum: it only sets how much padding the tower runs on, and the
        valid rois' numbers and the masked losses do not depend on it."""
        with sync("tower_size"):
            n_max = int(stage_mask.sum(dim=1).max())
        caps = [k for k in getattr(self.cfg.TPU, "TOWER_BUCKETS", ()) if k < S] + [S]
        return next(k for k in caps if n_max <= k)

    def _train_cascade(self, features, sampled, gt, image_sizes, draws):
        g = self.cfg.GRID_RCNN
        losses = {}
        # stage-0 input: at most MAX_SAMPLE_NUM_GRID positives of the cls sample
        boxes = sampled.boxes
        if g.RANDOM_JITTER:
            u = draws(boxes.shape[:-1] + (4,), boxes.device)
            boxes = random_jitter_boxes(boxes, u, image_sizes[:, None, :])
        pos = sampled.is_pos
        capped = sample_k_from_mask(pos, g.MAX_SAMPLE_NUM_GRID, draws(pos.shape, pos.device))
        idx, mask = compact_by_mask(capped, g.MAX_SAMPLE_NUM_GRID)
        boxes = gather_rows(boxes, idx)

        for stage in range(self.stage_num):
            with span(f"cpm/head/stage{stage + 1}"):
                matches, matched_gt, matched_iou = match_to_gt(
                    boxes, gt["boxes"], gt["mask"],
                    self.fg_thresholds[stage], self.bg_thresholds[stage],
                )
                # stage 0 keeps the whole (positive-capped) set
                stage_mask = mask if stage == 0 else (matches >= 0) & mask
                if g.BETTER_ROI:
                    stage_mask = stage_mask & better_roi_mask(boxes, matched_gt, g.BETTER_ROI_RATIO)
                if g.EXTEND_ROI:
                    # after matching, before targets, pooling and decode
                    boxes = extend_rois(boxes, image_sizes[:, None, :])
                B, S = boxes.shape[:2]
                # valid rois first (BETTER_ROI may clear bits inside the prefix);
                # the loop-carried (boxes, mask) pair stays aligned, since the
                # RSM union below indexes boxes by mask bits
                cidx, stage_mask = compact_by_mask(stage_mask, S)
                boxes = gather_rows(boxes, cidx)
                matched_gt = gather_rows(matched_gt, cidx)
                matched_iou = torch.gather(matched_iou, 1, cidx)
                mask = torch.gather(mask, 1, cidx)

                head, out = self.grid_heads[stage], self.grid_outputs[stage]
                pooled = head.pool(features, rois_with_batch_index(boxes),
                                   stage_mask.reshape(B * S))
                K = self._tower_size(stage_mask, S)
                bK = boxes[:, :K].reshape(B * K, 4)
                mK = stage_mask[:, :K].reshape(B * K)
                roi_shape = pooled.shape[1:]
                pK = pooled.reshape(B, S, *roi_shape)[:, :K].reshape(B * K, *roi_shape)
                tK = grid_targets(
                    bK, matched_gt[:, :K].reshape(B * K, 4), mK,
                    mapping_ratio=self.mapping_ratios[stage], grid_points=self.grid_nums[stage],
                    roi_feat_size=g.ROI_FEAT_SIZE, pos_radius=g.POS_RADIUS,
                    target_refine=g.TARGET_REFINE,
                )
                x, x_so, x_off = head(pooled=pK)
                heatmaps, iou_logits = out(x, x_so, x_off, train=True)
                fused = heatmaps["fused"] is not None and (g.FUSED_ON or g.OFFSET_ON)
                loss_grid, *loss_fused = _masked_bce_means(
                    [heatmaps["unfused"]] + ([heatmaps["fused"]] if fused else []), tK, mK)
                for loss in loss_fused:
                    loss_grid = loss_grid + loss
                losses[f"loss_grid_{stage + 1}"] = (
                    g.LOSS_WEIGHT * self.stage_weights[stage] * loss_grid)

                last = stage == self.stage_num - 1
                if g.IOU_HELPER and last:
                    iou_K = matched_iou[:, :K].reshape(B * K)
                    iou_t = torch.stack([1.0 - iou_K, iou_K], dim=-1)
                    losses[f"loss_iou_{stage + 1}"] = (
                        g.IOU_LOSS_WEIGHT * ism_l2_loss(iou_logits, iou_t, mK))
                if not last:
                    # refined boxes carry no gradient
                    hm = (heatmaps["fused"] if g.FUSED_ON else heatmaps["unfused"]).detach()
                    refined = grid_decode(
                        bK, hm, image_sizes.repeat_interleave(K, dim=0),
                        mapping_ratio=self.mapping_ratios[stage],
                        grid_points=self.grid_nums[stage], roi_feat_size=g.ROI_FEAT_SIZE,
                    ).reshape(B, K, 4)
                    refined = torch.cat([refined, refined.new_zeros(B, S - K, 4)], dim=1)
                    if self.resize_roi:
                        refined = resize_large_rois(refined)
                    # drop rows equal to a gt box, then re-add the gt boxes
                    same = (boxes[:, :, None, :] - gt["boxes"][:, None, :, :]).abs() < 1e-5
                    eq_gt = (same.all(dim=-1) & gt["mask"][:, None, :]).any(dim=-1)
                    boxes = torch.cat([refined, gt["boxes"]], dim=1)
                    mask = torch.cat([stage_mask & ~eq_gt, gt["mask"]], dim=1)
        return boxes, mask, losses

    def _train_rescore(self, features, cls_sampled, grid_boxes, grid_mask, gt, draws):
        g = self.cfg.GRID_RCNN
        # the negatives of the cls sample plus the grid-refined boxes
        neg_mask = cls_sampled.mask & (cls_sampled.labels == 0)
        if self.keep_ratio:
            # at most 3x the grid positives of the negatives, by a random
            # rank (a stable sort, as jnp.argsort)
            u = draws(neg_mask.shape, neg_mask.device)
            n_pos = grid_mask.sum(dim=1, keepdim=True)
            neg_mask = sample_k_from_mask(neg_mask, 3 * n_pos[:, 0], u)
        union_boxes = torch.cat([cls_sampled.boxes, grid_boxes], dim=1)
        union_mask = torch.cat([neg_mask, grid_mask], dim=1)
        sampled = self._subsample(union_boxes, union_mask, gt, draws)
        x = self.rescore_head(features, rois_with_batch_index(sampled.boxes), sampled.mask.reshape(-1))
        loss = softmax_cross_entropy(
            self.rescore_output(x), sampled.labels.reshape(-1), sampled.mask.reshape(-1)
        )
        return dict(loss_rescore=g.RESCORE_LOSS_WEIGHT * loss)

    def _train(self, roi_feats, grid_feats, proposals, prop_mask, image_sizes, gt, draws):
        with span("cpm/head/cls"):
            sampled, losses = self._train_cls(roi_feats, proposals, prop_mask, gt, draws)
        grid_boxes, grid_mask, grid_losses = self._train_cascade(
            grid_feats, sampled, gt, image_sizes, draws
        )
        losses.update(grid_losses)
        if self.rescore_on:
            with span("cpm/head/rescore"):
                losses.update(
                    self._train_rescore(roi_feats, sampled, grid_boxes, grid_mask, gt, draws)
                )
        return losses

    # ---------------- test ----------------

    def _test_cls(self, features, proposals, prop_mask):
        g = self.cfg.GRID_RCNN
        nc = self.cfg.MODEL.NUM_CLASSES
        B, K = proposals.shape[:2]
        x = self.cls_head(features, rois_with_batch_index(proposals), prop_mask.reshape(-1))
        probs = torch.softmax(self.cls_output(x), dim=-1).reshape(B, K, nc)
        # the same box for every class, then ml_nms
        boxes_pc = proposals[:, :, None, :].expand(B, K, nc, 4)
        with span("cpm/head/filter"):
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
        with sync("tower_size"):
            K = max(int(mask.sum(dim=1).max()), 1)
        sizes_k = image_sizes.repeat_interleave(K, dim=0)
        for stage in range(self.test_stage):
            with span(f"cpm/head/stage{stage + 1}"):
                if g.EXTEND_ROI:
                    # before pooling; the decode below reads the extended boxes
                    boxes = extend_rois(boxes, image_sizes[:, None, :])
                head, out = self.grid_heads[stage], self.grid_outputs[stage]
                pooled = head.pool(features, rois_with_batch_index(boxes), mask.reshape(B * S))
                roi_shape = pooled.shape[1:]
                pK = pooled.reshape(B, S, *roi_shape)[:, :K].reshape(B * K, *roi_shape)
                x, x_so, x_off = head(pooled=pK)
                heatmaps, iou_logits = out(x, x_so, x_off, train=False)
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

    def forward(self, features, proposals, prop_mask, image_sizes, gt=None,
                train: bool = False, draws=None):
        """features: NHWC FPN levels [B, H_l, W_l, C] (P2 first; the RoI
        levels and, for ENHANCE_FEATURES, P6 after them). Train (gt: dict of
        boxes / labels / mask; draws: the sampler's source of uniform draws)
        returns the loss dict, test `Detections`."""
        roi_feats = list(features[: self.num_levels])
        # the grid stages' levels; the cls and RSM branches pool roi_feats
        grid_feats = (enhance_features(features) if self.cfg.GRID_RCNN.ENHANCE_FEATURES
                      else roi_feats)
        if train:
            return self._train(roi_feats, grid_feats, proposals, prop_mask, image_sizes, gt, draws)
        with span("cpm/head/cls"):
            dets = self._test_cls(roi_feats, proposals, prop_mask)
        dets = self._test_cascade(grid_feats, dets, image_sizes)
        if self.rescore_on:
            with span("cpm/head/rescore"):
                dets = rescore_detections(self.rescore_head, self.rescore_output, roi_feats, dets)
        return dets
