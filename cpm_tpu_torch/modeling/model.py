"""Generalized R-CNN: trunk -> neck -> RPN -> one RoI head family.

Port of cpm_tpu/modeling/model.py (`GeneralizedRCNN`, `FastRCNNHead`,
`_head_scales`, `_head_features`, `_normalize_uint8`, `build_model`):
ResNet or ResNeXt trunk (any of its block, stem, norm, conv and context
options) -> the neck FPN.BODY names (FPN, HRFPN, NAS-FPN or BiFPN, from the
table `NECKS`; the heads take its width) -> RPN -> the head the config
selects (model.py:217-233 there): Fast R-CNN (`MODEL.FASTER_RCNN`),
Cascade R-CNN (with `MODEL.CASCADE_ON`), Grid R-CNN or CPM's grid cascade
(`MODEL.GRID_ON`), or none (`MODEL.RPN_ONLY`: the RPN's losses, and its
proposals as the detections). Without FPN
(`MODEL.FPN_ON` False, the C4 family) the RPN runs on the trunk's last map
alone, one anchor stride, and the Fast R-CNN head pools that map at its one
scale (the C4 heads, roi_heads/c4_heads.py). The forward takes the JAX package's
layouts: images `[B, H, W, 3]` (uint8 or float) and image sizes `[B, 2]`
(h, w); the test forward returns fixed-shape `Detections`, the train
forward the dict of losses.

Inside, images become an NCHW view of their NHWC memory (channels_last), so
every convolution stays channels_last and each FPN level's NHWC view
`[B, H, W, C]` is contiguous: the pooler kernel reads it without a copy (a
level that a GroupNorm left NCHW is made channels_last once).
"""

import contextlib

import numpy as np
import torch
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.modeling.backbone.resnet import BACKBONES
from cpm_tpu_torch.modeling.necks_extra import NECKS
from cpm_tpu_torch.modeling.roi_heads.box_head import (
    BoxOutput,
    Detections,
    build_box_head,
    decode_boxes_per_class,
    detection_filter_kwargs,
    fast_rcnn_losses,
    filter_detections,
)
from cpm_tpu_torch.modeling.roi_heads.cascade_head import CascadeRCNNHead
from cpm_tpu_torch.modeling.roi_heads.grid_cascade_head import GridCascadeRCNNHead
from cpm_tpu_torch.modeling.roi_heads.targets import rois_with_batch_index, subsample_rois
from cpm_tpu_torch.modeling.rpn import AnchorLayout, RPNHead, rpn_losses, select_proposals
from cpm_tpu_torch.ops import pooler as pooler_mod
from cpm_tpu_torch.ops.box_coder import BoxCoder
from cpm_tpu_torch.utils.amp import compute_dtype
from cpm_tpu_torch.utils.sampler import Draws


def _head_scales(cfg):
    """The RoI head's pooling scales: the FPN RoI levels', or without FPN
    the trunk's last map's (1/16 for a `_c4` body, else C5's)."""
    if cfg.MODEL.FPN_ON:
        n = cfg.FPN.ROI_MAX_LEVEL - cfg.FPN.ROI_MIN_LEVEL + 1
        return tuple(0.5 ** (cfg.FPN.ROI_MIN_LEVEL + i) for i in range(n))
    if cfg.BACKBONE.CONV_BODY.endswith("_c4"):
        return (1.0 / 16,)
    return (1.0 / 32 * cfg.BACKBONE.RESNET.C5_DILATION,)


def _head_features(cfg, features):
    """The levels the RoI head pools: the FPN RoI levels, or without FPN
    the trunk's last map."""
    if cfg.MODEL.FPN_ON:
        return list(features[: len(_head_scales(cfg))])
    return list(features[-1:])


class FastRCNNHead(nn.Module):
    """Fast R-CNN RoI family (fast_rcnn/fast_rcnn.py:12-75): one box head
    over the FPN RoI levels (or the C4 map), `BoxOutput`, the sampled-roi
    losses in training, per-class decode and the detection filter at
    test."""

    def __init__(self, cfg, in_channels: int, generator: torch.Generator = None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.head, dim = build_box_head(c, c.FAST_RCNN.ROI_BOX_HEAD, in_channels,
                                        _head_scales(c), generator)
        self.output = BoxOutput(dim, c.MODEL.NUM_CLASSES, c.MODEL.CLS_AGNOSTIC_BBOX_REG, generator)
        self.box_coder = BoxCoder(weights=tuple(c.FAST_RCNN.BBOX_REG_WEIGHTS))

    def forward(self, features, proposals, prop_mask, image_sizes, gt=None,
                train: bool = False, draws=None):
        c = self.cfg
        f = c.FAST_RCNN
        features = _head_features(c, features)
        if train:
            sampled = subsample_rois(
                proposals, prop_mask, gt["boxes"], gt["labels"], gt["mask"],
                draws(prop_mask.shape, prop_mask.device), draws(prop_mask.shape, prop_mask.device),
                batch_size_per_image=f.BATCH_SIZE_PER_IMAGE,
                positive_fraction=f.POSITIVE_FRACTION,
                fg_iou_threshold=f.FG_IOU_THRESHOLD, bg_iou_threshold=f.BG_IOU_THRESHOLD,
                box_coder=self.box_coder,
            )
            mask = sampled.mask.reshape(-1)
            x = self.head(features, rois_with_batch_index(sampled.boxes), mask)
            cls_logits, box_reg = self.output(x)
            loss_cls, loss_box = fast_rcnn_losses(
                cls_logits, box_reg, sampled.labels.reshape(-1), sampled.reg_targets.reshape(-1, 4),
                mask.to(cls_logits.dtype), smooth_l1_beta=f.SMOOTH_L1_BETA,
                cls_agnostic_bbox_reg=c.MODEL.CLS_AGNOSTIC_BBOX_REG,
            )
            return dict(loss_classifier=loss_cls, loss_box_reg=loss_box)

        B, K = proposals.shape[:2]
        nc = c.MODEL.NUM_CLASSES
        x = self.head(features, rois_with_batch_index(proposals), prop_mask.reshape(-1))
        cls_logits, box_reg = self.output(x)
        probs = torch.softmax(cls_logits, dim=-1).reshape(B, K, nc)
        boxes_pc = decode_boxes_per_class(box_reg.reshape(B, K, -1), proposals, image_sizes,
                                          self.box_coder, nc, c.MODEL.CLS_AGNOSTIC_BBOX_REG)
        return filter_detections(boxes_pc, probs, prop_mask, **detection_filter_kwargs(c))


def _roi_head(cfg, in_channels: int, generator):
    """The RoI head family the config selects (cpm_tpu/modeling/model.py:
    217-233), or None under MODEL.RPN_ONLY (the JAX model sets a head up
    there too but never calls it, so it has no parameters)."""
    m = cfg.MODEL
    if m.RPN_ONLY:
        return None
    if not m.FPN_ON and not (m.FASTER_RCNN and not m.CASCADE_ON):
        # the JAX Cascade and grid heads pool the FPN RoI levels whatever
        # FPN_ON says, and a trunk gives them no such levels
        raise NotImplementedError("without FPN the port runs the Fast R-CNN head (the C4 family)")
    if m.FASTER_RCNN:
        family = CascadeRCNNHead if m.CASCADE_ON else FastRCNNHead
        return family(cfg, in_channels, generator)
    if m.GRID_ON:
        return GridCascadeRCNNHead(cfg, in_channels, generator)
    raise ValueError("no RoI head family selected by the config")


class GeneralizedRCNN(nn.Module):
    """Backbone -> neck -> RPN -> RoI head family."""

    def __init__(self, cfg, generator: torch.Generator = None):
        super().__init__()
        c = cfg
        if c.BACKBONE.CONV_BODY not in BACKBONES:
            raise NotImplementedError(
                f"BACKBONE.CONV_BODY {c.BACKBONE.CONV_BODY}: the port runs {sorted(BACKBONES)}")
        self.cfg = cfg
        self.backbone = BACKBONES[c.BACKBONE.CONV_BODY](c, generator)
        if c.MODEL.FPN_ON:
            if c.FPN.BODY not in NECKS:
                raise NotImplementedError(f"FPN.BODY {c.FPN.BODY}: the port runs {sorted(NECKS)}")
            self.fpn = NECKS[c.FPN.BODY](c, self.backbone.dim_out, generator)
            dim = self.fpn.dim_out
        else:
            self.fpn = None
            dim = self.backbone.dim_out[-1]
        strides = tuple(c.RPN.ANCHOR_STRIDE)
        num_cell_anchors = len(c.RPN.ASPECT_RATIOS) * (
            1 if len(strides) > 1 else len(c.RPN.ANCHOR_SIZES)
        )
        self.rpn_head = RPNHead(dim, num_cell_anchors, generator)
        self.rpn_box_coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
        self.roi_head = _roi_head(c, dim, generator)
        self._layouts = {}

    def _anchor_layout(self, feats) -> AnchorLayout:
        c = self.cfg
        strides = tuple(c.RPN.ANCHOR_STRIDE)
        shapes = tuple(tuple(int(d) for d in f.shape[-2:]) for f in feats[: len(strides)])
        if shapes not in self._layouts:
            self._layouts[shapes] = AnchorLayout(
                shapes, strides, tuple(c.RPN.ANCHOR_SIZES), tuple(c.RPN.ASPECT_RATIOS),
                straddle_thresh=c.RPN.STRADDLE_THRESH,
            )
        return self._layouts[shapes]

    def _normalize_uint8(self, images: torch.Tensor) -> torch.Tensor:
        """Per-channel (x*a + b) of raw uint8 pixels on the device, the
        reference's in-model AffineChannel2d normalization. Padded regions
        (zeros) map to -mean/std, as in the JAX package."""
        c = self.cfg
        mean = np.asarray(c.PIXEL_MEANS, np.float32)
        std = np.asarray(c.PIXEL_STDS, np.float32)
        a = 1.0 / std if c.TO_BGR255 else 1.0 / (255.0 * std)
        b = -mean / std
        a = torch.as_tensor(a, device=images.device)
        b = torch.as_tensor(b, device=images.device)
        return (images.float() * a + b).to(compute_dtype(c))

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor, gt=None,
                train: bool = False, draws=None):
        """images [B, H, W, 3] on the model's device; image_sizes [B, 2].

        Test: returns `Detections`. Train: `gt` is a dict of boxes
        [B, G, 4], labels [B, G] and mask [B, G], and `draws` the source of
        the samplers' uniform draws (a `Draws`, a `torch.Generator` or a list
        of arrays consumed in call order); returns the dict of losses.
        TPU.EVAL_POOLER_DTYPE='float32' pins eval pooling to f32; train
        pooling always runs in the compute dtype.
        """
        force_f32 = not train and (
            str(getattr(self.cfg.TPU, "EVAL_POOLER_DTYPE", "compute")) == "float32"
        )
        scope = (
            pooler_mod.pooler_force_f32_scope(True) if force_f32 else contextlib.nullcontext()
        )
        with scope, pooler_mod.one_stack_per_forward():
            return self._forward(images, image_sizes, gt, train, draws)

    def _forward(self, images, image_sizes, gt, train, draws):
        c = self.cfg
        if images.dtype == torch.uint8:
            images = self._normalize_uint8(images)
        else:
            images = images.to(compute_dtype(c))
        x = images.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        feats = self.backbone(x)
        if self.fpn is not None:
            feats = self.fpn(feats)
        # the pooler kernels read each level's NHWC view in place; a level
        # that leaves a GroupNorm or a resize in another layout (CUDA's
        # GroupNorm returns NCHW-contiguous maps) is copied once here
        feats = [f.contiguous(memory_format=torch.channels_last) for f in feats]
        # without FPN, the RPN runs on the last map alone
        rpn_feats = feats if self.fpn is not None else feats[-1:]
        objectness, box_reg = self.rpn_head(rpn_feats)
        layout = self._anchor_layout(rpn_feats)
        which = "TRAIN" if train else "TEST"
        kw = dict(
            pre_nms_top_n=c.RPN[f"PRE_NMS_TOP_N_{which}"],
            post_nms_top_n=c.RPN[f"POST_NMS_TOP_N_{which}"],
            nms_thresh=c.RPN.NMS_THRESH, min_size=c.RPN.MIN_SIZE,
            fpn_post_nms_top_n=c.RPN[f"FPN_POST_NMS_TOP_N_{which}"],
            box_coder=self.rpn_box_coder,
        )
        levels_nhwc = [f.permute(0, 2, 3, 1) for f in feats]
        if not train:
            proposals, scores, prop_mask = select_proposals(
                layout, objectness, box_reg, image_sizes, **kw
            )
            if self.roi_head is None:
                return Detections(boxes=proposals, scores=scores, mask=prop_mask,
                                  labels=torch.zeros(scores.shape, dtype=torch.int32,
                                                     device=scores.device))
            return self.roi_head(levels_nhwc, proposals, prop_mask, image_sizes)

        if gt is None or draws is None:
            raise ValueError("the train forward needs gt and a source of draws")
        if not isinstance(draws, Draws):
            draws = Draws(draws)
        # proposals enter the heads without a gradient
        with torch.no_grad():
            proposals, _, prop_mask = select_proposals(
                layout, objectness, box_reg, image_sizes,
                fpn_post_nms_per_batch=c.RPN.FPN_POST_NMS_PER_BATCH, is_train=True,
                gt_boxes=gt["boxes"], gt_mask=gt["mask"], **kw,
            )
        n_anchors = (image_sizes.shape[0], sum(layout.level_sizes))
        loss_obj, loss_rpn_box = rpn_losses(
            layout, objectness, box_reg, image_sizes, gt["boxes"], gt["mask"],
            draws(n_anchors, image_sizes.device), draws(n_anchors, image_sizes.device),
            fg_iou_threshold=c.RPN.FG_IOU_THRESHOLD,
            bg_iou_threshold=c.RPN.BG_IOU_THRESHOLD,
            batch_size_per_image=c.RPN.BATCH_SIZE_PER_IMAGE,
            positive_fraction=c.RPN.POSITIVE_FRACTION,
            smooth_l1_beta=c.RPN.SMOOTH_L1_BETA, box_coder=self.rpn_box_coder,
        )
        losses = dict(loss_objectness=loss_obj, loss_rpn_box_reg=loss_rpn_box)
        if self.roi_head is None:
            return losses
        losses.update(self.roi_head(
            levels_nhwc, proposals, prop_mask, image_sizes, gt=gt, train=True, draws=draws,
        ))
        return losses


def build_model(cfg, device, seed: int = 0) -> GeneralizedRCNN:
    """The model for `cfg` on `device`, fresh weights drawn from `seed`.

    Parameters are created in f32 and in channels_last memory, and stay
    f32: the train step and make_forward_fn run the model on casts of them
    to the compute dtype. The flagship has no batch statistics and no
    dropout (frozen-BN affines in the trunk, GroupNorm in the towers), so
    train and eval modes compute the same layers; the `train` argument of
    the forward picks the branch.
    """
    # TPU.POOLER_KERNEL selects the pooling formulation and with it the
    # CUDA kernels that run it (ops/pooler.py); an unknown name raises
    pooler_mod.set_pooler_backend(getattr(cfg.TPU, "POOLER_KERNEL", "auto"))
    # MODEL.INIT_SCHEME rides on the generator that every module draws from;
    # an unknown scheme raises
    scheme = getattr(cfg.MODEL, "INIT_SCHEME", "reference")
    generator = init.SchemeGenerator(scheme).manual_seed(seed)
    model = GeneralizedRCNN(cfg, generator)
    return model.to(device=device, memory_format=torch.channels_last)
