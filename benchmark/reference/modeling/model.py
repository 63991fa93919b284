"""Generalized R-CNN: trunk -> FPN -> RPN -> the grid-cascade RoI head.

Port of cpm_tpu/modeling/model.py (`GeneralizedRCNN`, `_normalize_uint8`),
the parts that the benchmark's two configurations build: a ResNet or
ResNeXt trunk (with its deformable convs), the FPN, the RPN and CPM's grid
cascade (`MODEL.GRID_ON`). The forward takes the JAX package's layouts:
images `[B, H, W, 3]` (uint8 or float) and image sizes `[B, 2]` (h, w); the
test forward returns fixed-shape `Detections`, the train forward the dict
of losses.

Inside, images become an NCHW view of their NHWC memory (channels_last), so
every convolution stays channels_last and each FPN level's NHWC view
`[B, H, W, C]` is contiguous.
"""

import contextlib

import numpy as np
import torch
from torch import nn

from benchmark.reference.modeling.backbone.resnet import BACKBONES
from benchmark.reference.modeling.fpn import build_fpn
from benchmark.reference.modeling.roi_heads.grid_cascade_head import GridCascadeRCNNHead
from benchmark.reference.modeling.rpn import AnchorLayout, RPNHead, rpn_losses, select_proposals
from benchmark.reference.ops import pooler as pooler_mod
from benchmark.reference.ops.box_coder import BoxCoder
from benchmark.reference.utils.amp import compute_dtype
from benchmark.reference.utils.sampler import Draws


class GeneralizedRCNN(nn.Module):
    """Backbone -> neck -> RPN -> RoI head family."""

    def __init__(self, cfg, generator: torch.Generator = None):
        super().__init__()
        c = cfg
        if c.BACKBONE.CONV_BODY not in BACKBONES:
            raise NotImplementedError(
                f"BACKBONE.CONV_BODY {c.BACKBONE.CONV_BODY}: the port runs {sorted(BACKBONES)}")
        self.cfg = cfg
        m = c.MODEL
        if not (m.FPN_ON and c.FPN.BODY.lower() == "fpn" and m.GRID_ON and not m.FASTER_RCNN
                and not m.RPN_ONLY):
            raise NotImplementedError("the reference builds the FPN and the grid-cascade head")
        self.backbone = BACKBONES[c.BACKBONE.CONV_BODY](c, generator)
        self.fpn = build_fpn(c, self.backbone.dim_out, generator)
        dim = self.fpn.dim_out
        num_cell_anchors = len(c.RPN.ASPECT_RATIOS)
        self.rpn_head = RPNHead(dim, num_cell_anchors, generator)
        self.rpn_box_coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
        self.roi_head = GridCascadeRCNNHead(c, dim, generator)
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
        with scope:
            return self._forward(images, image_sizes, gt, train, draws)

    def _forward(self, images, image_sizes, gt, train, draws):
        c = self.cfg
        if images.dtype == torch.uint8:
            images = self._normalize_uint8(images)
        else:
            images = images.to(compute_dtype(c))
        x = images.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        feats = self.fpn(self.backbone(x))
        feats = [f.contiguous(memory_format=torch.channels_last) for f in feats]
        objectness, box_reg = self.rpn_head(feats)
        layout = self._anchor_layout(feats)
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
        # the benchmark's replay (benchmark/replay.py): the port's proposals
        replay = getattr(self, "replay", None)
        if replay is not None:
            proposals, prop_mask = replay.proposals(
                proposals, prop_mask, (layout, objectness, box_reg, image_sizes, gt, dict(
                    kw, fpn_post_nms_per_batch=c.RPN.FPN_POST_NMS_PER_BATCH)))
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
        losses.update(self.roi_head(
            levels_nhwc, proposals, prop_mask, image_sizes, gt=gt, train=True, draws=draws,
        ))
        return losses
