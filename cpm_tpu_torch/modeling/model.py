"""Generalized R-CNN for the CPM Grid-Cascade configuration.

Port of cpm_tpu/modeling/model.py (`GeneralizedRCNN`, `_normalize_uint8`,
`build_model`) for the path the flagship config takes: ResNet or ResNeXt
trunk (plain or deformable stages) -> FPN (P2..P6) -> RPN ->
GridCascadeRCNNHead. The forward takes the JAX package's
layouts: images `[B, H, W, 3]` (uint8 or float) and image sizes `[B, 2]`
(h, w); the test forward returns fixed-shape `Detections`, the train
forward the dict of losses.

Inside, images become an NCHW view of their NHWC memory (channels_last), so
every convolution stays channels_last and each FPN level's NHWC view
`[B, H, W, C]` is contiguous: the pooler kernel reads it without a copy.
"""

import contextlib

import numpy as np
import torch
from torch import nn

from cpm_tpu_torch.modeling.backbone.resnet import BACKBONES
from cpm_tpu_torch.modeling.fpn import build_fpn
from cpm_tpu_torch.modeling.roi_heads.box_head import Detections
from cpm_tpu_torch.modeling.roi_heads.grid_cascade_head import GridCascadeRCNNHead
from cpm_tpu_torch.modeling.rpn import AnchorLayout, RPNHead, rpn_losses, select_proposals
from cpm_tpu_torch.ops import pooler as pooler_mod
from cpm_tpu_torch.ops.box_coder import BoxCoder
from cpm_tpu_torch.utils.amp import compute_dtype
from cpm_tpu_torch.utils.sampler import Draws


class GeneralizedRCNN(nn.Module):
    """Backbone -> FPN -> RPN -> CPM grid-cascade head."""

    def __init__(self, cfg, generator: torch.Generator = None):
        super().__init__()
        c = cfg
        if not (c.MODEL.FPN_ON and c.MODEL.GRID_ON) or c.MODEL.FASTER_RCNN or c.MODEL.RPN_ONLY:
            raise NotImplementedError("the port runs the FPN grid-cascade family only")
        if c.BACKBONE.CONV_BODY not in BACKBONES:
            raise NotImplementedError(
                f"BACKBONE.CONV_BODY {c.BACKBONE.CONV_BODY}: the port runs {sorted(BACKBONES)}")
        self.cfg = cfg
        self.backbone = BACKBONES[c.BACKBONE.CONV_BODY](c, generator)
        self.fpn = build_fpn(c, self.backbone.dim_out, generator)
        strides = tuple(c.RPN.ANCHOR_STRIDE)
        num_cell_anchors = len(c.RPN.ASPECT_RATIOS) * (
            1 if len(strides) > 1 else len(c.RPN.ANCHOR_SIZES)
        )
        self.rpn_head = RPNHead(c.FPN.DIM, num_cell_anchors, generator)
        self.rpn_box_coder = BoxCoder(weights=(1.0, 1.0, 1.0, 1.0))
        self.roi_head = GridCascadeRCNNHead(c, c.FPN.DIM, generator)
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
        feats = self.fpn(self.backbone(x))
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
            proposals, _, prop_mask = select_proposals(
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
    generator = torch.Generator().manual_seed(seed)
    model = GeneralizedRCNN(cfg, generator)
    return model.to(device=device, memory_format=torch.channels_last)
