"""The Fast R-CNN box head family: feature extractors, output layer, loss,
per-class decode and the fixed-shape multiclass detection filter.

Port of cpm_tpu/modeling/roi_heads/box_head.py (`TwoMLPHead`,
`ConvFCHead`, `BoxOutput`, `fast_rcnn_losses`, `Detections`,
`decode_boxes_per_class`, `filter_detections`); `build_box_head` also
builds the C4 heads of roi_heads/c4_heads.py. The filter, per image:
threshold the foreground class scores, gather the top `pre_nms_candidates`
candidates, then the reference's filter_results (`ops/nms.py::
filter_results`, which the TTA merge also runs): label-aware hard NMS or
soft-NMS, then optionally box voting, into `detections_per_img` slots.

Pooled features enter the heads NHWC `[R, ph, pw, C]`, and every flatten is
in (h, w, c) order, as in the JAX package, so a bridged fc weight reads the
same rows.
"""

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init
from cpm_tpu_torch.modeling.backbone.resnet import check_options
from cpm_tpu_torch.modeling.roi_heads.c4_heads import ResNet2MLPHead, ResNetC5Head
from cpm_tpu_torch.modeling.roi_heads.grid_modules import ClsHead
from cpm_tpu_torch.modeling.roi_heads.targets import gather_rows
from cpm_tpu_torch.modeling.ws import maybe_ws
from cpm_tpu_torch.ops.box_coder import BoxCoder
from cpm_tpu_torch.ops.losses import global_count, smooth_l1_loss, softmax_cross_entropy
from cpm_tpu_torch.ops.nms import filter_results, topk
from cpm_tpu_torch.ops.pooler import Pooler
from cpm_tpu_torch.structures.boxes import clip_boxes_to_image

# RoIAlign -> flatten -> fc6 -> fc7 (mlp_heads.py:13-48): the same module as
# the grid head's cls branch, which the JAX package keeps as a second class
TwoMLPHead = ClsHead


class ConvFCHead(nn.Module):
    """RoIAlign -> N 3x3 convs with ReLU -> flatten -> fc (convfc_heads.py).
    The convs run NCHW on channels_last memory; the block is flattened NHWC."""

    def __init__(
        self,
        in_channels: int,
        resolution: Sequence[int] = (7, 7),
        scales: Sequence[float] = (0.25, 0.125, 0.0625, 0.03125),
        sampling_ratio: int = 0,
        conv_dim: int = 256,
        num_stacked_convs: int = 4,
        mlp_dim: int = 1024,
        dilation: int = 1,
        generator: torch.Generator = None,
    ):
        super().__init__()
        self.pooler = Pooler(tuple(resolution), scales, sampling_ratio)
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels if i == 0 else conv_dim, conv_dim, 3,
                      padding=dilation, dilation=dilation)
            for i in range(num_stacked_convs)
        )
        for conv in self.convs:
            init.tower_conv(conv.weight, generator)
            nn.init.zeros_(conv.bias)
        c = conv_dim if num_stacked_convs else in_channels
        self.fc = nn.Linear(resolution[0] * resolution[1] * c, mlp_dim)
        init.mlp_fc(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, features, rois, roi_mask=None):
        x = self.pooler(features, rois, roi_mask).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.fc(x))


class BoxOutput(nn.Module):
    """Linear cls (C) and box deltas (4C, or 8 if class-agnostic); both
    upcast to f32, since decode and losses are precision-sensitive. A 4-D
    NHWC input (`resnet_c5_head`'s block) is average-pooled over h and w
    first."""

    def __init__(self, in_features: int, num_classes: int, cls_agnostic_bbox_reg: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes)
        self.bbox_pred = nn.Linear(in_features, 8 if cls_agnostic_bbox_reg else 4 * num_classes)
        init.normal_(self.cls_score.weight, 0.01, generator)
        init.normal_(self.bbox_pred.weight, 0.001, generator)
        nn.init.zeros_(self.cls_score.bias)
        nn.init.zeros_(self.bbox_pred.bias)

    def forward(self, x):
        if x.dim() == 4:
            x = x.mean(dim=(1, 2))
        return self.cls_score(x).float(), self.bbox_pred(x).float()


def build_box_head(cfg, name: str, in_channels: int, scales, generator=None,
                   sized_by_cfg: bool = True):
    """(the feature extractor FAST_RCNN / CASCADE_RCNN.ROI_BOX_HEAD names,
    over the levels of `scales`; its output width). Its widths are
    FAST_RCNN.MLP_HEAD's / CONVFC_HEAD's, or with `sized_by_cfg` False the
    modules' defaults (1024-wide fcs, four 256-wide convs), which the JAX
    package's Cascade head uses whatever those keys say. The C4 heads
    (roi_heads/c4_heads.py) take stage 5's options from BACKBONE.RESNET."""
    f = cfg.FAST_RCNN
    kw = dict(resolution=tuple(f.ROI_XFORM_RESOLUTION), scales=scales,
              sampling_ratio=f.ROI_XFORM_SAMPLING_RATIO, generator=generator)
    if name in ("resnet_c5_head", "resnet_2mlp_head"):
        r = cfg.BACKBONE.RESNET
        check_options(r, "ResNet stage-5")
        if name == "resnet_c5_head":
            head = ResNetC5Head(cfg, in_channels, **kw)
        else:
            head = ResNet2MLPHead(cfg, in_channels, mlp_dim=f.MLP_HEAD.MLP_DIM, **kw)
        return maybe_ws(head, r.USE_WS), head.dim_out
    if name == "roi_2mlp_head":
        mlp_dim = f.MLP_HEAD.MLP_DIM if sized_by_cfg else 1024
        return TwoMLPHead(in_channels, mlp_dim=mlp_dim, **kw), mlp_dim
    if name == "roi_xconv1fc_head":
        h = f.CONVFC_HEAD
        if sized_by_cfg:
            kw.update(conv_dim=h.CONV_DIM, num_stacked_convs=h.NUM_STACKED_CONVS,
                      mlp_dim=h.MLP_DIM, dilation=h.DILATION)
        head = ConvFCHead(in_channels, **kw)
        # USE_WS standardises the stacked convs, in the Cascade's heads too
        return maybe_ws(head, h.USE_WS), head.fc.out_features
    raise ValueError(f"unknown ROI_BOX_HEAD {name}")


def fast_rcnn_losses(class_logits, box_regression, labels, reg_targets, sample_mask, *,
                     smooth_l1_beta: float = 1.0, cls_agnostic_bbox_reg: bool = False):
    """(loss_classifier, loss_box_reg) (loss.py:119-166).

    class_logits [N, C]; box_regression [N, 4C or 8]; labels [N] (0 = bg);
    reg_targets [N, 4]; sample_mask [N] selects the sampled rois. CE is a
    mean over them; smooth-L1 is summed over the positives' own class
    columns (columns 4:8 if class-agnostic) over the sampled count, the
    global batch's (every rank's)."""
    n_sampled = global_count(sample_mask.float().sum())
    loss_cls = softmax_cross_entropy(class_logits, labels, sample_mask.bool(), n_sampled)
    pos = sample_mask.to(class_logits.dtype) * (labels > 0).to(class_logits.dtype)
    if cls_agnostic_bbox_reg:
        pred = box_regression[:, 4:8]
    else:
        col = 4 * torch.clamp(labels.long(), min=0)[:, None] + torch.arange(4, device=labels.device)
        pred = torch.gather(box_regression, 1, col)
    loss_box = smooth_l1_loss(pred, reg_targets, beta=smooth_l1_beta, weights=pos[:, None],
                              normalizer=n_sampled)
    return loss_cls, loss_box


class Detections(NamedTuple):
    boxes: torch.Tensor   # [B, D, 4] xyxy
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int32, 1-based classes
    mask: torch.Tensor    # [B, D] bool


def decode_boxes_per_class(box_regression, proposals, image_sizes, box_coder: BoxCoder,
                           num_classes: int, cls_agnostic_bbox_reg: bool = False):
    """[B, K, 4C] deltas (or 8) and [B, K, 4] proposals -> [B, K, C, 4],
    clipped to the images (image_sizes [B, 2] as (h, w))."""
    if cls_agnostic_bbox_reg:
        decoded = box_coder.decode(box_regression[..., 4:8], proposals).repeat(1, 1, num_classes)
    else:
        decoded = box_coder.decode(box_regression, proposals)
    B, K = decoded.shape[:2]
    decoded = decoded.reshape(B, K, num_classes, 4)
    return clip_boxes_to_image(
        decoded, (image_sizes[:, None, None, 1].to(decoded.dtype),
                  image_sizes[:, None, None, 0].to(decoded.dtype)))


def detection_filter_kwargs(cfg) -> dict:
    """The filter's settings for a final detection set: FAST_RCNN's
    thresholds and TEST's soft-NMS and box voting, which the Fast R-CNN and
    Cascade heads and the TTA merge all read."""
    f, t = cfg.FAST_RCNN, cfg.TEST
    return dict(
        score_thresh=f.SCORE_THRESH, nms_thresh=f.NMS, detections_per_img=f.DETECTIONS_PER_IMG,
        use_soft_nms=t.SOFT_NMS.ENABLED, soft_nms_sigma=t.SOFT_NMS.SIGMA,
        soft_nms_method=t.SOFT_NMS.METHOD, use_box_voting=t.BBOX_VOTE.ENABLED,
        vote_thresh=t.BBOX_VOTE.VOTE_TH, vote_scoring_method=t.BBOX_VOTE.SCORING_METHOD,
        vote_beta=t.BBOX_VOTE.SCORING_METHOD_BETA,
    )


def filter_detections(
    boxes_per_class: torch.Tensor,
    scores: torch.Tensor,
    prop_mask: torch.Tensor,
    *,
    score_thresh: float,
    nms_thresh: float,
    detections_per_img: int,
    pre_nms_candidates: int = 1024,
    **nms_kw,
) -> Detections:
    """boxes_per_class [B, K, C, 4]; scores [B, K, C] softmax probabilities
    (class 0 is background and skipped); prop_mask [B, K]. `nms_kw` are
    filter_results' soft-NMS and voting options."""
    B, K, C = scores.shape
    cand_scores = scores[:, :, 1:].reshape(B, K * (C - 1))
    cand_boxes = boxes_per_class[:, :, 1:, :].reshape(B, K * (C - 1), 4)
    cand_labels = torch.arange(1, C, dtype=torch.int32, device=scores.device)
    cand_labels = cand_labels.expand(B, K, C - 1).reshape(B, K * (C - 1))
    cand_valid = (cand_scores > score_thresh) & prop_mask.repeat_interleave(C - 1, dim=1)

    M = min(pre_nms_candidates, cand_scores.shape[1])
    masked = torch.where(cand_valid, cand_scores, torch.finfo(cand_scores.dtype).min)
    top_scores, top_idx = topk(masked, M)
    top_boxes = gather_rows(cand_boxes, top_idx)
    top_labels = torch.gather(cand_labels, 1, top_idx)
    top_valid = torch.gather(cand_valid, 1, top_idx)
    top_scores = torch.where(top_valid, top_scores, 0.0)

    boxes, out_scores, labels, keep = filter_results(
        top_boxes, top_scores, top_labels, top_valid, score_thresh=score_thresh,
        nms_thresh=nms_thresh, detections_per_img=detections_per_img, **nms_kw)
    return Detections(boxes=boxes, scores=torch.where(keep, out_scores, 0.0), labels=labels,
                      mask=keep)
