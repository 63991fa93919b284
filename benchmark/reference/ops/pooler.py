"""Multi-level FPN RoI pooling.

Port of cpm_tpu/ops/pooler.py. Level assignment is the Detectron rule
`k = floor(k0 + log2(sqrt(area)/s0 + eps))` clamped to [k_min, k_max],
with the degenerate-box clamp. Every pooling backend of the port computes
the same samples; the reference pools them through the plain multilevel
formulation (`ops/roi_align.py`), and a pooler over one level through its
one-level case.
"""

import contextlib
import contextvars
import math
from typing import Sequence

import torch

from benchmark.reference.ops.roi_align import multilevel_roi_align, roi_align
from benchmark.reference.structures.boxes import box_area

# When True (scoped by GeneralizedRCNN.forward under
# TPU.EVAL_POOLER_DTYPE='float32'), pooling runs in f32 whatever the
# feature dtype and casts back. A ContextVar, so that a forward on another
# thread sees its own setting.
_FORCE_F32 = contextvars.ContextVar("cpm_torch_pooler_force_f32", default=False)


@contextlib.contextmanager
def pooler_force_f32_scope(flag: bool):
    """Pin (or unpin) f32 pooling within the scope."""
    token = _FORCE_F32.set(bool(flag))
    try:
        yield
    finally:
        _FORCE_F32.reset(token)


def assign_fpn_levels(
    boxes: torch.Tensor,
    k_min: int,
    k_max: int,
    canonical_scale: int = 224,
    canonical_level: int = 4,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Per-roi FPN level in [k_min, k_max] (int32) for xyxy boxes [..., 4].

    Degenerate boxes (x2 < x1, e.g. from grid decode of untrained heatmaps)
    have a negative plus-one area; the clamp pins them to k_min instead of
    taking the square root of a negative number.
    """
    scale = torch.sqrt(torch.clamp(box_area(boxes, legacy_plus1=True), min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(scale / canonical_scale + eps))
    return torch.clamp(lvl, k_min, k_max).to(torch.int32)


class Pooler:
    """RoIAlign across FPN levels with on-device level selection.

    Args:
      output_size: (ph, pw).
      scales: per-level spatial scales, e.g. (1/4, 1/8, 1/16, 1/32).
      sampling_ratio: samples per bin per axis; 0 means a static 2.
    """

    def __init__(
        self,
        output_size,
        scales: Sequence[float],
        sampling_ratio: int = 0,
        canonical_scale: int = 224,
        canonical_level: int = 4,
    ):
        self.output_size = tuple(output_size)
        self.scales = tuple(scales)
        self.sampling_ratio = sampling_ratio
        self.k_min = int(-math.log2(self.scales[0]))
        self.k_max = int(-math.log2(self.scales[-1]))
        self.canonical_scale = canonical_scale
        self.canonical_level = canonical_level

    def __call__(
        self,
        features: Sequence[torch.Tensor],
        rois: torch.Tensor,
        roi_mask: torch.Tensor = None,
    ) -> torch.Tensor:
        """Pool per-roi features.

        Args:
          features: list of [B, H_l, W_l, C], finest first (P2..P5).
          rois: [R, 5] (batch_index, x1, y1, x2, y2).
          roi_mask: [R] validity; invalid rois produce zeros.

        Returns: [R, ph, pw, C] in the feature dtype.
        """
        if len(features) != len(self.scales):
            raise ValueError(f"{len(features)} levels for {len(self.scales)} scales")
        out_dtype = features[0].dtype
        if _FORCE_F32.get() and out_dtype != torch.float32:
            # f32 accumulation and output; the caller gets its dtype back
            features = [f.float() for f in features]
            return self(features, rois, roi_mask).to(out_dtype)
        rois = rois.float().contiguous()
        if roi_mask is None:
            roi_mask = torch.ones(rois.shape[0], dtype=torch.bool, device=rois.device)
        roi_mask = roi_mask.bool()
        if len(features) == 1:
            out = roi_align(features[0].float(), rois, self.output_size, self.scales[0],
                            self.sampling_ratio).to(out_dtype)
            return torch.where(roi_mask[:, None, None, None], out, torch.zeros_like(out))
        levels = assign_fpn_levels(
            rois[:, 1:5], self.k_min, self.k_max,
            self.canonical_scale, self.canonical_level,
        ) - self.k_min
        # every backend pools the same samples: the reference takes the
        # plain multilevel formulation, rows of masked rois zero
        out = multilevel_roi_align(list(features), rois, levels, self.output_size,
                                   self.scales, self.sampling_ratio)
        return out * roi_mask.to(out.dtype)[:, None, None, None]
