"""Feature Pyramid Network neck: P2..P6 from [C2..C5].

Port of cpm_tpu/modeling/fpn.py (no norm, no extra conv levels): top-down
nearest 2x upsampling plus 1x1 laterals, 3x3 output convs, and P6 as the
stride-2 subsample of P5. NCHW tensors in channels_last memory.
"""

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cpm_tpu_torch.modeling import initializers as init


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W] nearest neighbour."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _conv(cin, cout, k, g):
    conv = nn.Conv2d(cin, cout, k, padding=k // 2)
    init.kaiming_uniform_a1(conv.weight, g)
    nn.init.zeros_(conv.bias)
    return conv


class FPN(nn.Module):
    """[C2..C5] -> [P2..P6] with `fpn_dim` channels."""

    def __init__(self, in_dims: Sequence[int], fpn_dim: int = 256,
                 with_p6: bool = True, generator: torch.Generator = None):
        super().__init__()
        g = generator
        self.p5_in = _conv(in_dims[-1], fpn_dim, 1, g)
        self.p5_out = _conv(fpn_dim, fpn_dim, 3, g)
        n = len(in_dims) - 1
        self.fpn_in = nn.ModuleList(_conv(in_dims[-i - 2], fpn_dim, 1, g) for i in range(n))
        self.fpn_out = nn.ModuleList(_conv(fpn_dim, fpn_dim, 3, g) for _ in range(n))
        self.with_p6 = with_p6

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        px = self.p5_in(feats[-1])
        outputs = [self.p5_out(px)]
        for i, (lat_conv, out_conv) in enumerate(zip(self.fpn_in, self.fpn_out)):
            lateral = lat_conv(feats[-i - 2])
            if lateral.shape[-2:] != px.shape[-2:]:
                px = nearest_upsample_2x(px)
            px = lateral + px
            outputs.insert(0, out_conv(px))
        if self.with_p6:
            # P6 = stride-2 subsample of P5 (the kernel-1 "max pool")
            outputs.append(outputs[-1][:, :, ::2, ::2])
        return outputs


def get_min_max_levels(cfg):
    """The FPN's lowest and highest output level (FPN.py:124-139)."""
    min_level = cfg.FPN.LOWEST_BACKBONE_LVL
    max_level = cfg.FPN.HIGHEST_BACKBONE_LVL
    if cfg.FPN.MULTILEVEL_RPN and not cfg.FPN.MULTILEVEL_ROIS:
        max_level, min_level = cfg.FPN.RPN_MAX_LEVEL, cfg.FPN.RPN_MIN_LEVEL
    if not cfg.FPN.MULTILEVEL_RPN and cfg.FPN.MULTILEVEL_ROIS:
        max_level, min_level = cfg.FPN.ROI_MAX_LEVEL, cfg.FPN.ROI_MIN_LEVEL
    if cfg.FPN.MULTILEVEL_RPN and cfg.FPN.MULTILEVEL_ROIS:
        max_level = max(cfg.FPN.RPN_MAX_LEVEL, cfg.FPN.ROI_MAX_LEVEL)
        min_level = min(cfg.FPN.RPN_MIN_LEVEL, cfg.FPN.ROI_MIN_LEVEL)
    return min_level, max_level


def build_fpn(cfg, in_dims: Sequence[int], generator: torch.Generator) -> FPN:
    f = cfg.FPN
    if f.USE_GN or f.USE_BN or f.USE_WS or f.EXTRA_CONV_LEVELS or f.BODY != "fpn":
        raise NotImplementedError("the port runs the plain FPN body only")
    min_level, max_level = get_min_max_levels(cfg)
    if min_level != f.LOWEST_BACKBONE_LVL:
        raise NotImplementedError("FPN levels must start at the lowest backbone level")
    return FPN(
        in_dims, fpn_dim=f.DIM,
        with_p6=(max_level == f.HIGHEST_BACKBONE_LVL + 1), generator=generator,
    )
