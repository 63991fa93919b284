"""Feature Pyramid Network neck: P2..P6 (or the configured levels) from
[C2..C5].

Port of cpm_tpu/modeling/fpn.py: top-down nearest 2x upsampling plus 1x1
laterals, 3x3 output convs, and above C5 either P6 as the stride-2
subsample of P5, or under EXTRA_CONV_LEVELS a stride-2 3x3 conv a level
(from C5 under USE_C5, else from the last output; a relu before each one
after the first). A min level above LOWEST_BACKBONE_LVL drops the finest
backbone maps. Under USE_GN (or USE_BN, a frozen `AffineChannel`) every
conv's output is normed; the norms sit in one ModuleList in the JAX
package's call order (p5_in, p5_out, each level's lateral and output, the
extra levels), which is flax's auto-naming order, so the bridge maps
`GroupNorm_k` / `AffineChannel_k` to `norms.k`. USE_WS standardises every
conv (modeling/ws.py). NCHW tensors in channels_last memory.

The neck carries `dim_out`, the width of its levels, which the RPN and
RoI heads take. (The port's other necks are not copied: neither
configuration builds them.)
"""

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.modeling import initializers as init
from benchmark.reference.modeling.norm import make_norm
from benchmark.reference.modeling.ws import maybe_ws


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W] nearest neighbour."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _conv(cin, cout, k, g, stride=1):
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)
    init.fpn_conv(conv.weight, g)
    nn.init.zeros_(conv.bias)
    return conv


class FPN(nn.Module):
    """[C2..C5] -> [P_min..P_max] with `fpn_dim` channels."""

    def __init__(self, in_dims: Sequence[int], fpn_dim: int = 256,
                 generator: torch.Generator = None,
                 min_level: int = 2, max_level: int = 6, lowest_backbone_lvl: int = 2,
                 highest_backbone_lvl: int = 5, extra_conv_levels: bool = False,
                 use_c5: bool = True, norm: str = "none"):
        super().__init__()
        g = generator
        self.dim_out = fpn_dim
        n = len(in_dims) - (min_level - lowest_backbone_lvl) - 1
        self.p5_in = _conv(in_dims[-1], fpn_dim, 1, g)
        self.p5_out = _conv(fpn_dim, fpn_dim, 3, g)
        self.fpn_in = nn.ModuleList(_conv(in_dims[-i - 2], fpn_dim, 1, g) for i in range(n))
        self.fpn_out = nn.ModuleList(_conv(fpn_dim, fpn_dim, 3, g) for _ in range(n))
        self.extra_levels = []
        self.use_c5 = use_c5
        if extra_conv_levels and max_level > highest_backbone_lvl:
            for j, lvl in enumerate(range(highest_backbone_lvl + 1, max_level + 1)):
                cin = in_dims[-1] if j == 0 and use_c5 else fpn_dim
                self.add_module(f"extra_p{lvl}", _conv(cin, fpn_dim, 3, g, stride=2))
                self.extra_levels.append(f"extra_p{lvl}")
        self.with_p6 = not extra_conv_levels and max_level == highest_backbone_lvl + 1
        self.norms = None
        if norm != "none":
            self.norms = nn.ModuleList(
                make_norm(fpn_dim, norm) for _ in range(2 + 2 * n + len(self.extra_levels)))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        norms = iter(self.norms if self.norms is not None else ())

        def maybe_norm(h):
            return next(norms)(h) if self.norms is not None else h

        px = maybe_norm(self.p5_in(feats[-1]))
        outputs = [maybe_norm(self.p5_out(px))]
        for i, (lat_conv, out_conv) in enumerate(zip(self.fpn_in, self.fpn_out)):
            lateral = maybe_norm(lat_conv(feats[-i - 2]))
            if lateral.shape[-2:] != px.shape[-2:]:
                px = nearest_upsample_2x(px)
            px = lateral + px
            outputs.insert(0, maybe_norm(out_conv(px)))
        if self.with_p6:
            # P6 = stride-2 subsample of P5 (the kernel-1 "max pool")
            outputs.append(outputs[-1][:, :, ::2, ::2])
        for j, name in enumerate(self.extra_levels):
            p_in = F.relu(outputs[-1]) if j > 0 else (feats[-1] if self.use_c5 else outputs[-1])
            outputs.append(maybe_norm(getattr(self, name)(p_in)))
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
    min_level, max_level = get_min_max_levels(cfg)
    fpn = FPN(
        in_dims, fpn_dim=f.DIM, generator=generator, min_level=min_level, max_level=max_level,
        lowest_backbone_lvl=f.LOWEST_BACKBONE_LVL, highest_backbone_lvl=f.HIGHEST_BACKBONE_LVL,
        extra_conv_levels=f.EXTRA_CONV_LEVELS, use_c5=f.USE_C5,
        norm="gn" if f.USE_GN else ("bn" if f.USE_BN else "none"),
    )
    return maybe_ws(fpn, f.USE_WS)


